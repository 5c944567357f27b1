"""Lightweight attribute-dict config tree with strict YAML merge (the PyTorch
port's own copy of uvltrack_tpu/config/cfgnode.py, without the command-line
overrides and the YAML dump that no part of the port uses yet).

Matches the semantics of the reference config system
(lib/config/uvltrack/config.py:169-187): overriding a key that does not exist
in the defaults raises, scalars replace, nested dicts merge recursively.
"""

from __future__ import annotations

from typing import Any, Dict

import yaml


def _coerce_leaf(value: Any, old: Any, key: str) -> Any:
    """Type-guard an override against the default leaf's type.

    Follows the reference's vendored-yacs semantics
    (_check_and_coerce_cfg_value_type): same type passes, int widens to
    float, numeric strings coerce to the target numeric type (pyyaml
    parses `1e-4` as str), everything else is a hard error. None on either
    side passes: `KEY=` deliberately clears, and an untyped default
    accepts anything."""
    if old is None or value is None or type(value) is type(old):
        return value
    # bool is an int subclass — guard it before the numeric coercions so
    # `FLAG=1` can't silently flip a bool leaf (and `LR=true` can't become
    # 1.0)
    if isinstance(old, bool) or isinstance(value, bool):
        raise ValueError(
            f"{key}: cannot override {type(old).__name__} leaf with "
            f"{value!r} ({type(value).__name__})")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (int, float)) and isinstance(value, str):
        try:
            num = float(value)
        except ValueError:
            raise ValueError(
                f"{key}: cannot coerce {value!r} to "
                f"{type(old).__name__}") from None
        if isinstance(old, float):
            return num
        if num.is_integer():
            return int(num)
        raise ValueError(f"{key}: cannot coerce {value!r} to int")
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    raise ValueError(
        f"{key}: override type {type(value).__name__} does not match "
        f"default leaf type {type(old).__name__} (value {value!r})")


class CfgNode(dict):
    """dict subclass with attribute access. Values that are dicts are wrapped."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        super().__setitem__(key, value)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                v = v.clone()
            elif isinstance(v, list):
                # list values (MILESTONES, FUSION_LAYER, DATASETS_NAME...)
                # must not be shared — in-place tweaks on a clone would
                # corrupt the base config of a sibling run
                v = list(v)
            out[k] = v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()}

    def merge_from_dict(self, other: Dict[str, Any], _path: str = "") -> None:
        """Strict recursive merge: unknown keys raise ValueError."""
        for k, v in other.items():
            here = f"{_path}.{k}" if _path else k
            if k not in self:
                raise ValueError(f"{here} not exist in default config")
            if isinstance(v, dict):
                if not isinstance(self[k], CfgNode):
                    # defaults hold a scalar/None but override provides a dict
                    raise ValueError(f"{here}: cannot merge dict into non-dict")
                self[k].merge_from_dict(v, here)
            else:
                # a YAML leaf may not silently install a wrong-typed value
                # (yacs _check_and_coerce semantics)
                super(CfgNode, self).__setitem__(
                    k, _coerce_leaf(v, self[k], here))

    def merge_from_file(self, filename: str) -> None:
        with open(filename) as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_dict(data)
