"""Evaluation environment paths (a copy of uvltrack_tpu/eval/environment.py:
framework-free, so the port keeps its own).

Replaces the reference's generated local.py modules
(lib/test/evaluation/environment.py:108-119) with a plain YAML file
(<repo>/local_paths.yaml) plus environment-variable overrides
(UVLTRACK_<NAME>_PATH). Missing paths only error when actually used.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field, fields

import yaml

_PATH_KEYS = [
    "results_path", "result_plot_path", "checkpoints_path", "network_path",
    "otb99_path", "tnl2k_path", "tnl2k_test_path", "lasot_path",
    "lasotext_path", "got10k_path",
    "trackingnet_path", "nfs_path", "uav_path", "itb_path", "avist_path",
    "tc128_path", "otb_path", "pretrained_path", "imagenet_path",
    "lasot_lmdb_path", "got10k_lmdb_path", "trackingnet_lmdb_path",
    "imagenet_lmdb_path", "coco_lmdb_path", "object365_path",
    "visualgenome_path", "webuav_path",
]


@dataclass
class EnvSettings:
    repo_dir: str = ""
    results_path: str = ""
    result_plot_path: str = ""
    checkpoints_path: str = ""
    network_path: str = ""
    otb99_path: str = ""
    tnl2k_path: str = ""
    tnl2k_test_path: str = ""
    lasot_path: str = ""
    lasotext_path: str = ""
    got10k_path: str = ""
    trackingnet_path: str = ""
    nfs_path: str = ""
    uav_path: str = ""
    itb_path: str = ""
    avist_path: str = ""
    tc128_path: str = ""
    otb_path: str = ""
    coco_path: str = ""
    pretrained_path: str = ""
    imagenet_path: str = ""
    lasot_lmdb_path: str = ""
    got10k_lmdb_path: str = ""
    trackingnet_lmdb_path: str = ""
    imagenet_lmdb_path: str = ""
    coco_lmdb_path: str = ""
    object365_path: str = ""
    visualgenome_path: str = ""
    webuav_path: str = ""


_CACHED: EnvSettings | None = None
_WARNED_KEYS: set[str] = set()  # unknown local_paths.yaml keys already warned


def env_settings(repo_dir: str | None = None) -> EnvSettings:
    global _CACHED
    if _CACHED is not None and repo_dir is None:
        return _CACHED
    repo = repo_dir or os.environ.get(
        "UVLTRACK_REPO", os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    s = EnvSettings(repo_dir=repo)
    s.results_path = os.path.join(repo, "output", "test", "tracking_results")
    s.result_plot_path = os.path.join(repo, "output", "test", "result_plots")
    s.checkpoints_path = os.path.join(repo, "checkpoints")
    s.network_path = os.path.join(repo, "output", "networks")
    s.pretrained_path = os.path.join(repo, "pretrain")

    yaml_path = os.path.join(repo, "local_paths.yaml")
    if os.path.exists(yaml_path):
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        for k, v in data.items():
            if hasattr(s, k):
                setattr(s, k, v)
            elif k not in _WARNED_KEYS:
                # a typo'd root (e.g. DATA_DIR) silently pointing nowhere
                # costs an eval run; say so ONCE per process — env_settings()
                # runs dozens of times per eval (cli/test + every dataset
                # accessor), and repeating it would flood the run log
                _WARNED_KEYS.add(k)
                print(f"local_paths.yaml: unknown key {k!r} ignored "
                      f"(valid keys are EnvSettings fields, e.g. "
                      f"tnl2k_path)", file=sys.stderr)
    for f_ in fields(s):
        env_key = f"UVLTRACK_{f_.name.upper()}"
        if env_key in os.environ:
            setattr(s, f_.name, os.environ[env_key])
    if repo_dir is None:
        _CACHED = s
    return s


def reset_env_cache():
    global _CACHED
    _CACHED = None
    # re-reading local_paths.yaml should re-warn about keys that are STILL
    # unknown — the user edits the file and resets exactly to re-check it
    _WARNED_KEYS.clear()


def experiment_cfg_path(settings: EnvSettings, script: str, config: str) -> str:
    """<repo>/experiments/<script>/<config>.yaml — the one layout every CLI
    shares (keep cli/train, cli/test, analyze, profile, demo, pack, parity
    and scripts/export_torch in lockstep)."""
    return os.path.join(settings.repo_dir, "experiments", script,
                        f"{config}.yaml")


def resolve_path(settings: EnvSettings, p: str) -> str:
    """Resolve a config-relative path (e.g. the default
    'pretrained/bert/...vocab.txt') against repo_dir then pretrained_path —
    bare os.path.exists would silently depend on the CWD. Returns the first
    existing candidate, else the repo_dir-joined path (so error messages
    name a sensible location)."""
    if not p:
        return ""
    if os.path.isabs(p):
        return p
    for base in (settings.repo_dir, settings.pretrained_path):
        cand = os.path.join(base, p)
        if os.path.exists(cand):
            return cand
    return os.path.join(settings.repo_dir, p)


def train_checkpoint_dir(settings: EnvSettings, script: str, config: str) -> str:
    """<repo>/checkpoints/train/<script>/<config> — where cli/train saves and
    cli/test --test_checkpoint-less runs and export_torch look."""
    return os.path.join(settings.repo_dir, "checkpoints", "train", script,
                        config)
