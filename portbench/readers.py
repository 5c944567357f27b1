"""Shared arithmetic of the metric readers (portbench/metrics/*.py): a
role's kernels picked out of the trace by the patterns of
portbench/roles/<role>/*.json, and a role's roofline share."""

from __future__ import annotations

import json
import re
from pathlib import Path

from .costs.arith import ROLE_BOUNDS

ROLES = Path(__file__).resolve().parent / "roles"


def patterns(role: str) -> list:
    """[(match, exclude)] compiled regexes, one pair a file of the role."""
    out = []
    for f in sorted((ROLES / role).glob("*.json")):
        spec = json.loads(f.read_text())
        out.append((re.compile("|".join(spec["match"])),
                    re.compile("|".join(spec["exclude"])) if spec.get("exclude") else None))
    return out


def in_role(name: str, pats) -> bool:
    return any(m.search(name) and not (x and x.search(name)) for m, x in pats)


def role_seconds(trace: dict, role: str) -> float:
    pats = patterns(role)
    return sum(s for name, s in trace["kernels_s"].items() if in_role(name, pats))


def roofline(run, role: str):
    """Least time of the role's work over the traced steps, as a share (%) of
    the device time of the kernels that do it; None without a trace or
    without a matched kernel."""
    if run.trace is None:
        return None
    spent = role_seconds(run.trace, role)
    if spent <= 0:
        return None
    return 100.0 * ROLE_BOUNDS[role](run.dims, run.streams) * run.trace_steps / spent
