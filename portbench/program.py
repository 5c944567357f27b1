"""The port's own trace as the benchmark reads it: the spans, device-region
times and counters of `uvltrack_tpu_torch/utils/tracing.py`, recorded
inside the program (the harness's spans, profile.py::Spans, time each layer
from outside it).

A run that carries them has `record.program`: `export(tracer, window_ns)`,
the tracer's export with `window_ns`, the untraced window's time.time_ns()
bounds. Its steps are the `step` spans inside those bounds, and a span,
region time or count belongs to the window when its step id is one of
theirs. The profiled steps' device idle time by program span is
`idle_by_span(events, window_ns, spans)` (each idle interval's overlap with
the innermost span covering it, so a span's self time and its children's
count apart), carried as `record.trace["idle_in_program_s"]`. The readers
host.step_ms, host.stage_ms, host.replay_ms, device.idle_stage_ms,
model.crop_ms, model.backbone_ms, model.head_ms, remine.device_ms,
remine.due_share and setup.program_s read these, and read None on a run
without them, as on every run cell.py makes today (PERF.md §7: what the
harness needs to attach them).
"""

from __future__ import annotations

from collections import defaultdict

from .profile import union

NAME, START, END, ID, PARENT, STEP = range(6)  # tracing.SPAN_FIELDS
KIND, REGION, MS = range(3)                     # tracing.REGION_FIELDS (then step)


def export(tracing, window_ns) -> dict:
    """The port's tracer module's export, with the window's bounds."""
    return dict(tracing.export(), window_ns=[int(window_ns[0]), int(window_ns[1])])


def of(run):
    return getattr(run, "program", None)


def window_steps(p: dict) -> list:
    """The `step` spans of the untraced window."""
    w0, w1 = p["window_ns"]
    return [s for s in p["spans"] if s[NAME] == "step" and s[START] >= w0 and s[END] <= w1]


def per_step_ms(run, prefix: str):
    """Host ms a window step in the spans whose name starts with `prefix`."""
    p = of(run)
    if p is None:
        return None
    steps = window_steps(p)
    if not steps:
        return None
    ids = {s[ID] for s in steps}
    total = sum(s[END] - s[START] for s in p["spans"]
                if s[NAME].startswith(prefix) and s[STEP] in ids)
    return total / len(steps) / 1e6


def region_ms(run, kind: str, name: str):
    """Mean device ms of region `name` of a `kind` run ("step", "remine")
    in the window's steps."""
    p = of(run)
    if p is None:
        return None
    ids = {s[ID] for s in window_steps(p)}
    got = [r[MS] for r in p["regions"] if r[KIND] == kind and r[REGION] == name and r[3] in ids]
    return sum(got) / len(got) if got else None


def counted(run, name: str):
    """The sum of counter `name` over the window's steps."""
    p = of(run)
    if p is None:
        return None
    ids = {s[ID] for s in window_steps(p)}
    return sum(c[1] for c in p["counts"] if c[0] == name and c[2] in ids)


def setup_s(run):
    """Seconds of the union of the setup.* spans before the window."""
    p = of(run)
    if p is None:
        return None
    w0 = p["window_ns"][0]
    got = union((s[START], min(s[END], w0)) for s in p["spans"]
                if s[NAME].startswith("setup.") and s[START] < w0)
    return sum(b - a for a, b in got) / 1e9 if got else None


def innermost(spans) -> list:
    """[(name, start, end)]: the spans' union cut where the innermost span
    covering it changes (spans nest or are disjoint, as one thread's do)."""
    out, stack = [], []  # stack: [name, end, the end of what is emitted of it]

    def close_until(t):
        while stack and stack[-1][1] <= t:
            name, end, done = stack.pop()
            if end > done:
                out.append((name, done, end))
            if stack:
                stack[-1][2] = end

    for name, a, b in sorted(((s[NAME], s[START], s[END]) for s in spans),
                             key=lambda s: (s[1], -s[2])):
        close_until(a)
        if stack:
            top = stack[-1]
            if a > top[2]:
                out.append((top[0], top[2], a))
            top[2] = a
        stack.append([name, b, a])
    close_until(float("inf"))
    return sorted(out, key=lambda s: s[1])


def idle_by_span(events, window_ns, spans) -> dict:
    """{span name: seconds}: the device's idle time within the window (no
    event's interval covers it) that each program span covers innermost."""
    w0, w1 = window_ns
    busy = union((max(a, w0), min(b, w1)) for _, a, b in events if b > w0 and a < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out = defaultdict(float)
    i = 0
    for name, a, b in innermost(s for s in spans if s[END] > w0 and s[START] < w1):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            out[name] += (min(b, idle[j][1]) - max(a, idle[j][0])) / 1e9
            j += 1
    return dict(out)
