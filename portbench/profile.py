"""A profiled stretch of steps: torch.profiler's CUDA activity (kernels,
copies, memsets; the host's operators are not traced) reduced to the
device's busy time as the union of its event intervals, so a copy that
overlaps a kernel counts once; the device time of each kernel name; and the
idle gaps between busy intervals, summed by the harness span the host was
in at each gap's middle (spans on time.time_ns(), the profiler's clock).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


class Spans:
    """The harness's host spans, (name, start_ns, end_ns), kept in memory."""

    def __init__(self):
        self.starts, self.items = [], []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        """Spans are added in time order and do not overlap."""
        self.starts.append(start_ns)
        self.items.append((name, end_ns))

    def at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        if i >= 0 and t_ns < self.items[i][1]:
            return self.items[i][0]
        return "outside the harness's spans"


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def device_events(prof):
    """[(name, start_ns, end_ns)] of the device's events in a finished
    profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def summarize(events, window_ns, spans: Spans, top: int = 10) -> dict:
    """busy_s (the union of every event's interval: the profiler records only
    while it runs, and the device is idle when it starts), per-name device
    seconds, and the idle time within the host's window summed by the host's
    span it fell in. `skew_ns`: how far the events reach outside the host's
    window (both near 0 when the clocks agree)."""
    w0, w1 = window_ns
    busy = union((a, b) for _, a, b in events)
    by_name = defaultdict(float)
    for name, a, b in events:
        by_name[name] += (b - a) / 1e9
    inside = union((max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1)
    edges = [w0] + [x for iv in inside for x in iv] + [w1]
    gaps = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[spans.at((a + b) // 2)] += (b - a) / 1e9
    return {"busy_s": sum(b - a for a, b in busy) / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels_s": dict(by_name), "events": len(events),
            "skew_ns": [w0 - busy[0][0], busy[-1][1] - w1] if busy else None,
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


class Window:
    """torch.profiler's CUDA activity over a with-block; `.summary` after it
    (the device synchronized at both ends)."""

    def __init__(self, spans: Spans, sync):
        self.spans, self.sync, self.summary = spans, sync, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sync()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.sync()
        t1 = time.time_ns()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(device_events(self.prof), (self.t0, t1), self.spans)
        return False
