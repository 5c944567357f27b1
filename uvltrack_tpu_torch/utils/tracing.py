"""The port's tracer: host spans, device-region timers and counters of the
tracking step and its set-up, kept in memory while on.

    from uvltrack_tpu_torch.utils import tracing
    tracing.start()          # off by default; no environment variable
    ...                      # build, initialize, step
    record = tracing.export()
    tracing.stop()

Off, every site costs one check of the module's recorder (`_rec is None`):
nothing is allocated or recorded, and the CUDA graphs are the untraced
graphs (track/tracker.py::graph_knobs keys them by `active()`, so a graph
captured while the tracer is on is a graph of its own).

Spans. A span is (name, start_ns, end_ns, id, parent, step): stamped on
time.time_ns() (the clock torch.profiler's CUDA trace agrees with), its
parent the span open on the same thread when it started (0 at the top), and
its step the id of the `step` span around it (a `step` span's own id; 0
outside a step), so one step's spans share an id. Sites: `step`
(LockstepTracker._graph_step and _eager_step; its self time is the state
loads and clones), `stage.wait`,
`stage.fill`, `stage.copy` (utils/pinned.py: the buffer's event wait, the
host fill, the non-blocking host-to-device enqueue), `replay.step`,
`replay.remine` (the graph launches), and the set-up: `setup.kernels`
(ops/build.py::library, one library's build or load), `setup.prepare`
(prepare_inference_model), `setup.initialize` (Tracker and BatchTracker
initialize) and `setup.capture` (JitTracker._captured: warm-up and capture).
The tracer's own reads of the region times are the span `trace.read`, so a
step's self time stays the state loads and clones.

Device regions. `regions(kind, device)`, opened by the step around a body,
collects the body's `mark(name)`s; a mark starts the region `name` and ends
the one before it (the last mark, "end", only ends). Marks: "crop" at the
start of step_body, "backbone" after the crop, "head" between the backbone
and the box head (models/uvltrack.py), "end"; "remine" and "end" around
remine_body. Outside a region context a mark records nothing (a training
forward, the prompt init). On a CUDA device a mark records a timing event
on the current stream; under stream capture (`graph=True`) it becomes an
event-record node that every replay of the graph records again, and the
capture's warm-up runs record nothing. A run's region times (ms between
consecutive marks) are read lazily, after a synchronize on its last event:
before the graph's next replay, before the next eager body, or at export.
On the CPU a mark stamps the host clock (the ops ran when it returns).

Counters: `count(name, n)` with the current step's id: `remine.rows_computed`
(S for each re-mine replay or eager re-mine body) and `remine.rows_due` (the
host's due mask over the same calls).

Memory: at most CAPACITY spans, as many region times and as many counts
are kept (1 << 17: a 20 s window of the single-stream step at ~200 steps/s
records ~11 spans a step); what does not fit is counted in `dropped`. export() returns them with ops/build.py's counters as they stand
(launches, captured calls, bodies, fallbacks, nvcc seconds): read there, not copied.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Optional

import torch

CAPACITY = 1 << 17
SPAN_FIELDS = ("name", "start_ns", "end_ns", "id", "parent", "step")
REGION_FIELDS = ("kind", "name", "ms", "step")
COUNT_FIELDS = ("name", "n", "step")


class Regions:
    """The marks of one body: of one eager run, or of one capture
    (graph=True), which every replay of the graph records again. `step`
    holds the step of the run not read yet (None when read)."""

    def __init__(self, kind: str, device: torch.device, graph: bool):
        self.kind, self.graph, self.cuda = kind, graph, device.type == "cuda"
        self.device = device
        self.marks = []  # [(name, CUDA event or host ns)]
        self.step: Optional[int] = None


class Recorder:
    """What one start() records, until the next start()."""

    def __init__(self):
        self.spans, self.regions, self.counts = [], [], []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.unread = []  # Regions with a run not read yet

    def tls(self):
        t = self.local
        if not hasattr(t, "stack"):
            t.stack, t.step, t.regions = [], 0, None
        return t

    def keep(self, rows: list, row) -> None:
        if len(rows) < CAPACITY:
            rows.append(row)
        else:
            self.dropped += 1

    def read(self, reg: Regions) -> None:
        """The region times of reg's last run, appended under its step; the
        read is the span trace.read."""
        step, marks = reg.step, reg.marks
        if step is None:
            return
        reg.step = None
        if reg in self.unread:
            self.unread.remove(reg)
        with _Span(self, "trace.read", False):
            if reg.cuda:
                marks[-1][1].synchronize()
                times = [a.elapsed_time(b) for (_, a), (_, b) in zip(marks, marks[1:])]
            else:
                times = [(b - a) / 1e6 for (_, a), (_, b) in zip(marks, marks[1:])]
        for (name, _), ms in zip(marks, times):
            self.keep(self.regions, (reg.kind, name, ms, step))

    def ran(self, reg: Regions) -> None:
        """reg ran once more (an eager body ended, or its graph replayed)."""
        reg.step = self.tls().step
        if reg not in self.unread:
            self.unread.append(reg)


_rec: Optional[Recorder] = None   # recording while not None
_last: Optional[Recorder] = None  # what export() reads after stop()


def active() -> bool:
    return _rec is not None


def start() -> None:
    """Record from now on, into a new buffer."""
    global _rec, _last
    _rec = _last = Recorder()


def stop() -> None:
    """Record nothing more; export() still reads what was recorded."""
    global _rec
    _rec = None


def export() -> dict:
    """What the last start() recorded so far, and ops/build.py's counters:
    {"spans": [SPAN_FIELDS...], "regions": [REGION_FIELDS...], "counts":
    [COUNT_FIELDS...], "dropped", "build"}. Reads the region
    times still unread (a synchronize on each one's last event)."""
    from ..ops import build

    rec = _last
    if rec is None:
        spans, regions, counts, dropped = [], [], [], 0
    else:
        for reg in list(rec.unread):
            rec.read(reg)
        spans, regions, counts = list(rec.spans), list(rec.regions), list(rec.counts)
        dropped = rec.dropped
    return {"spans": spans, "regions": regions, "counts": counts, "dropped": dropped,
            "build": {"launches": build.instantiation_counts(),
                      "captured": build.captured_counts(), "bodies": build.body_counts(),
                      "fallbacks": build.fallback_counts(),
                      "nvcc_s": {n: r.seconds for n, r in build.RECORDS.items()
                                 if not r.cached}}}


# ------------------------------------------------------------------- spans
class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "name", "is_step", "t0", "id", "parent", "outer_step")

    def __init__(self, rec: Recorder, name: str, is_step: bool):
        self.rec, self.name, self.is_step = rec, name, is_step

    def __enter__(self):
        rec = self.rec
        t = rec.tls()
        self.parent = t.stack[-1] if t.stack else 0
        self.id = next(rec.ids)
        t.stack.append(self.id)
        if self.is_step:
            self.outer_step, t.step = t.step, self.id
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        t = rec.tls()
        t.stack.pop()
        rec.keep(rec.spans, (self.name, self.t0, t1, self.id, self.parent, t.step))
        if self.is_step:
            t.step = self.outer_step
        return False


def span(name: str):
    """A with-block recorded as the span `name` (a no-op while off)."""
    return _NULL if _rec is None else _Span(_rec, name, False)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`; a `step`
    span opens a step (the spans, region times and counts inside it take
    its id)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = _rec
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name, name == "step"):
                return fn(*args, **kwargs)
        return inner
    return wrap


def add(name: str, start_ns: int, end_ns: int) -> None:
    """A span timed by the caller (on time.time_ns()), a child of the span
    open now."""
    rec = _rec
    if rec is None:
        return
    t = rec.tls()
    rec.keep(rec.spans, (name, start_ns, end_ns, next(rec.ids),
                         t.stack[-1] if t.stack else 0, t.step))


def count(name: str, n: int) -> None:
    rec = _rec
    if rec is not None:
        rec.keep(rec.counts, (name, int(n), rec.tls().step))


# ----------------------------------------------------------- device regions
class _Open:
    __slots__ = ("rec", "reg", "outer")

    def __init__(self, rec: Recorder, reg: Regions):
        self.rec, self.reg = rec, reg

    def __enter__(self):
        t = self.rec.tls()
        if not self.reg.graph:  # the last eager runs' times, before new marks
            for reg in [r for r in self.rec.unread if not r.graph]:
                self.rec.read(reg)
        self.outer, t.regions = t.regions, self.reg
        return self.reg

    def __exit__(self, *exc):
        self.rec.tls().regions = self.outer
        if not self.reg.graph and exc[0] is None and self.reg.marks:
            self.rec.ran(self.reg)
        return False


def regions(kind: str, device: torch.device, graph: bool = False):
    """A with-block whose marks time the regions of one body of `kind`
    ("step", "remine"); graph=True around a CUDA graph's warm-up and
    capture, whose Regions the graph's owner passes to replay(). Yields the
    Regions, or None while off."""
    return _NULL if _rec is None else _Open(_rec, Regions(kind, device, graph))


def mark(name: str) -> None:
    """Start the device region `name` (see the module's docstring)."""
    rec = _rec
    if rec is None:
        return
    reg = rec.tls().regions
    if reg is None:
        return
    if reg.cuda:
        if reg.graph and not torch.cuda.is_current_stream_capturing():
            return  # a capture's warm-up
        ev = torch.cuda.Event(enable_timing=True, external=reg.graph)
        ev.record(torch.cuda.current_stream(reg.device))
        reg.marks.append((name, ev))
    elif not reg.graph:
        reg.marks.append((name, time.perf_counter_ns()))


def replay(name: str, reg: Optional[Regions], fn) -> None:
    """fn(), a CUDA graph's replay, as the span `name`; reg, the Regions
    its capture recorded (None if captured while off), has the previous
    replay's times read first."""
    rec = _rec
    if rec is None:
        fn()
        return
    if reg is not None:
        rec.read(reg)
    with _Span(rec, name, False):
        fn()
    if reg is not None and reg.marks:
        rec.ran(reg)
