"""uvltrack_tpu_torch/utils/tracing.py, the port's tracer, and the
benchmark's readers of what it records (portbench/program.py and the
portbench/metrics/ readers of the spans, regions and counters).

On the CPU: off, nothing is recorded and the graph key keeps its untraced
value; on, a step's spans nest under its `step` span and share its id (the
graph path with the stand-in capture, whose PinnedStage takes its CPU
path, and the eager step with its host-clock regions); the re-mine's due
rows over its computed rows on a staggered S=4 eager run; the readers on a
record without the program's trace and on a synthetic one; the idle time
by innermost span; and a tiny benchmark run with the tracer on, through
portbench/traced.py.

The `gpu` cases run UVLTrack-B's graphs on the card (`python -m pytest
tests/test_torch_port_tracing.py -m gpu --noconftest`): boxes bitwise equal
with the tracer on and off at S=1 and S=8; the H2D copy after its
stage.copy span starts and a replay's first kernel after its replay span
starts, on the one clock; the regions' sum of each replay within 5% of the
time between events recorded around its launch (the device held busy
while the host launches it), and the profiled replays' busy union under
it and not far under it.
"""

import pathlib
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import cell as run_cell
from portbench import program, traced
from portbench.profile import union
from portbench.spec import reader
from portbench.tests.helpers import tiny_cell, tiny_port
from uvltrack_tpu_torch.track.batch import BatchTracker
from uvltrack_tpu_torch.track.tracker import JitTracker, graph_knobs
from uvltrack_tpu_torch.utils import tracing
from uvltrack_tpu_torch.utils.pinned import PinnedStage

REPO = pathlib.Path(__file__).resolve().parent.parent
NEW_METRICS = ("host.step_ms", "host.stage_ms", "host.replay_ms", "device.idle_stage_ms",
               "model.crop_ms", "model.backbone_ms", "model.head_ms", "remine.device_ms",
               "remine.due_share", "setup.program_s")


@pytest.fixture
def tracer():
    """The tracer started for the test and stopped after it."""
    tracing.start()
    try:
        yield tracing
    finally:
        tracing.stop()


@pytest.fixture
def tiny(monkeypatch):
    """The tiny configuration of portbench's CPU tests (C=64, 4 blocks,
    32/64 px crops, a re-mine every 4 frames, threshold 0) and its model."""
    from uvltrack_tpu_torch.models.uvltrack import build_model

    tiny_port(monkeypatch)
    cfg = run_cell.port_cfg(tiny_cell(), "sound")
    return cfg, build_model(cfg, device="cpu", seed=1)


def _frames(seed, S, h=96, w=160):
    return np.random.default_rng(seed).integers(0, 255, size=(S, h, w, 3), dtype=np.uint8)


def _tracker(tiny, S, graphs):
    cfg, model = tiny
    bt = BatchTracker(cfg, model, S)
    bt.graphs = graphs
    boxes = np.array([[40, 30, 24, 16], [80, 40, 20, 20], [20, 50, 30, 20], [100, 20, 16, 24]],
                     np.float32)[:S]
    bt.initialize(_frames(0, S), boxes)
    return bt


def _stagger(bt, steps):
    """Stream i runs i steps alone first (S offsets apart mod the re-mine
    interval of 4), then every stream runs `steps` steps."""
    S = bt.S
    for k in range(S - 1):
        bt.set_active(np.array([k < S - 1 - i for i in range(S)]))
        bt.step(_frames(1 + k, S))
    bt.set_active(np.ones(S, bool))
    for k in range(steps):
        bt.step(_frames(10 + k, S))


def _by_id(spans):
    return {s[3]: s for s in spans}


# ------------------------------------------------------------- on the CPU
def test_off_records_nothing_and_keeps_the_graph_key(tiny, tracer):
    """Stopped, the tracer records nothing more, and a graph key is the
    untraced one; on, the key is another (its own graphs)."""
    jt = JitTracker(tiny[0], tiny[1])
    on_key = jt.graph_key((96, 160), 3)
    tracing.stop()
    before = tracing.export()
    bt = _tracker(tiny, 3, graphs=True)
    _stagger(bt, 3)
    after = tracing.export()
    for k in ("spans", "regions", "counts"):
        assert after[k] == before[k]
    assert not tracing.active() and graph_knobs()[-1] is False
    assert jt.graph_key((96, 160), 3) != on_key
    assert [k[2][-1] for k in bt.jt.keys()] == [False]


def test_graph_path_spans_nest_under_their_step(tiny, tracer):
    """The graph path (stand-in capture; PinnedStage's CPU path): each
    step span holds two stage.fill spans (frames, masks) and replay.step,
    and replay.remine on re-mine steps, all its children with its id; the
    set-up spans come before the first step."""
    bt = _tracker(tiny, 3, graphs=True)
    _stagger(bt, 6)
    spans = tracing.export()["spans"]
    ids = _by_id(spans)
    steps = [s for s in spans if s[0] == "step"]
    assert len(steps) == 2 + 6
    for st in steps:
        assert st[5] == st[3] and st[4] == 0
        kids = Counter(s[0] for s in spans if s[4] == st[3])
        assert kids["stage.fill"] == 2 and kids["replay.step"] == 1
        assert set(kids) <= {"stage.fill", "replay.step", "replay.remine", "setup.capture"}
    for s in spans:
        if s[4]:
            parent = ids[s[4]]
            assert parent[1] <= s[1] <= s[2] <= parent[2] and s[5] == parent[5]
    names = Counter(s[0] for s in spans)
    assert names["setup.initialize"] == 1 and names["setup.prepare"] == 1
    assert names["setup.capture"] == 2  # the step graph and the re-mine graph
    assert names["replay.remine"] >= 1
    stage = PinnedStage()
    out = torch.empty((2, 3), dtype=torch.uint8)
    stage.upload(np.ones((2, 3), np.uint8), out)
    assert tracing.export()["spans"][-1][0] == "stage.fill" and int(out.sum()) == 6


def test_eager_step_regions_and_counts_share_the_step_id(tiny, tracer):
    """The eager step on the CPU: its regions (crop, backbone, head; the
    re-mine's on re-mine steps), stamped on the host clock, and its counts
    carry the id of the step span they ran in."""
    bt = _tracker(tiny, 4, graphs=False)
    _stagger(bt, 8)
    rec = tracing.export()
    step_ids = [s[3] for s in rec["spans"] if s[0] == "step"]
    assert len(step_ids) == 3 + 8
    by_step = {}
    for kind, name, ms, step in rec["regions"]:
        assert ms >= 0
        by_step.setdefault(step, []).append((kind, name))
    assert sorted(by_step) == step_ids
    for step in step_ids:
        assert by_step[step][:3] == [("step", "crop"), ("step", "backbone"), ("step", "head")]
        assert by_step[step][3:] in ([], [("remine", "remine")])
    remined = {s for s, got in by_step.items() if len(got) == 4}
    assert remined and {c[2] for c in rec["counts"]} == remined


def test_remine_due_share_is_one_in_S_when_staggered(tiny, tracer):
    """Staggered S=4 streams with a re-mine every 4 frames: each re-mine
    computes 4 rows for one due row."""
    bt = _tracker(tiny, 4, graphs=False)
    _stagger(bt, 12)
    counts = tracing.export()["counts"]
    computed = [n for name, n, _ in counts if name == "remine.rows_computed"]
    due = [n for name, n, _ in counts if name == "remine.rows_due"]
    assert computed and set(computed) == {4} and set(due) == {1}


def _synthetic():
    """A run with the program's trace: set-up spans (a union of 700 ns),
    two window steps (ids 10 and 20) and a profiled one (30), their
    regions and counts, and the profiled idle time by span."""
    spans = [("setup.initialize", 100, 600, 1, 0, 0), ("setup.kernels", 200, 400, 2, 1, 0),
             ("setup.capture", 700, 900, 3, 0, 0),
             ("step", 1000, 2000, 10, 0, 10), ("stage.wait", 1000, 1100, 11, 10, 10),
             ("stage.fill", 1100, 1500, 12, 10, 10), ("stage.copy", 1500, 1600, 13, 10, 10),
             ("replay.step", 1700, 1900, 14, 10, 10),
             ("step", 3000, 3600, 20, 0, 20), ("stage.fill", 3000, 3200, 21, 20, 20),
             ("replay.step", 3300, 3400, 22, 20, 20), ("replay.remine", 3400, 3500, 23, 20, 20),
             ("step", 6000, 7000, 30, 0, 30), ("stage.fill", 6000, 6500, 31, 30, 30)]
    regions = [("step", "crop", 0.1, 10), ("step", "backbone", 2.0, 10), ("step", "head", 0.5, 10),
               ("step", "crop", 0.3, 20), ("step", "backbone", 4.0, 20), ("step", "head", 0.7, 20),
               ("remine", "remine", 1.5, 20), ("step", "crop", 9.0, 30)]
    counts = [("remine.rows_computed", 8, 20), ("remine.rows_due", 1, 20),
              ("remine.rows_computed", 8, 30), ("remine.rows_due", 8, 30)]
    p = {"spans": spans, "regions": regions, "counts": counts, "dropped": 0,
         "window_ns": [1000, 5000]}
    trace = {"busy_s": 1.0, "idle_in_program_s": {"stage.fill": 0.002, "stage.wait": 0.001,
                                                   "step": 0.005}}
    return SimpleNamespace(program=p, trace=trace, trace_steps=3)


SYNTHETIC = {"host.step_ms": 800e-6, "host.stage_ms": 400e-6, "host.replay_ms": 200e-6,
             "device.idle_stage_ms": 1.0, "model.crop_ms": 0.2, "model.backbone_ms": 3.0,
             "model.head_ms": 0.6, "remine.device_ms": 1.5, "remine.due_share": 12.5,
             "setup.program_s": 700e-9}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader(name):
    """Each reader: None on a run without the program's trace (a port with
    no tracer), its number on the synthetic one."""
    bare = SimpleNamespace(trace={"busy_s": 1.0, "kernels_s": {}}, trace_steps=60, steps=10)
    assert reader(name)(bare) is None
    assert reader(name)(_synthetic()) == pytest.approx(SYNTHETIC[name])


def test_traced_ratios_on_the_synthetic_run():
    """traced.ratios, PERF.md's relations, on the synthetic run: staging
    and replays over the step span, the step span over the enqueue span,
    the regions (the re-mine at 1 replay in 2 window steps) over the busy
    time a profiled step, the staging's idle over the idle a profiled
    step."""
    run = _synthetic()
    run.enq_s = [1e-6, 1e-6]
    run.trace["window_s"] = 1.6
    got = traced.ratios(run)
    assert got == pytest.approx({"stage_replay_over_step": 0.75, "step_over_enqueue": 0.8,
                                 "regions_over_device": (0.2 + 3.0 + 0.6 + 0.75) / (1e3 / 3),
                                 "idle_stage_over_idle": 1.0 / 200.0})


def test_idle_by_innermost_span():
    """Idle time in the window by the innermost span over it: a parent's
    self time apart from its children's; overlap, not the gap's middle."""
    spans = [("step", 0, 100, 1, 0, 1), ("stage.fill", 10, 30, 2, 1, 1),
             ("stage.copy", 30, 40, 3, 1, 1), ("replay.step", 50, 60, 4, 1, 1),
             ("step", 120, 150, 5, 0, 5)]
    assert program.innermost(spans) == [
        ("step", 0, 10), ("stage.fill", 10, 30), ("stage.copy", 30, 40), ("step", 40, 50),
        ("replay.step", 50, 60), ("step", 60, 100), ("step", 120, 150)]
    idle = program.idle_by_span([("k", 35, 55), ("copy", 140, 160)], (5, 200), spans)
    assert idle == pytest.approx({"step": 65e-9, "stage.fill": 20e-9, "stage.copy": 5e-9,
                                  "replay.step": 5e-9})


def test_tiny_benchmark_run_with_the_tracer(monkeypatch):
    """portbench's tiny lockstep cell through portbench/traced.py (the
    tracer on from before the port is built, the untraced window's bounds
    stamped where the run draws its reservoir): every host reader reads a
    number, the step span inside the harness's enqueue span, the staging
    and replays inside the step, 1 due row in 3 (staggered S=3), and the
    program's set-up inside the run's."""
    tiny_port(monkeypatch)
    out = traced.traced_run(tiny_cell("tiny-S3"), 5, 0.5, False, torch.device("cpu"),
                            time.perf_counter(), force_graphs=True)
    assert not tracing.active()
    rec = out["record"]
    got = {m: reader(m)(rec) for m in NEW_METRICS}
    assert len(program.window_steps(rec.program)) == rec.steps
    assert got["host.stage_ms"] + got["host.replay_ms"] <= got["host.step_ms"]
    assert got["host.step_ms"] <= reader("host.enqueue_ms")(rec)
    assert got["remine.due_share"] == pytest.approx(100 / 3)
    assert 0 < got["setup.program_s"] < rec.setup_s
    # the stand-in capture records no regions; no profile without --trace 1
    for m in ("model.crop_ms", "model.backbone_ms", "model.head_ms", "remine.device_ms",
              "device.idle_stage_ms"):
        assert got[m] is None


def test_attached_summary_gives_the_idle_by_program_span(tracer):
    """traced.attached: the profile's summary gains the idle time by
    innermost program span, the window's end is stamped at the profile's
    start, and profile.summarize is itself again after the block."""
    from portbench import profile

    before = profile.summarize
    with tracing.span("step"):
        time.sleep(0.001)
        with tracing.span("stage.fill"):
            time.sleep(0.001)
        time.sleep(0.001)
    spans = {s[0]: s for s in tracing.export()["spans"]}
    step, fill = spans["step"], spans["stage.fill"]
    with traced.attached(tracing) as bounds:
        got = profile.summarize([("k", fill[2], step[2])], (step[1], step[2]), profile.Spans())
    assert profile.summarize is before and bounds["w1"] == step[1]
    assert got["idle_in_program_s"] == pytest.approx(
        {"step": (fill[1] - step[1]) / 1e9, "stage.fill": (fill[2] - fill[1]) / 1e9})


# ------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def card_model():
    """UVLTrack-B (baseline_base.yaml) on the card, seeded random weights,
    re-mines every 2 frames (the score gate opened)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    cfg = load_cfg(str(REPO / "experiments/uvltrack/baseline_base.yaml"))
    cfg.TEST.THRESHOLD, cfg.TEST.UPDATE_INTERVAL, cfg.TEST.MODE = -1.0, 2, "BBOX"
    return cfg, prepare_inference_model(cfg, build_model(cfg, device="cuda", seed=0))


def _card_boxes(S):
    rng = np.random.default_rng(S)
    xy = rng.uniform(100, 600, size=(S, 2))
    return np.concatenate([xy, rng.uniform(60, 120, size=(S, 2))], 1).astype(np.float32)


def _card_run(cfg, model, S, steps, on_step=None):
    bt = BatchTracker(cfg, None, S, jit_tracker=JitTracker(cfg, model))
    bt.initialize(_frames(1, S, 480, 854), _card_boxes(S))
    out = []
    for t in range(steps):
        if on_step is not None:
            on_step(t)
        out.append(bt.step(_frames(2 + t, S, 480, 854)))
    return np.stack(out)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8])
def test_cuda_tracer_keeps_the_boxes(card_model, S):
    """The graphs captured with the tracer on (event records at the
    regions' marks) give the untraced graphs' boxes bit for bit, and a
    region time for each replay."""
    cfg, model = card_model
    off = _card_run(cfg, model, S, 6)
    tracing.start()
    try:
        on = _card_run(cfg, model, S, 6)
        rec = tracing.export()
    finally:
        tracing.stop()
    np.testing.assert_array_equal(on, off)
    kinds = Counter((r[0], r[1]) for r in rec["regions"])
    assert kinds == {("step", "crop"): 6, ("step", "backbone"): 6, ("step", "head"): 6,
                     ("remine", "remine"): 3}


SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.7-2.0 GHz


@pytest.fixture(scope="module")
def profiled(card_model):
    """16 steps of the S=1 graph step with the tracer on, the last 10
    profiled, each graph launch between two CUDA events of the test's own:
    the tracer's export, the profiler's events (name, start_ns, end_ns,
    correlation id, on the device), the profile's start on time.time_ns()
    and the ms between each launch's own events, in launch order. A spin of
    about 1 ms (SPIN_CYCLES) ahead of the first event keeps the device busy
    while the host reads the last times and launches the graph, so the
    events time the graph on the device: with the device idle the first
    event would also hold the host's 0.1-0.2 ms between it and the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, model = card_model
    replay, outer, started = tracing.replay, [], []

    def timed_replay(name, regions, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        replay(name, regions, fn)
        b.record()
        outer.append((a, b))

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(t):
        if t == 6:
            torch.cuda.synchronize()
            prof.__enter__()
            started.append(time.time_ns())

    tracing.start()
    tracing.replay = timed_replay
    try:
        _card_run(cfg, model, 1, 16, on_step)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        rec = tracing.export()
    finally:
        tracing.replay = replay
        tracing.stop()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
               e.device_type() == DeviceType.CUDA)
              for e in prof.profiler.kineto_results.events()]
    return rec, events, started[0], [a.elapsed_time(b) for a, b in outer]


def _launched(events, span, api):
    """The device events of the one `api` call made inside `span`."""
    calls = [e for e in events if not e[4] and e[0] == api and span[1] <= e[1] <= span[2]]
    assert len(calls) == 1, (span, calls)
    return [e for e in events if e[4] and e[3] == calls[0][3]]


@pytest.mark.gpu
def test_cuda_regions_cover_each_replay(profiled):
    """Each unprofiled step-graph replay's regions add up to within 5% of
    the time between two events recorded around its launch on a busy
    device: the marks inside the graph time all of it (a re-mine replay's,
    ~0.3 ms, under it: the graph's nodes before its first mark are outside
    the regions). Each profiled replay's kernels (their busy union) fit inside
    the mean of those sums, no kernel running outside the regions, and fill
    most of it: the sum holds the gaps between a graph's kernels, but a mark
    out of place would add more. The re-mine graph's ~0.2 ms of small
    kernels leaves more of its time in gaps (its busy union 0.80 of the
    mean on an H100, the step graph's 0.90-0.93), hence its lower floor."""
    rec, events, t0, outer = profiled
    replays = [s for s in rec["spans"] if s[0].startswith("replay.")]
    assert len(replays) == len(outer) == 16 + 8

    def region_sum(kind, step):
        return sum(r[2] for r in rec["regions"] if r[0] == kind and r[3] == step)

    plain = {"step": [], "remine": []}
    for span, ms in zip(replays, outer):
        kind = span[0].split(".")[1]
        if span[1] < t0:
            plain[kind].append(region_sum(kind, span[5]))
            if kind == "step":
                assert plain[kind][-1] == pytest.approx(ms, rel=0.05), (span, plain[kind][-1], ms)
            else:
                assert plain[kind][-1] <= ms, (span, plain[kind][-1], ms)
    floor = {"step": 0.85, "remine": 0.7}
    for span in (s for s in replays if s[1] > t0):
        kind = span[0].split(".")[1]
        dev = _launched(events, span, "cudaGraphLaunch")
        busy = sum(b - a for a, b in union((e[1], e[2]) for e in dev)) / 1e6
        assert floor[kind] * np.mean(plain[kind]) <= busy <= np.mean(plain[kind]), \
            (kind, busy, plain[kind])


@pytest.mark.gpu
def test_cuda_spans_and_device_events_share_a_clock(profiled):
    """In every profiled step the frames' H2D copy starts after its
    stage.copy span starts, and the step graph's first kernel after its
    replay.step span starts."""
    rec, events, t0, _ = profiled
    copies = [s for s in rec["spans"] if s[0] == "stage.copy" and s[1] > t0]
    replays = [s for s in rec["spans"] if s[0] == "replay.step" and s[1] > t0]
    assert len(copies) >= 20 and len(replays) >= 10
    for span in copies:
        dev = _launched(events, span, "cudaMemcpyAsync")
        assert dev and min(e[1] for e in dev) >= span[1]
    for span in replays:
        assert min(e[1] for e in _launched(events, span, "cudaGraphLaunch")) >= span[1]
