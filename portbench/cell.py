"""One run of one cell: build the port from the seed, warm every shape the
traffic uses, measure for `seconds`, optionally profile, then hold what the
window produced against the reference.

Set-up: the port's model built without its own init, filled with the
benchmark's seeded weights (weights.py) in the dtype they are served in;
one JitTracker; the tracker the mix drives (BatchTracker for "lockstep",
Tracker for "single"), initialized on each stream's first frame; the
stagger (stream i runs round(i * period / S) steps alone, the others
frozen by set_active), then `warmup_steps` with every stream active, so the
step graph and the re-mine graph are both captured before the window.

The window is a closed loop: each step hands over its frames (one (S, H, W,
3) uint8 array, the bank's row as it is), waits for the boxes to be read
back, and only then sends the next, as a camera feed does. A step's latency
runs from the call to its boxes on the host; the enqueue span from the call
to its return (the pinned staging and the graph replays, before the
read-back). Steps are sampled from the seed (a reservoir per kind, plain
and due) for the comparison, which runs after the window on freed memory.
"""

from __future__ import annotations

import gc
import json
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, profile
from .reference import model as ref
from .spec import PKG, Cell
from .traffic import generator
from .weights import make_weights, reference_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_cfg(cell: Cell, variant: str):
    """The port's config: the frozen YAML, the file's overrides, the mix's
    test mode for a single stream; variant "control" adds the int8 weight
    path. The dims the reference reads must agree with it."""
    from uvltrack_tpu_torch.config import load_cfg

    c, tr = cell.config, cell.traffic
    cfg = load_cfg(str(PKG / "configs" / c["yaml"]))
    overrides = list(c.get("overrides", []))
    if tr["entry"] == "single":
        overrides.append(f"TEST.MODE={tr['modes'][0]}")
    if variant == "control":
        overrides.append("TPU.WEIGHT_QUANT=int8")
    cfg.merge_from_list(overrides)
    d = c["dims"]
    stated = {"template_size": cfg.TEST.TEMPLATE_SIZE, "search_size": cfg.TEST.SEARCH_SIZE,
              "template_factor": cfg.TEST.TEMPLATE_FACTOR, "search_factor": cfg.TEST.SEARCH_FACTOR,
              "fusion_layers": list(cfg.MODEL.BACKBONE.FUSION_LAYER),
              "embed_dim": cfg.MODEL.HIDDEN_DIM, "head_dim": cfg.MODEL.HEAD.HEAD_DIM,
              "max_query_len": cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN,
              "update_interval": cfg.TEST.UPDATE_INTERVAL, "threshold": cfg.TEST.THRESHOLD,
              "compute_dtype": cfg.TPU.COMPUTE_DTYPE}
    head = {"softmax_one": cfg.MODEL.HEAD.SOFTMAX_ONE, "cls_tokenize": cfg.MODEL.HEAD.CLS_TOKENIZE,
            "offset_sigmoid": cfg.MODEL.HEAD.OFFSET_SIGMOID,
            "txt_token_mode": cfg.MODEL.BACKBONE.TXT_TOKEN_MODE,
            "template_size": cfg.DATA.TEMPLATE.SIZE, "search_size": cfg.DATA.SEARCH.SIZE}
    wrong = {k: (v, d[k]) for k, v in stated.items() if v != d[k]}
    wrong.update({k: (v, d["head"][k]) for k, v in head.items() if v != d["head"][k]})
    if wrong:
        raise ValueError(f"config {c['name']}: the YAML and the dims disagree: {wrong}")
    return cfg


def build_port(cfg, d: dict, seed: int, device):
    """The port's UVLTrack built by its registry entry without its own init,
    every tensor of its state dict set from the benchmark's weights."""
    import uvltrack_tpu_torch.models.uvltrack as U

    saved = U.init_model
    U.init_model = lambda model, seed=0: model
    try:
        model = U.build_model(cfg, device=device)
    finally:
        U.init_model = saved
    specs = ref.param_specs(d)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {name: tuple(shape) for name, shape, _ in specs}
    if got != want:
        raise ValueError("the port's state dict is not the configuration's: "
                         f"{sorted(set(got.items()) ^ set(want.items()))[:8]}")
    weights = make_weights(specs, seed, device, DTYPES[d["compute_dtype"]])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = weights.pop(name)
        for name, b in model.named_buffers():
            if name in weights:
                b.copy_(weights.pop(name))
    return model


class Streams:
    """The mix's tracker behind one interface: step(frames) -> (S, 5) device
    boxes (async), state, graph_maps(), set_active."""

    def __init__(self, cfg, jt, tr: dict, tokenizer, force_graphs: bool):
        from uvltrack_tpu_torch.track.batch import BatchTracker
        from uvltrack_tpu_torch.track.tracker import Tracker

        self.single = tr["entry"] == "single"
        self.S = len(tr["modes"])
        if self.single:
            self.t = Tracker(cfg, jit_tracker=jt, tokenizer=tokenizer)
        else:
            self.t = BatchTracker(cfg, None, self.S, tokenizer=tokenizer, jit_tracker=jt)
        if force_graphs:
            self.t.graphs = True

    def initialize(self, frames, boxes, sentences, modes):
        if self.single:
            lang = " ".join(sentences[0]) if sentences[0] else None
            self.t.initialize(frames[0], {"init_bbox": [float(v) for v in boxes[0]],
                                          "language": lang})
        else:
            self.t.initialize(frames, boxes, [" ".join(s) if s else None for s in sentences],
                              list(modes))

    def step(self, frames):
        if self.single:
            return self.t.track_async(frames[0])[None]
        return self.t.step_async(frames)

    def set_active(self, active) -> None:
        if not self.single:
            self.t.set_active(active)

    @property
    def state(self):
        return self.t.state


def due_step(state, update_interval: int) -> bool:
    frame_id = state.frame_id + state.active
    return bool((((frame_id % update_interval) == 0) & state.active).any())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        variant: str = "sound", force_graphs: bool = False, fault=None,
        fp8_control: bool = False) -> dict:
    """One run; returns the record the metrics read and the check's tally.
    `fault(streams)`, in tests, breaks the timed path after set-up;
    fp8_control also tallies the reference in float8 put in the program's
    place on the same sampled states (readings.py)."""
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.track.tracker import JitTracker

    d, tr = cell.config["dims"], cell.traffic
    cfg = port_cfg(cell, variant)
    model = build_port(cfg, d, seed, device)
    bank, gt = generator.make_bank(tr, seed)
    tokens = generator.vocab_tokens(tr, seed)
    sentences = generator.sentences(tr, seed)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        vocab_file = Path(tmp) / "vocab.txt"
        vocab_file.write_text("\n".join(tokens) + "\n")
        tokenizer = BertTokenizer(str(vocab_file))
    jt = JitTracker(cfg, model)
    drv = Streams(cfg, jt, tr, tokenizer, force_graphs)
    f_len, S = bank.shape[0], drv.S
    drv.initialize(bank[0], gt[0], sentences, tr["modes"])
    init_prompt = drv.state.prompt
    row = 0
    offsets = generator.stagger(tr)
    for k in range(max(offsets)):
        drv.set_active(np.array([k < o for o in offsets]))
        drv.step(bank[row % f_len]).cpu()
        row += 1
    drv.set_active(np.ones(S, bool))
    for _ in range(tr["warmup_steps"]):
        drv.step(bank[row % f_len]).cpu()
        row += 1
    if fault is not None:
        fault(drv)
    sync(device)
    setup_s = time.perf_counter() - t_start

    ui = d["update_interval"]
    rng, sizes = generator.reservoir(tr, seed)
    kept = {k: [] for k in sizes}
    seen = {k: 0 for k in sizes}
    lat, enq = [], []
    attempted = failed = done = 0
    spans = profile.Spans()

    def one_step(traced: bool):
        nonlocal row, attempted, failed, done
        frames = bank[row % f_len]
        pre = drv.state
        kind = "due" if due_step(pre, ui) else "plain"
        slot = None
        if not traced:
            n = seen[kind]
            seen[kind] += 1
            if len(kept[kind]) < sizes[kind]:
                slot = len(kept[kind])
                kept[kind].append(None)
            else:
                j = int(rng.integers(n + 1))
                slot = j if j < sizes[kind] else None
        a = time.perf_counter()
        ta = time.time_ns()
        attempted += S
        try:
            out = drv.step(frames)
            b = time.perf_counter()
            tb = time.time_ns()
            boxes = out.double().cpu().numpy()
        except RuntimeError:  # the step raised: its frames failed, the window ends
            traceback.print_exc()
            failed += S
            return None
        c = time.perf_counter()
        tc = time.time_ns()
        bad = int((~np.isfinite(boxes).all(-1)).sum())
        failed += bad
        done += S - bad
        if traced:
            spans.add("enqueue (staging, graph replays)", ta, tb)
            spans.add("read-back of the boxes", tb, tc)
        else:
            lat.append(c - a)
            enq.append(b - a)
        if slot is not None:
            kept[kind][slot] = check.Sample(row % f_len, pre, drv.state, boxes,
                                            drv.t.graph_maps())
        row += 1
        return tc

    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds and one_step(False) is not None:
        pass
    window_s = time.perf_counter() - w0
    frames_window, steps = done, len(lat)
    summary = None
    if trace:
        with profile.Window(spans, lambda: sync(device)) as win:
            last = time.time_ns()
            for _ in range(tr["trace_steps"]):
                start = time.time_ns()
                spans.add("harness between steps", last, start)
                last = one_step(True)
                if last is None:
                    break
        summary = win.summary
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = [s for group in kept.values() for s in group if s is not None]
    del drv, jt, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tally, fp8 = reference_check(cell, seed, device, bank, gt, tokens, sentences, init_prompt,
                                 samples, fp8_control)
    tally.count("failed", failed, attempted)
    record = SimpleNamespace(setup_s=setup_s, window_s=window_s, stream_frames=frames_window,
                             steps=steps, lat_s=lat, enq_s=enq, streams=S, dims=d,
                             trace=summary, trace_steps=tr["trace_steps"] if trace else 0)
    return {"record": record, "tally": tally, "attempted": attempted, "failed": failed,
            "memory_peak_bytes": int(peak), "samples": len(samples), "fp8_tally": fp8}


def reference_check(cell, seed, device, bank, gt, tokens, sentences, init_prompt, samples,
                    fp8_control: bool = False):
    d, tr = cell.config["dims"], cell.traffic
    with torch.no_grad(), ref.exact_fp32():
        W = reference_weights(ref.param_specs(d), seed, device, DTYPES[d["compute_dtype"]])
        vocab = {t: i for i, t in enumerate(tokens)}
        enc = [ref.encode(s or [], vocab, d["max_query_len"]) for s in sentences]
        ids = torch.tensor([e[0] for e in enc], device=device)
        mask = torch.tensor([e[1] for e in enc], device=device)
        flags = torch.tensor([2 if m == "NLBBOX" else 0 for m in tr["modes"]], device=device)
        for i, s in enumerate(sentences):
            if s is None:  # BBOX: no text, an all-zero row, as the tracker feeds it
                ids[i], mask[i] = 0, 0
        first, boxes = torch.from_numpy(bank[0]).to(device), torch.from_numpy(gt[0]).to(device)
        seq = ref.Sequence(W, d, first, boxes, ids, mask, flags)
        args = (bank, d["update_interval"], d["threshold"], device)
        tally = check.compare(seq, init_prompt, samples, *args)
        fp8 = None
        if fp8_control:
            ctrl = ref.Sequence(ref.Fp8Weights(W), d, first, boxes, ids, mask, flags)
            fp8 = check.compare(seq, ctrl.prompt, check.stand_in(ctrl, samples, *args), *args)
        return tally, fp8


def nvidia_smi() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def dump(obj) -> str:
    return json.dumps(obj, separators=(", ", ": "))
