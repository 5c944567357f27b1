"""Stateful UVLTrack tracker with a device-resident per-frame step and its
compiled form, CUDA graphs of the step (port of
uvltrack_tpu/track/tracker.py, modes BBOX, NL and NLBBOX; reference
lib/test/tracker/uvltrack.py).

Initialization: BBOX and NLBBOX start from the given box (flag 0 / 2). NL
starts from a sentence alone: the grounding forward (JitTracker.grounding_fn)
letterboxes the first frame to the search size and runs UVLTrack.forward
under flag 1 with a zero template and all-false template/context masks;
its best box, mapped back to image xywh, becomes the init box, and the
sequence then tracks with flag 2 like NLBBOX. The grounding box costs one
host read.

Per frame: crop/resize/normalize the search region on the device, run
UVLTrack.forward_test_cached (forward_test, BERT included, under
TPU.CACHE_TEXT=False), weight the cls map by the Hann window and the
contrastive score, take the argmax box, map it back and clip it. Every
UPDATE_INTERVAL frames the prompt is re-mined from the best-scoring frame's
cached features if that frame's score beat TEST.THRESHOLD.

The step is split in two (JitTracker):

- a body of device tensors only, the same code on every backend:
  `step_body` (crop, forward, decode, best-feature update of S streams,
  an `active` mask always applied by torch.where, so a frozen stream keeps
  its box and features) and `remine_body` (forward_prompt, each row's
  prompt and max_score where-selected by refresh = due & (max_score >
  threshold), computed on the device);
- a host driver (LockstepTracker.step_rows), which keeps frame_id and the
  active flags on the host, fills the body's inputs and runs the re-mine
  only on a step where some active stream is due.

On a CUDA device the driver replays CUDA graphs of the two bodies, one pair
per (frame size, S, call-time knobs), held by a JitTracker that any number
of Trackers, BatchTrackers and StreamPools share (jit_tracker=); the graph
path reads nothing back to the host but the caller's packed boxes, as the
JAX package's jitted step with its lax.cond re-mine. graphs=False, the
debug step and CPU tensors run the bodies eagerly, and the eager driver
makes its one host read, max_score > threshold, on due steps, as before
(UVLTRACK_BATCH_COND_REMINE=0 re-mines every step, where-selected, with no
read: the same boxes). `track` reads the packed (box, score) back each
frame; `track_many` once per chunk of frames.

utils/tracing.py traces the host side (the `step` span, the graph replays,
the re-mine's computed and due rows) and, through marks in the bodies, the
device regions of the crop, the backbone, the head and the re-mine.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core.box_ops import box_cxcywh_to_xywh, clip_box_xywh
from ..core.geometry import anno2mask, crop_box_normalized, map_box_back
from ..core.hann import hanning2d_flat
from ..models.uvltrack import UVLTrack, prepare_inference_model
from ..ops import attention, build
from ..utils import tracing
from ..utils.pinned import PinnedStage
from .pipeline import grounding_letterbox, sample_target_device

# the device tensors of a state, and a sequence's per-stream constants
STATE_KEYS = ("box", "prompt", "max_score", "best_box_net", "best_search", "best_template",
              "best_vis_token", "best_txt_token")
CONST_KEYS = ("template", "template_mask", "txt", "text_mask", "flags")
# frames a chunked upload (track_many, step_many) stages in one pinned copy at most
STAGE_BYTES = 128 << 20
_TOKENS = itertools.count(1)


@dataclass
class BatchState:
    """The state of S streams (S=1 for Tracker): device tensors, but for the
    host-side frame counters and active flags."""
    box: torch.Tensor            # (S, 4) xywh, image coords
    prompt: torch.Tensor         # (S, 3, C)
    max_score: torch.Tensor      # (S,)
    frame_id: np.ndarray         # (S,) host-side frame counters
    active: np.ndarray           # (S,) bool, host-side
    best_box_net: torch.Tensor   # (S, 4) cxcywh normalized, best frame's net box
    best_search: torch.Tensor    # (S, s, C) cached backbone features, fp32
    best_template: torch.Tensor  # (S, z, C)
    best_vis_token: torch.Tensor  # (S, 1, C)
    best_txt_token: torch.Tensor  # (S, 1, C)


def graph_knobs() -> tuple:
    """The call-time settings that change which ops a step runs
    (ops/attention.py): the backend, UVLTRACK_FUSED_PREFIX,
    UVLTRACK_FUSED_PROJ, UVLTRACK_FUSED_MLP and UVLTRACK_PALLAS_MIN_N; and
    whether the tracer is on (its graphs hold the region timers' event
    records, utils/tracing.py). A graph freezes the path it captured, so
    each setting gets its own."""
    return (attention.get_backend(), attention.fused_prefix(),
            os.environ.get("UVLTRACK_FUSED_PROJ", "0") == "1",
            os.environ.get("UVLTRACK_FUSED_MLP", "0") == "1", attention.min_seq_len(),
            tracing.active())


class _GraphSet:
    """The step graph and the re-mine graph of one (frame size, S, knobs),
    with the static buffers they read: frames, the active and due masks,
    the state and the constants. The graphs' outputs live in the
    JitTracker's pool."""

    def __init__(self, key, tracker: "LockstepTracker"):
        (h, w), S, _ = key
        dev, st = tracker.device, tracker.state
        self.key = key
        self.frames = torch.empty((S, h, w, 3), dtype=torch.uint8, device=dev)
        self.masks = torch.empty((2, S), dtype=torch.bool, device=dev)  # active, due
        self.state = {k: torch.empty_like(getattr(st, k)) for k in STATE_KEYS}
        self.consts = {k: torch.empty_like(getattr(tracker, k)) for k in CONST_KEYS}
        self.owner = None  # whose constants the buffers hold
        self.step = self.remine = None  # replay callables (graph.replay keeps its graph)
        self.step_out = self.remine_out = None
        self.captured = {"step": {}, "remine": {}}
        self.replays = {"step": 0, "remine": 0}
        self.regions = {"step": None, "remine": None}  # a capture's region marks
        self.capture_s = 0.0

    def load(self, tracker: "LockstepTracker") -> None:
        """Copy the tracker's state in, and its constants if another
        tracker (or another sequence) filled them last."""
        st = tracker.state
        for k in STATE_KEYS:
            self.state[k].copy_(getattr(st, k))
        consts = [getattr(tracker, k) for k in CONST_KEYS]
        owner = (tracker._token, tuple(t.data_ptr() for t in consts))
        if owner != self.owner:
            for k, t in zip(CONST_KEYS, consts):
                self.consts[k].copy_(t)
            self.owner = owner


class JitTracker:
    """The compiled step of one model and config: the prepared model, the
    step's settings, the two bodies, and CUDA graphs of them (the port's
    counterpart of the JAX JitTracker's jitted step_fn, keyed by the frame
    size as there, and by S and graph_knobs() here).

    Graphs are captured at first use of a key: the body is warmed up on a
    side stream (so cuBLAS/cuDNN plans, each kernel's shared-memory opt-in
    and the weights' TMA descriptors are made outside the capture), then
    captured into this JitTracker's one private memory pool, which all its
    graphs share; a graph's outputs are read (copied out) before any other
    graph of the pool is replayed. A failed capture or replay raises. The
    kernel calls recorded during each capture are kept (captured_launches),
    and every replay is counted (replays)."""

    WARMUP = 2

    def __init__(self, cfg, model: UVLTrack):
        self.cfg = cfg
        self.model = prepare_inference_model(cfg, model)
        self.device = next(model.parameters()).device
        # TPU.CACHE_TEXT (default on): the step reads the pre-fusion text
        # features cached at initialize; off, it runs UVLTrack.forward_test on
        # the raw text ids every frame (BERT each frame, the JAX package's
        # debug path)
        self.cache_text = bool(cfg.TPU.CACHE_TEXT)
        self.search_size = int(cfg.TEST.SEARCH_SIZE)
        self.template_size = int(cfg.TEST.TEMPLATE_SIZE)
        self.search_factor = float(cfg.TEST.SEARCH_FACTOR)
        self.template_factor = float(cfg.TEST.TEMPLATE_FACTOR)
        self.map_size = self.search_size // 16
        self.update_interval = int(cfg.TEST.UPDATE_INTERVAL)
        self.threshold = float(cfg.TEST.THRESHOLD)
        self.has_cont = float(cfg.TRAIN.CONT_WEIGHT) > 0
        self.remine_on = self.has_cont and self.update_interval > 0
        self.window = hanning2d_flat(self.map_size, self.device)
        self._sets: Dict[tuple, _GraphSet] = {}
        self._stream = self._pool = None
        # threads that step trackers of this JitTracker hold it (cli/serve.py):
        # its graphs share static buffers and one memory pool
        self.lock = threading.Lock()

    # ---------------------------------------------------------------- bodies
    @torch.no_grad()
    def step_body(self, frames, active, st: dict, c: dict, debug: bool = False) -> dict:
        """One step of S streams from device tensors only: frames (S, H, W,
        3) uint8, active (S,) bool, the state tensors `st` (STATE_KEYS) and
        the constants `c` (CONST_KEYS). Returns the new box, max_score and
        best features, and packed (S, 5) [x, y, w, h, score]; with
        debug=True also maps, the (S, 3, fsz*fsz) [cls, cont, merged]
        response maps (the reference's debug hook,
        lib/test/tracker/uvltrack.py:155-157)."""
        S, sz = frames.shape[0], self.search_size
        h, w = frames.shape[1], frames.shape[2]
        tracing.mark("crop")
        search, resize_factor = sample_target_device(frames, st["box"], self.search_factor, sz)
        tracing.mark("backbone")
        test = self.model.forward_test_cached if self.cache_text else self.model.forward_test
        out = test(c["template"], search, c["txt"], c["text_mask"], st["prompt"], c["flags"])
        cls = out["cls_score_test"].reshape(S, -1).float()
        if self.has_cont:
            cont = torch.softmax(out["cont_score"].float(), dim=-1)[:, :, 0]
        else:
            cont = torch.ones_like(cls)
        merged = cls * self.window * cont
        k = torch.argmax(merged, dim=-1)  # first max of each row, row-major cells
        rows = torch.arange(S, device=frames.device)
        box_net = out["bbox_map"][rows, k]  # (S, 4) cxcywh normalized
        score = (cls * cont)[rows, k]
        pred_crop = box_net * sz / resize_factor[:, None]
        new_box = clip_box_xywh(map_box_back(pred_crop, st["box"], resize_factor, sz),
                                h, w, margin=10)
        # a frozen stream keeps its box and best features (all-true: identity)
        new_box = torch.where(active[:, None], new_box, st["box"])
        is_best = (score > st["max_score"]) & active

        def pick(new, old):
            return torch.where(is_best.view((S,) + (1,) * (old.ndim - 1)), new.float(), old)

        res = {"box": new_box, "max_score": pick(score, st["max_score"]),
               "best_box_net": pick(box_net, st["best_box_net"]),
               "best_search": pick(out["search"], st["best_search"]),
               "best_template": pick(out["template"], st["best_template"]),
               "best_vis_token": pick(out["vis_token"], st["best_vis_token"]),
               "best_txt_token": pick(out["txt_token"], st["best_txt_token"]),
               "packed": torch.cat([new_box, score[:, None]], dim=-1)}
        if debug:
            res["maps"] = torch.stack([cls, cont, merged], dim=1)
        tracing.mark("end")
        return res

    @torch.no_grad()
    def remine_body(self, due, st: dict, c: dict) -> dict:
        """The re-mine of S streams from device tensors only: refresh = due
        & (max_score > threshold), on the device; forward_prompt from the
        best frame's features, each refreshed row's prompt replaced and its
        max_score zeroed. Returns prompt, max_score and refresh. What the
        JAX step's lax.cond decides, row by row."""
        tracing.mark("remine")
        refresh = due & (st["max_score"] > self.threshold)
        ctx_mask = anno2mask(box_cxcywh_to_xywh(st["best_box_net"]), self.map_size)
        feats = {"search": st["best_search"], "template": st["best_template"],
                 "vis_token": st["best_vis_token"], "txt_token": st["best_txt_token"],
                 "flag": c["flags"]}
        new_prompt = self.model.forward_prompt(feats, c["template_mask"], ctx_mask)
        prompt = st["prompt"]
        out = {"prompt": torch.where(refresh[:, None, None], new_prompt.to(prompt.dtype), prompt),
               "max_score": torch.where(refresh, torch.zeros_like(st["max_score"]),
                                        st["max_score"]),
               "refresh": refresh}
        tracing.mark("end")
        return out

    # ---------------------------------------------------------------- graphs
    def graph_key(self, hw, S: int) -> tuple:
        return (tuple(int(v) for v in hw), int(S), graph_knobs())

    def graph_set(self, hw, tracker: "LockstepTracker") -> _GraphSet:
        key = self.graph_key(hw, tracker.S)
        gs = self._sets.get(key)
        if gs is None:
            gs = self._sets[key] = _GraphSet(key, tracker)
        return gs

    def _capture(self, fn):
        """(replay, outputs): fn warmed up on the side stream, then captured
        into a CUDA graph in this JitTracker's pool; outputs are the tensors
        the capture made, which every replay rewrites."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        side, cur = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA call (a served stream's upload,
        # a freed event) does not invalidate this capture
        with torch.cuda.graph(graph, pool=self._pool, stream=side,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph.replay, out

    def _captured(self, gs: _GraphSet, name: str, fn):
        """The capture of graph `name` of gs: capture_s and the tracer's span
        setup.capture from the same two clock reads, the region marks the
        capture recorded (while the tracer is on) and the kernel calls."""
        before = build.captured_counts()
        t0 = time.time_ns()
        with tracing.regions(name, self.device, graph=True) as regions:
            replay, out = self._capture(fn)
        t1 = time.time_ns()
        gs.capture_s += (t1 - t0) / 1e9
        tracing.add("setup.capture", t0, t1)
        gs.regions[name] = regions
        after = build.captured_counts()
        gs.captured[name] = {k: n - before.get(k, 0) for k, n in after.items()
                             if n != before.get(k, 0)}
        return replay, out

    def replay_step(self, gs: _GraphSet) -> dict:
        if gs.step is None:  # the maps too: graph_maps() reads them for an A/B
            gs.step, gs.step_out = self._captured(gs, "step", lambda: self.step_body(
                gs.frames, gs.masks[0], gs.state, gs.consts, debug=True))
        tracing.replay("replay.step", gs.regions["step"], gs.step)
        gs.replays["step"] += 1
        return gs.step_out

    def replay_remine(self, gs: _GraphSet) -> dict:
        """After replay_step: the re-mine graph over the step graph's new
        state and the static prompt and due mask."""
        def fn():
            st = dict(gs.step_out, prompt=gs.state["prompt"])
            return self.remine_body(gs.masks[1], st, gs.consts)

        if gs.remine is None:
            gs.remine, gs.remine_out = self._captured(gs, "remine", fn)
        tracing.replay("replay.remine", gs.regions["remine"], gs.remine)
        gs.replays["remine"] += 1
        return gs.remine_out

    # ------------------------------------------------------------- accounting
    def keys(self) -> list:
        return list(self._sets)

    def captured_launches(self, key) -> dict:
        """{"step": {...}, "remine": {...}}: the kernel calls each graph of
        `key` recorded at capture, by instantiation, i.e. its launches per
        replay."""
        return {k: dict(v) for k, v in self._sets[key].captured.items()}

    def replays(self, key) -> dict:
        return dict(self._sets[key].replays)

    @property
    def graphs_captured(self) -> int:
        return sum((gs.step is not None) + (gs.remine is not None) for gs in self._sets.values())

    @property
    def capture_seconds(self) -> float:
        return sum(gs.capture_s for gs in self._sets.values())


class LockstepTracker:
    """What Tracker and BatchTracker share: the config, the prompt init, the
    grounding box and the host driver of the step of S streams in lockstep
    (S=1 for Tracker).

    The model, the step's settings and its CUDA graphs live on a JitTracker,
    made here unless one is passed (jit_tracker=, shared by any number of
    trackers: a new tracker costs state init, not a capture). Its weights are
    prepared in place by prepare_inference_model (bf16 per
    cfg.TPU.COMPUTE_DTYPE, int8 per cfg.TPU.WEIGHT_QUANT; a model prepared
    already is left as it is). graphs=False selects the eager step on a CUDA
    device; CPU tensors always run it. A subclass's initialize sets
    text_ids, text_mask, flags, template, template_mask, txt and state and
    calls consts_changed()."""

    def __init__(self, cfg, model: Optional[UVLTrack], num_streams: int, tokenizer=None,
                 jit_tracker: Optional[JitTracker] = None, graphs: bool = True):
        if num_streams < 1:
            raise ValueError(f"num_streams must be >= 1, got {num_streams}")
        self.cfg = cfg
        self.S = num_streams
        self.jt = jt = jit_tracker if jit_tracker is not None else JitTracker(cfg, model)
        self.model, self.device = jt.model, jt.device
        self.cache_text = jt.cache_text
        self.search_size, self.template_size = jt.search_size, jt.template_size
        self.search_factor, self.template_factor = jt.search_factor, jt.template_factor
        self.map_size, self.window = jt.map_size, jt.window
        self.update_interval, self.threshold = jt.update_interval, jt.threshold
        self.has_cont = jt.has_cont
        self.graphs = bool(graphs) and self.device.type == "cuda"
        self.tokenizer = tokenizer
        self.nt = int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
        self.embed_dim = self.model.backbone.embed_dim
        self.state: Optional[BatchState] = None
        self.stage = PinnedStage()
        self._remines = torch.zeros((self.S,), dtype=torch.int32, device=self.device)
        self._token = next(_TOKENS)
        self._active_host = self._active_dev = None
        self._last_set: Optional[_GraphSet] = None

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def device_frames(self, frames) -> torch.Tensor:
        """S frames (a list, an (S, H, W, 3) array or tensor) on the device."""
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        if isinstance(frames, (list, tuple)):
            frames = np.stack(frames)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def consts_changed(self) -> None:
        """The per-sequence constants were set or written in place: a graph
        copies them in again before its next replay for this tracker."""
        self._token = next(_TOKENS)

    @torch.no_grad()
    def ground(self, frame: torch.Tensor, text_ids: torch.Tensor,
               text_mask: torch.Tensor) -> list:
        """The grounding box, image xywh, of one (H, W, 3) device frame and
        its (1, Nt) sentence, from the grounding forward at batch 1."""
        out = self.model(*grounding_inputs(frame, text_ids, text_mask,
                                           self.template_size, self.search_size))
        return letterbox_box_to_image(out["pred_boxes"][0, 0].float().cpu().numpy(),
                                      tuple(frame.shape[:2]))

    @torch.no_grad()
    def init_rows(self, frames: torch.Tensor, boxes: torch.Tensor, text_ids, text_mask,
                  flags):
        """Template crops, template masks and mined prompts of B streams at
        batch B (the prompt init; no row mixes another)."""
        ts, ss = self.template_size, self.search_size
        template, _ = sample_target_device(frames, boxes, self.template_factor, ts)
        template_mask = anno2mask(crop_box_normalized(boxes, self.template_factor), ts // 16)
        context, _ = sample_target_device(frames, boxes, self.search_factor, ss)
        context_mask = anno2mask(crop_box_normalized(boxes, self.search_factor), ss // 16)
        prompt = self.model.forward_prompt_init(template, context, text_ids, text_mask,
                                                template_mask, context_mask, flags)
        return template, template_mask, prompt

    def fresh_state(self, box: torch.Tensor, prompt: torch.Tensor,
                    active: np.ndarray) -> BatchState:
        """A state at frame 0: zero best score and features."""
        s, z = (self.search_size // 16) ** 2, (self.template_size // 16) ** 2
        S, c = self.S, self.embed_dim

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        return BatchState(
            box=box, prompt=prompt, max_score=zeros(S), frame_id=np.zeros((S,), np.int64),
            active=np.asarray(active, bool).copy(), best_box_net=zeros(S, 4),
            best_search=zeros(S, s, c), best_template=zeros(S, z, c),
            best_vis_token=zeros(S, 1, c), best_txt_token=zeros(S, 1, c))

    # ------------------------------------------------------------ the driver
    def step_rows(self, frames, always_remine: bool = False, debug: bool = False):
        """Advance every active stream one frame; frames: S frames of one
        size (an (S, H, W, 3) uint8 tensor, array or a list of arrays).
        Returns the (S, 5) [x, y, w, h, score] device tensor without reading
        it back, and with debug=True also the (S, 3, fsz*fsz) [cls, cont,
        merged] response maps.

        A frozen stream keeps its box and best features, and its frame_id
        does not advance. always_remine re-mines every step, where-selected:
        the same boxes. The graph path (CUDA, graphs on, not debug) replays
        the step graph and, on a step where some active stream is due (or
        always), the re-mine graph, with no host read; the eager path reads
        max_score > threshold on due steps."""
        if debug or not self.graphs:
            return self._eager_step(self.device_frames(frames), always_remine, debug)
        hw = frames[0].shape[:2] if isinstance(frames, (list, tuple)) else frames.shape[1:3]

        def load(out):
            if isinstance(frames, torch.Tensor):
                out.copy_(frames)
            else:
                self.stage.upload(frames, out)

        return self._graph_step(load, hw, always_remine)

    def _host_masks(self):
        """(frame_id after this step, due): both on the host."""
        st = self.state
        frame_id = st.frame_id + st.active
        if not self.jt.remine_on:
            return frame_id, np.zeros_like(st.active)
        return frame_id, (frame_id % self.update_interval == 0) & st.active

    def _tensors(self):
        st = self.state
        return ({k: getattr(st, k) for k in STATE_KEYS},
                {k: getattr(self, k) for k in CONST_KEYS})

    def _active_device(self) -> torch.Tensor:
        """The active mask on the device, uploaded again only when it changed."""
        active = self.state.active
        if self._active_host is None or not np.array_equal(self._active_host, active):
            self._active_dev = self.to_device(active.copy())
            self._active_host = active.copy()
        return self._active_dev

    @torch.no_grad()
    @tracing.spanned("step")
    def _eager_step(self, frames: torch.Tensor, always_remine: bool, debug: bool):
        st, jt = self.state, self.jt
        frame_id, due = self._host_masks()
        # a host-to-device copy waits for the stream: made here, before the
        # forward, so none holds the host while the forward runs
        active = self._active_device()
        due_dev = self.to_device(due) if jt.remine_on and always_remine else None
        state, consts = self._tensors()
        with tracing.regions("step", self.device):
            out = jt.step_body(frames, active, state, consts, debug=debug)
        prompt, max_score = st.prompt, out["max_score"]
        if jt.remine_on:
            n_due = int(due.sum()) if tracing.active() else 0
            if not always_remine and due.any():  # the one host read
                due &= (max_score > self.threshold).cpu().numpy()
                due_dev = self.to_device(due) if due.any() else None
            if due_dev is not None:
                with tracing.regions("remine", self.device):
                    r = jt.remine_body(due_dev, dict(out, prompt=prompt), consts)
                tracing.count("remine.rows_computed", self.S)
                tracing.count("remine.rows_due", n_due)
                prompt, max_score = r["prompt"], r["max_score"]
                self._remines += r["refresh"]
        self.state = BatchState(prompt=prompt, max_score=max_score, frame_id=frame_id,
                                active=st.active,
                                **{k: out[k] for k in STATE_KEYS if k not in ("prompt",
                                                                             "max_score")})
        if debug:
            return out["packed"], out["maps"]
        return out["packed"]

    @torch.no_grad()
    @tracing.spanned("step")
    def _graph_step(self, load_frames, hw, always_remine: bool):
        """One replay of the step graph (and of the re-mine graph on due
        steps): frames and the active/due masks in through pinned buffers,
        the state copied in, the new state and packed boxes copied out (the
        next replay, by this tracker or another on the same JitTracker,
        rewrites the graph's outputs)."""
        st, jt = self.state, self.jt
        frame_id, due = self._host_masks()
        gs = jt.graph_set(hw, self)
        load_frames(gs.frames)
        self.stage.upload(np.stack([st.active, due]), gs.masks)
        gs.load(self)
        out = jt.replay_step(gs)
        new = {k: out[k].clone() for k in STATE_KEYS if k != "prompt"}
        new["prompt"] = st.prompt
        if jt.remine_on and (always_remine or due.any()):
            r = jt.replay_remine(gs)
            if tracing.active():
                tracing.count("remine.rows_computed", self.S)
                tracing.count("remine.rows_due", due.sum())
            new["prompt"], new["max_score"] = r["prompt"].clone(), r["max_score"].clone()
            self._remines += r["refresh"]
        packed = out["packed"].clone()
        self.state = BatchState(frame_id=frame_id, active=st.active, **new)
        self._last_set = gs
        return packed

    def graph_maps(self) -> torch.Tensor:
        """The (S, 3, fsz*fsz) [cls, cont, merged] response maps of this
        tracker's last graph step, as the debug step returns them: for an
        A/B of the graph against the eager step from one state. Valid until
        the next replay of the JitTracker's graphs, by any tracker."""
        return self._last_set.step_out["maps"].clone()

    def _chunk_steps(self, frames_t, always_remine: bool = False) -> torch.Tensor:
        """T steps of S frames each (frames_t: T items of S same-size frames),
        through the graphs: the frames of up to STAGE_BYTES go up in one
        pinned copy, and each step copies its S frames into the step graph's
        frame slot on the device. Returns the (T, S, 5) device tensor."""
        first = frames_t[0]
        hw = first[0].shape[:2] if isinstance(first, (list, tuple)) else first.shape[1:3]
        per_step = self.S * int(np.prod(hw)) * 3
        group = max(1, STAGE_BYTES // per_step)
        packs = []
        for g in range(0, len(frames_t), group):
            block = frames_t[g:g + group]
            dev = torch.empty((len(block), self.S, *hw, 3), dtype=torch.uint8,
                              device=self.device)
            if isinstance(block, torch.Tensor):
                dev.copy_(block)
            else:  # an array, or a list of S-frame rows
                self.stage.upload(block, dev)
            for i in range(len(block)):
                packs.append(self._graph_step(lambda out, i=i: out.copy_(dev[i]), hw,
                                              always_remine))
        return torch.stack(packs)

    # ------------------------------------------------------------------ cost
    def step_cost(self, image_shape) -> dict:
        """{"flops", "bytes"} of one tracked frame of `image_shape` (H, W, 3),
        counted from the shapes (frame_cost): the backbone's and the head
        towers' products, and the weights the step reads at their stored
        width plus the frame's bytes. The JAX Tracker's step_cost reads its
        compiled step's cost analysis."""
        cost = frame_cost(self.model, self.nt)
        return {"flops": cost["flops"],
                "bytes": cost["weight_bytes"] + int(np.prod(tuple(image_shape)))}


class Tracker(LockstepTracker):
    """Reference-compatible API: initialize(image, info) / track(image) of
    one stream, stepped by the lockstep step at S=1. Images are (H, W, 3)
    uint8 numpy arrays. Tracker(cfg, model, tokenizer=None,
    jit_tracker=None, graphs=True): with jit_tracker given, model may be
    None (the JitTracker's is used)."""

    def __init__(self, cfg, model: Optional[UVLTrack] = None, tokenizer=None,
                 jit_tracker: Optional[JitTracker] = None, graphs: bool = True):
        super().__init__(cfg, model, 1, tokenizer, jit_tracker=jit_tracker, graphs=graphs)

    @property
    def remines(self) -> int:
        """Prompt re-mines since initialize."""
        return int(self._remines[0])

    @property
    def flag(self) -> torch.Tensor:
        """The (1,) flag: 2 with text (NL, NLBBOX), else 0."""
        return self.flags

    def _tokenize(self, language: Optional[str]):
        if language is None or self.tokenizer is None:
            ids = np.zeros((1, self.nt), np.int32)
            mask = np.zeros((1, self.nt), np.int32)
        else:
            i, m = self.tokenizer.encode_query(language, self.nt)
            ids = np.asarray(i, np.int32)[None]
            mask = np.asarray(m, np.int32)[None]
        return self.to_device(ids), self.to_device(mask)

    def _frame(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def grounding_inputs(self, frame: torch.Tensor) -> tuple:
        """UVLTrack.forward's arguments for grounding a (H, W, 3) device
        frame with this tracker's sentence (grounding_inputs)."""
        return grounding_inputs(frame, self.text_ids, self.text_mask,
                                self.template_size, self.search_size)

    @torch.no_grad()
    def grounding_forward(self, frame: torch.Tensor) -> dict:
        """The grounding forward's output dict; pred_boxes[0, 0] is the
        grounding box, cxcywh normalized to the letterbox side."""
        return self.model(*self.grounding_inputs(frame))

    def _grounding(self, image: np.ndarray):
        """The grounding box in image xywh (Tracker._grounding)."""
        return self.ground(self._frame(image), self.text_ids, self.text_mask)

    @torch.no_grad()
    @tracing.spanned("setup.initialize")
    def initialize(self, image: np.ndarray, info: dict):
        """Flags follow the single JAX Tracker: NL and NLBBOX get flag 2,
        with or without a sentence; any other mode tracks as BBOX."""
        mode = self.cfg.TEST.MODE
        with_text = mode in ("NL", "NLBBOX")
        self.text_ids, self.text_mask = self._tokenize(info.get("language") if with_text
                                                       else None)
        self.flags = torch.full((1,), 2 if with_text else 0, dtype=torch.int32,
                                device=self.device)
        if mode == "NL":
            init_bbox = self._grounding(image)
        else:
            init_bbox = [float(v) for v in info["init_bbox"]]
        box = self.to_device(np.asarray([init_bbox], np.float32))
        self.template, self.template_mask, prompt = self.init_rows(
            self._frame(image)[None], box, self.text_ids, self.text_mask, self.flags)
        # per-sequence constant consumed by the step: the cached pre-fusion
        # text features, or the raw ids under TPU.CACHE_TEXT=False
        self.txt = (self.model.encode_text(self.text_ids, self.text_mask)
                    if self.cache_text else self.text_ids)
        self.state = self.fresh_state(box, prompt, np.ones((1,), bool))
        self._remines.zero_()
        self.consts_changed()
        return {"target_bbox": init_bbox}

    def step(self, frame: torch.Tensor, debug: bool = False):
        """Advance one frame (a (H, W, 3) uint8 device tensor); return the
        packed [x, y, w, h, score] device tensor without synchronizing, and
        with debug=True also the (3, fsz*fsz) [cls, cont, merged] maps."""
        out = self.step_rows(frame[None], debug=debug)
        if debug:
            return out[0][0], out[1][0]
        return out[0]

    def track_async(self, image: np.ndarray) -> torch.Tensor:
        """Advance one frame (a (H, W, 3) uint8 array); return the packed
        [x, y, w, h, score] device tensor without reading it back."""
        return self.step_rows([image])[0]

    def track(self, image: np.ndarray, info: dict = None):
        packed = self.track_async(image).double().cpu().numpy()
        return {"target_bbox": packed[:4].tolist(), "score": float(packed[4])}

    def track_debug(self, image: np.ndarray, info: dict = None):
        """track() plus the (fsz, fsz) cls, contrastive and Hann-weighted
        merged maps, on the eager step; the box and score are track()'s bit
        for bit."""
        packed, maps = self.step(self._frame(image), debug=True)
        packed = packed.double().cpu().numpy()
        maps = maps.reshape(3, self.map_size, self.map_size).cpu().numpy()
        return {"target_bbox": packed[:4].tolist(), "score": float(packed[4]),
                "cls_map": maps[0], "cont_map": maps[1], "merged_map": maps[2]}

    def track_many(self, images, chunk: int = 32) -> np.ndarray:
        """Track a sequence of frames, reading the boxes back once per
        `chunk` frames (the JAX Tracker's scan chunk); a chunk ends early
        where the resolution changes, as there. On the graph path a chunk's
        frames go up in one pinned copy and the step graph is replayed once
        a frame. Returns (N, 5) [x, y, w, h, score] in frame order."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        outs, i = [], 0
        while i < len(images):
            hw = images[i].shape[:2]
            group = []
            for im in images[i:i + chunk]:
                if im.shape[:2] != hw:
                    break
                group.append(im)
            if self.graphs:
                packs = self._chunk_steps([im[None] for im in group])[:, 0]
            else:
                packs = torch.stack([self.step(self._frame(im)) for im in group])
            outs.append(packs.double().cpu().numpy())
            i += len(group)
        return np.concatenate(outs) if outs else np.zeros((0, 5))


def frame_cost(model: UVLTrack, nt: int) -> dict:
    """Operations and weight bytes of one tracked frame, from the shapes:
    the blocks (qkv, attention, projection, MLP; the fusion blocks with the
    nt text tokens), the patch embedding and the head's conv towers (3x3
    stages and the final 1x1), and the weights the step reads (blocks, patch
    embedding, towers) at their stored width, int8 payloads and scales
    included. kernel1_flops: the share of kernel #1 (LN + qkv + attention)."""
    bb, head = model.backbone, model.box_head
    c = bb.embed_dim
    n_vis = 1 + bb.num_patches_z + bb.num_patches_x
    flops, kernel1 = 0, 0
    for i in range(bb.depth):
        n = n_vis + nt if i in bb.fusion_layers else n_vis
        qkv_attn = 6 * n * c * c + 4 * n * n * c
        kernel1 += qkv_attn
        flops += qkv_attn + 18 * n * c * c  # + proj (2NC^2) + MLP (16NC^2)
    flops += 2 * (bb.num_patches_z + bb.num_patches_x) * c * 3 * 16 * 16
    cells = head.feat_sz ** 2
    towers = [head.conv_cls, head.conv_offset, head.conv_bbox, head.conv_bbox_grounding]
    for tower in towers:
        for m in tower.modules():
            if isinstance(m, torch.nn.Conv2d):
                kh, kw = m.kernel_size
                flops += 2 * cells * m.in_channels * kh * kw * m.out_channels
    used = [bb.vit.blocks, bb.vit.patch_embed, *towers]
    wbytes = sum(p.numel() * p.element_size() for mod in used for p in mod.parameters())
    # int8 payloads and their scales (weight-only int8) are buffers
    wbytes += sum(b.numel() * b.element_size() for mod in used
                  for name, b in mod.named_buffers() if name.endswith(("weight_q", "weight_scale")))
    return {"flops": flops, "kernel1_flops": kernel1, "weight_bytes": wbytes}


def grounding_inputs(frame: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                     template_size: int, search_size: int) -> tuple:
    """UVLTrack.forward's arguments for grounding one (H, W, 3) device frame
    at batch 1 (JitTracker.grounding_fn): a zero template, the frame
    letterboxed to the search size, the (1, Nt) tokenized sentence,
    all-false template/context masks and flag 1."""
    ts, ss, dev = template_size, search_size, frame.device
    template = torch.zeros((1, ts, ts, 3), dtype=torch.float32, device=dev)
    tmask = torch.zeros((1, (ts // 16) ** 2), dtype=torch.bool, device=dev)
    cmask = torch.zeros((1, (ss // 16) ** 2), dtype=torch.bool, device=dev)
    flag = torch.ones((1,), dtype=torch.int32, device=dev)
    return template, grounding_letterbox(frame, ss), text_ids, text_mask, tmask, cmask, flag


def letterbox_box_to_image(pred: np.ndarray, hw) -> list:
    """A grounding box, cxcywh normalized to the letterbox side, in image
    xywh: scaled by the longer side, shifted back by the letterbox margin."""
    cx, cy, w, h = pred * max(hw)
    x, y = cx - w / 2, cy - h / 2
    ih, iw = hw
    x += min(0.0, (iw - ih) / 2)
    y += min(0.0, (ih - iw) / 2)
    return [float(x), float(y), float(w), float(h)]
