"""Stateful UVLTrack tracker with a device-resident per-frame step (port of
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
contrastive score, take the argmax box, map it back and clip it. The
step is LockstepTracker.step_rows over S streams, which BatchTracker
(track/batch.py) shares; Tracker runs it at S=1. Every
UPDATE_INTERVAL frames the prompt is re-mined from the best-scoring frame's
cached features if that frame's score beat TEST.THRESHOLD.

The state stays on the device between frames. frame_id is known on the
host, so the only host read inside the step is max_score on refresh frames:
at most one synchronization every UPDATE_INTERVAL frames, deciding what the
JAX step's lax.cond decides. `track` reads the packed (box, score) back each
frame; `track_many` once per chunk of frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.box_ops import box_cxcywh_to_xywh, clip_box_xywh
from ..core.geometry import anno2mask, crop_box_normalized, map_box_back
from ..core.hann import hanning2d_flat
from ..models.uvltrack import UVLTrack, prepare_inference_model
from .pipeline import grounding_letterbox, sample_target_device


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


class LockstepTracker:
    """What Tracker and BatchTracker share: the config, the prompt init, the
    grounding box and the step of S streams in lockstep (S=1 for Tracker).

    The model's weights are prepared in place by prepare_inference_model
    (bf16 per cfg.TPU.COMPUTE_DTYPE, int8 per cfg.TPU.WEIGHT_QUANT; a model
    prepared already is left as it is). A subclass's initialize sets
    text_ids, text_mask, flags, template, template_mask, txt and state."""

    def __init__(self, cfg, model: UVLTrack, num_streams: int, tokenizer=None):
        if num_streams < 1:
            raise ValueError(f"num_streams must be >= 1, got {num_streams}")
        self.cfg = cfg
        self.S = num_streams
        # TPU.CACHE_TEXT (default on): the step reads the pre-fusion text
        # features cached at initialize; off, it runs UVLTrack.forward_test on
        # the raw text ids every frame (BERT each frame, the JAX package's
        # debug path), as JitTracker's cache_text does
        self.cache_text = bool(cfg.TPU.CACHE_TEXT)
        self.model = prepare_inference_model(cfg, model)
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.nt = int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
        self.embed_dim = model.backbone.embed_dim
        self.search_size = int(cfg.TEST.SEARCH_SIZE)
        self.template_size = int(cfg.TEST.TEMPLATE_SIZE)
        self.search_factor = float(cfg.TEST.SEARCH_FACTOR)
        self.template_factor = float(cfg.TEST.TEMPLATE_FACTOR)
        self.map_size = self.search_size // 16
        self.update_interval = int(cfg.TEST.UPDATE_INTERVAL)
        self.threshold = float(cfg.TEST.THRESHOLD)
        self.has_cont = float(cfg.TRAIN.CONT_WEIGHT) > 0
        self.window = hanning2d_flat(self.map_size, self.device)
        self.state: Optional[BatchState] = None
        self._remines = torch.zeros((self.S,), dtype=torch.int32, device=self.device)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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

    @torch.no_grad()
    def step_rows(self, frames: torch.Tensor, always_remine: bool = False,
                  debug: bool = False):
        """Advance every active stream one frame (frames: (S, H, W, 3) uint8
        on the device); returns the (S, 5) [x, y, w, h, score] device tensor
        without reading it back, and with debug=True also the (S, 3,
        fsz*fsz) [cls, cont, merged] response maps (the reference's debug
        hook, lib/test/tracker/uvltrack.py:155-157).

        A frozen stream keeps its box and best features, and its frame_id
        does not advance. The re-mine's one host read, max_score >
        threshold, is made only on a step where some active stream is due;
        always_remine re-mines every step, where-selected, with no host
        read: the same boxes."""
        st, sz, S = self.state, self.search_size, self.S
        frame_id = st.frame_id + st.active
        remine = self.has_cont and self.update_interval > 0
        due = (frame_id % self.update_interval == 0) & st.active if remine else None
        # a host-to-device copy waits for the stream: made here, before the
        # forward, so none holds the host while the forward runs
        frozen = not st.active.all()
        active = self.to_device(st.active) if frozen else None
        due_dev = self.to_device(due) if remine and always_remine else None
        h, w = frames.shape[1], frames.shape[2]
        search, resize_factor = sample_target_device(frames, st.box, self.search_factor, sz)
        test = self.model.forward_test_cached if self.cache_text else self.model.forward_test
        out = test(self.template, search, self.txt, self.text_mask, st.prompt, self.flags)
        cls = out["cls_score_test"].reshape(S, -1).float()
        if self.has_cont:
            cont = torch.softmax(out["cont_score"].float(), dim=-1)[:, :, 0]
        else:
            cont = torch.ones_like(cls)
        merged = cls * self.window * cont
        k = torch.argmax(merged, dim=-1)  # first max of each row, row-major cells
        rows = torch.arange(S, device=self.device)
        box_net = out["bbox_map"][rows, k]  # (S, 4) cxcywh normalized
        score = (cls * cont)[rows, k]
        pred_crop = box_net * sz / resize_factor[:, None]
        new_box = clip_box_xywh(map_box_back(pred_crop, st.box, resize_factor, sz),
                                h, w, margin=10)
        is_best = score > st.max_score
        if frozen:
            new_box = torch.where(active[:, None], new_box, st.box)
            is_best &= active

        def pick(new, old):
            return torch.where(is_best.view((S,) + (1,) * (old.ndim - 1)), new.float(), old)

        best_box_net = pick(box_net, st.best_box_net)
        best_search = pick(out["search"], st.best_search)
        best_template = pick(out["template"], st.best_template)
        best_vis = pick(out["vis_token"], st.best_vis_token)
        best_txt = pick(out["txt_token"], st.best_txt_token)
        max_score = pick(score, st.max_score)
        prompt = st.prompt
        if remine:
            refresh = None
            if always_remine:
                refresh = due_dev & (max_score > self.threshold)
            elif due.any():  # the one host read
                due &= (max_score > self.threshold).cpu().numpy()
                refresh = self.to_device(due) if due.any() else None
            if refresh is not None:
                ctx_mask = anno2mask(box_cxcywh_to_xywh(best_box_net), self.map_size)
                feats = {"search": best_search, "template": best_template,
                         "vis_token": best_vis, "txt_token": best_txt, "flag": self.flags}
                new_prompt = self.model.forward_prompt(feats, self.template_mask, ctx_mask)
                prompt = torch.where(refresh[:, None, None], new_prompt.to(prompt.dtype), prompt)
                max_score = torch.where(refresh, torch.zeros_like(max_score), max_score)
                self._remines += refresh
        self.state = BatchState(
            box=new_box, prompt=prompt, max_score=max_score, frame_id=frame_id,
            active=st.active, best_box_net=best_box_net, best_search=best_search,
            best_template=best_template, best_vis_token=best_vis, best_txt_token=best_txt)
        packed = torch.cat([new_box, score[:, None]], dim=-1)
        if debug:
            return packed, torch.stack([cls, cont, merged], dim=1)
        return packed


class Tracker(LockstepTracker):
    """Reference-compatible API: initialize(image, info) / track(image) of
    one stream, stepped by the lockstep step at S=1. Images are (H, W, 3)
    uint8 numpy arrays."""

    def __init__(self, cfg, model: UVLTrack, tokenizer=None):
        super().__init__(cfg, model, 1, tokenizer)

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
        return {"target_bbox": init_bbox}

    def step(self, frame: torch.Tensor, debug: bool = False):
        """Advance one frame (a (H, W, 3) uint8 device tensor); return the
        packed [x, y, w, h, score] device tensor without synchronizing, and
        with debug=True also the (3, fsz*fsz) [cls, cont, merged] maps."""
        out = self.step_rows(frame[None], debug=debug)
        if debug:
            return out[0][0], out[1][0]
        return out[0]

    def track(self, image: np.ndarray, info: dict = None):
        packed = self.step(self._frame(image)).double().cpu().numpy()
        return {"target_bbox": packed[:4].tolist(), "score": float(packed[4])}

    def track_debug(self, image: np.ndarray, info: dict = None):
        """track() plus the (fsz, fsz) cls, contrastive and Hann-weighted
        merged maps; the box and score are track()'s bit for bit."""
        packed, maps = self.step(self._frame(image), debug=True)
        packed = packed.double().cpu().numpy()
        maps = maps.reshape(3, self.map_size, self.map_size).cpu().numpy()
        return {"target_bbox": packed[:4].tolist(), "score": float(packed[4]),
                "cls_map": maps[0], "cont_map": maps[1], "merged_map": maps[2]}

    def track_many(self, images, chunk: int = 32) -> np.ndarray:
        """Track a sequence of frames, reading the boxes back once per
        `chunk` frames (the JAX Tracker's scan chunk); a chunk ends early
        where the resolution changes, as there. Returns (N, 5)
        [x, y, w, h, score] in frame order."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        outs, i = [], 0
        while i < len(images):
            hw = images[i].shape[:2]
            packs = []
            for im in images[i:i + chunk]:
                if im.shape[:2] != hw:
                    break
                packs.append(self.step(self._frame(im)))
            outs.append(torch.stack(packs).double().cpu().numpy())
            i += len(packs)
        return np.concatenate(outs) if outs else np.zeros((0, 5))


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
