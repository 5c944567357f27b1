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
contrastive score, take the argmax box, map it back and clip it. Every
UPDATE_INTERVAL frames the prompt is re-mined from the best-scoring frame's
cached features if that frame's score beat TEST.THRESHOLD.

The state stays on the device between frames. frame_id is known on the
host, so the only host read inside the step is max_score on refresh frames:
at most one synchronization every UPDATE_INTERVAL frames, deciding what the
JAX step's lax.cond decides. `track` reads the packed (box, score) back each
frame; `track_many` reads all frames once at the end.
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
class TrackerState:
    box: torch.Tensor            # (4,) xywh, image coords
    prompt: torch.Tensor         # (1, 3, C)
    max_score: torch.Tensor      # ()
    frame_id: int                # host-side frame counter
    best_box_net: torch.Tensor   # (4,) cxcywh normalized, best frame's net box
    best_search: torch.Tensor    # (1, s, C) cached backbone features, fp32
    best_template: torch.Tensor  # (1, z, C)
    best_vis_token: torch.Tensor  # (1, 1, C)
    best_txt_token: torch.Tensor  # (1, 1, C)


class Tracker:
    """Reference-compatible API: initialize(image, info) / track(image).

    The model's weights are prepared in place by prepare_inference_model
    (bf16 per cfg.TPU.COMPUTE_DTYPE, int8 per cfg.TPU.WEIGHT_QUANT; a model
    prepared already is left as it is); images are (H, W, 3) uint8 numpy
    arrays."""

    def __init__(self, cfg, model: UVLTrack, tokenizer=None):
        self.cfg = cfg
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
        self.state: Optional[TrackerState] = None
        self.remines = 0  # prompt re-mines since initialize

    def _tokenize(self, language: Optional[str]):
        if language is None or self.tokenizer is None:
            ids = np.zeros((1, self.nt), np.int32)
            mask = np.zeros((1, self.nt), np.int32)
        else:
            i, m = self.tokenizer.encode_query(language, self.nt)
            ids = np.asarray(i, np.int32)[None]
            mask = np.asarray(m, np.int32)[None]
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _frame(self, image: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def grounding_inputs(self, frame: torch.Tensor) -> tuple:
        """UVLTrack.forward's arguments for grounding a (H, W, 3) device
        frame (JitTracker.grounding_fn): a zero template, the frame
        letterboxed to the search size, the tokenized sentence, all-false
        template/context masks and flag 1."""
        ts, ss = self.template_size, self.search_size
        template = torch.zeros((1, ts, ts, 3), dtype=torch.float32, device=self.device)
        tmask = torch.zeros((1, (ts // 16) ** 2), dtype=torch.bool, device=self.device)
        cmask = torch.zeros((1, (ss // 16) ** 2), dtype=torch.bool, device=self.device)
        flag = torch.ones((1,), dtype=torch.int32, device=self.device)
        return (template, grounding_letterbox(frame, ss), self.text_ids, self.text_mask,
                tmask, cmask, flag)

    @torch.no_grad()
    def grounding_forward(self, frame: torch.Tensor) -> dict:
        """The grounding forward's output dict; pred_boxes[0, 0] is the
        grounding box, cxcywh normalized to the letterbox side."""
        return self.model(*self.grounding_inputs(frame))

    def _grounding(self, image: np.ndarray):
        """The grounding box in image xywh (Tracker._grounding): scaled by the
        longer side, shifted back by the letterbox margin."""
        pred = self.grounding_forward(self._frame(image))["pred_boxes"][0, 0]
        cx, cy, w, h = pred.float().cpu().numpy() * max(image.shape[:2])
        x, y = cx - w / 2, cy - h / 2
        ih, iw = image.shape[:2]
        x += min(0.0, (iw - ih) / 2)
        y += min(0.0, (ih - iw) / 2)
        return [float(x), float(y), float(w), float(h)]

    @torch.no_grad()
    def initialize(self, image: np.ndarray, info: dict):
        mode = self.cfg.TEST.MODE
        with_text = mode in ("NL", "NLBBOX")  # any other mode tracks as BBOX
        self.text_ids, self.text_mask = self._tokenize(info.get("language") if with_text
                                                       else None)
        self.flag = torch.full((1,), 2 if with_text else 0, dtype=torch.int32,
                               device=self.device)
        if mode == "NL":
            init_bbox = self._grounding(image)
        else:
            init_bbox = [float(v) for v in info["init_bbox"]]
        frame = self._frame(image)
        box = torch.tensor(init_bbox, dtype=torch.float32, device=self.device)
        ts, ss = self.template_size, self.search_size
        template, _ = sample_target_device(frame, box, self.template_factor, ts)
        tbox = crop_box_normalized(box, self.template_factor)[None]
        self.template_mask = anno2mask(tbox, ts // 16)
        context, _ = sample_target_device(frame, box, self.search_factor, ss)
        cbox = crop_box_normalized(box, self.search_factor)[None]
        context_mask = anno2mask(cbox, ss // 16)
        prompt = self.model.forward_prompt_init(
            template, context, self.text_ids, self.text_mask,
            self.template_mask, context_mask, self.flag)
        self.template = template
        # per-sequence constant consumed by the step: the cached pre-fusion
        # text features, or the raw ids under TPU.CACHE_TEXT=False
        self.txt = (self.model.encode_text(self.text_ids, self.text_mask)
                    if self.cache_text else self.text_ids)
        s, z, c = (ss // 16) ** 2, (ts // 16) ** 2, self.embed_dim

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self.state = TrackerState(
            box=box, prompt=prompt, max_score=zeros(), frame_id=0,
            best_box_net=zeros(4), best_search=zeros(1, s, c),
            best_template=zeros(1, z, c), best_vis_token=zeros(1, 1, c),
            best_txt_token=zeros(1, 1, c))
        self.remines = 0
        return {"target_bbox": init_bbox}

    @torch.no_grad()
    def step(self, frame: torch.Tensor, debug: bool = False):
        """Advance one frame (a (H, W, 3) uint8 device tensor); return the
        packed [x, y, w, h, score] device tensor without synchronizing, and
        with debug=True also the (3, fsz*fsz) [cls, cont, merged] response
        maps (the reference's debug hook, lib/test/tracker/uvltrack.py:155-157)."""
        st, sz = self.state, self.search_size
        h, w = frame.shape[0], frame.shape[1]
        search, resize_factor = sample_target_device(
            frame, st.box, self.search_factor, sz)
        test = self.model.forward_test_cached if self.cache_text else self.model.forward_test
        out = test(self.template, search, self.txt, self.text_mask, st.prompt, self.flag)
        cls = out["cls_score_test"].reshape(-1).float()
        if self.has_cont:
            cont = torch.softmax(out["cont_score"].float(), dim=-1)[0, :, 0]
        else:
            cont = torch.ones_like(cls)
        merged = cls * self.window * cont
        k = torch.argmax(merged)  # first max, row-major cells
        box_net = out["bbox_map"][0, k]  # cxcywh normalized
        score = (cls * cont)[k]
        pred_crop = box_net * sz / resize_factor
        new_box = clip_box_xywh(map_box_back(pred_crop, st.box, resize_factor, sz),
                                h, w, margin=10)

        is_best = score > st.max_score

        def pick(new, old):
            return torch.where(is_best, new.float(), old)

        best_box_net = pick(box_net, st.best_box_net)
        best_search = pick(out["search"], st.best_search)
        best_template = pick(out["template"], st.best_template)
        best_vis = pick(out["vis_token"], st.best_vis_token)
        best_txt = pick(out["txt_token"], st.best_txt_token)
        max_score = pick(score, st.max_score)
        frame_id = st.frame_id + 1
        prompt = st.prompt
        if (self.has_cont and self.update_interval > 0
                and frame_id % self.update_interval == 0
                and bool(max_score > self.threshold)):  # the one host read
            ctx_mask = anno2mask(box_cxcywh_to_xywh(best_box_net[None]), self.map_size)
            feats = {"search": best_search, "template": best_template,
                     "vis_token": best_vis, "txt_token": best_txt,
                     "flag": self.flag}
            prompt = self.model.forward_prompt(feats, self.template_mask, ctx_mask)
            max_score = torch.zeros_like(max_score)
            self.remines += 1
        self.state = TrackerState(
            box=new_box, prompt=prompt, max_score=max_score, frame_id=frame_id,
            best_box_net=best_box_net, best_search=best_search,
            best_template=best_template, best_vis_token=best_vis,
            best_txt_token=best_txt)
        packed = torch.cat([new_box, score[None]])
        if debug:
            return packed, torch.stack([cls, cont, merged])
        return packed

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

    def track_many(self, images) -> np.ndarray:
        """Track a sequence of frames; one host read at the end. Returns
        (N, 5) [x, y, w, h, score] in frame order."""
        packs = [self.step(self._frame(im)) for im in images]
        return torch.stack(packs).double().cpu().numpy()
