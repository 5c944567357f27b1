"""Plain float32 reference of UVLTrack's tracking step, written from the
model's description (arXiv:2401.11228; the reference code's lib/models and
lib/test/tracker/uvltrack.py) in plain PyTorch: no kernel, no cache, no
batching trick, and nothing of the measured package or of JAX.

The weights are a dict name -> tensor, named as the reference's state dict
(`param_specs` lists every name and shape a configuration has). Every
function takes the weights and the `dims` of a configuration file and
computes in float32; `exact_fp32()` turns TF32 off around the caller's
block, and puts the flags back after it.

What the tracking step computes (per stream row):
- the search crop: a square of side ceil(sqrt(w h) * factor) around the
  previous box, its corner rounded half to even, resized bilinearly
  (cv2.INTER_LINEAR: half-pixel centres, zero outside the image) and
  ImageNet-normalized;
- the backbone: 16x16 patches of template and search with position
  embeddings and a CLS token, pre-LN ViT blocks (key bias -1e10 at masked
  keys), at the fusion layers one joint attention over [image | text]
  tokens with the modality embeddings added; the text features are BERT's
  embeddings and its first min(fusion) post-LN layers (key bias -10000 at
  padding);
- the head: contrastive scores of the search tokens against the prompt,
  four conv towers (3x3 conv, BatchNorm on running statistics, ReLU, x4,
  then a 1x1 conv), sigmoids, the size map chosen by the flag;
- the decode: cls x Hann x contrastive score, its first maximum, the box of
  that cell mapped back into the image and clipped with a 10 px margin;
- the prompter (initialize and re-mine): target, distractor and background
  tokens from the template and context features, split at the
  background's 0.25 probability mass, an MLP with a residual.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TOWERS = ("conv_cls", "conv_offset", "conv_bbox", "conv_bbox_grounding")
TOWER_OUT = {"conv_cls": 1, "conv_offset": 2, "conv_bbox": 2, "conv_bbox_grounding": 2}


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions inside the block only."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- weights
def param_specs(d: dict) -> list:
    """[(name, shape, kind)] of every tensor of a configuration, in a fixed
    order. kind says how the benchmark draws it (weights.py)."""
    c, cb = d["embed_dim"], d["bert"]["hidden"]
    nz = (d["template_size"] // d["patch"]) ** 2
    nx = (d["search_size"] // d["patch"]) ** 2
    p = d["patch"]
    specs = [("backbone.logit_scale", (), "logit"),
             ("backbone.vit.cls_token", (1, 1, c), "token"),
             ("backbone.vit.pos_embed_z", (1, nz, c), "token"),
             ("backbone.vit.pos_embed_x", (1, nx, c), "token"),
             ("backbone.vit.modal_embed", (2, c), "token"),
             ("backbone.vit.patch_embed.proj.weight", (c, 3, p, p), "conv"),
             ("backbone.vit.patch_embed.proj.bias", (c,), "bias")]
    hid = int(c * d["mlp_ratio"])
    for i in range(d["depth"]):
        b = f"backbone.vit.blocks.{i}."
        specs += [(b + "norm1.weight", (c,), "norm"), (b + "norm1.bias", (c,), "bias"),
                  (b + "attn.qkv.weight", (3 * c, c), "linear"), (b + "attn.qkv.bias", (3 * c,), "bias"),
                  (b + "attn.proj.weight", (c, c), "linear"), (b + "attn.proj.bias", (c,), "bias"),
                  (b + "norm2.weight", (c,), "norm"), (b + "norm2.bias", (c,), "bias"),
                  (b + "mlp.fc1.weight", (hid, c), "linear"), (b + "mlp.fc1.bias", (hid,), "bias"),
                  (b + "mlp.fc2.weight", (c, hid), "linear"), (b + "mlp.fc2.bias", (c,), "bias")]
    bt = d["bert"]
    e = "backbone.bert.embeddings."
    specs += [(e + "word_embeddings.weight", (bt["vocab"], cb), "token"),
              (e + "position_embeddings.weight", (bt["max_position"], cb), "token"),
              (e + "token_type_embeddings.weight", (bt["type_vocab"], cb), "token"),
              (e + "LayerNorm.weight", (cb,), "norm"), (e + "LayerNorm.bias", (cb,), "bias")]
    for j in range(min(d["fusion_layers"])):
        b = f"backbone.bert.encoder.layer.{j}."
        for lin in ("attention.self.query", "attention.self.key", "attention.self.value",
                    "attention.output.dense"):
            specs += [(b + lin + ".weight", (cb, cb), "linear"), (b + lin + ".bias", (cb,), "bias")]
        specs += [(b + "attention.output.LayerNorm.weight", (cb,), "norm"),
                  (b + "attention.output.LayerNorm.bias", (cb,), "bias"),
                  (b + "intermediate.dense.weight", (bt["intermediate"], cb), "linear"),
                  (b + "intermediate.dense.bias", (bt["intermediate"],), "bias"),
                  (b + "output.dense.weight", (cb, bt["intermediate"]), "linear"),
                  (b + "output.dense.bias", (cb,), "bias"),
                  (b + "output.LayerNorm.weight", (cb,), "norm"),
                  (b + "output.LayerNorm.bias", (cb,), "bias")]
    if cb != c:
        specs += [("backbone.text_proj.weight", (c, cb), "linear"),
                  ("backbone.text_proj.bias", (c,), "bias")]
    specs.append(("box_head.logit_scale", (), "logit"))
    ch = d["head_dim"]
    chans = [c, ch, ch // 2, ch // 4, ch // 8]
    for t in TOWERS:
        for s in range(4):
            b = f"box_head.{t}.{s}."
            specs += [(b + "0.weight", (chans[s + 1], chans[s], 3, 3), "conv"),
                      (b + "0.bias", (chans[s + 1],), "bias"),
                      (b + "1.weight", (chans[s + 1],), "norm"), (b + "1.bias", (chans[s + 1],), "bias"),
                      (b + "1.running_mean", (chans[s + 1],), "bias"),
                      (b + "1.running_var", (chans[s + 1],), "var"),
                      (b + "1.num_batches_tracked", (), "count")]
        specs += [(f"box_head.{t}.4.weight", (TOWER_OUT[t], chans[4], 1, 1), "conv"),
                  (f"box_head.{t}.4.bias", (TOWER_OUT[t],), "bias")]
    specs += [("box_head.prompter.logit_scale", (), "logit"),
              ("box_head.prompter.query_embed.weight", (3, c), "query"),
              ("box_head.prompter.mlp.fc1.weight", (hid, c), "linear"),
              ("box_head.prompter.mlp.fc1.bias", (hid,), "bias"),
              ("box_head.prompter.mlp.fc2.weight", (c, hid), "linear"),
              ("box_head.prompter.mlp.fc2.bias", (c,), "bias")]
    return specs


# ---------------------------------------------------------------- geometry
def crop_params(box, factor: float, out_sz: int):
    x, y, w, h = box.unbind(-1)
    crop = torch.ceil(torch.sqrt(w * h) * factor).clamp_min(1.0)
    x1 = torch.floor(torch.round(x + 0.5 * w - crop * 0.5)).to(torch.int32)
    y1 = torch.floor(torch.round(y + 0.5 * h - crop * 0.5)).to(torch.int32)
    return x1, y1, crop.to(torch.int32), out_sz / crop


def _taps(out_sz: int, crop, offset, limit: int):
    j = torch.arange(out_sz, dtype=torch.float32, device=crop.device)
    crop, offset = crop[:, None], offset[:, None]
    s = (j + 0.5) * (crop.float() / out_sz) - 0.5
    s = torch.minimum(s.clamp_min(0.0), crop.float() - 1.0)
    c0 = torch.floor(s)
    w1 = s - c0
    c0 = c0.to(torch.int32)
    c1 = torch.minimum(c0 + 1, crop - 1)
    i0, i1 = offset + c0, offset + c1
    # the reference pads the far side by max(x2 - W + 1, 0): the last image
    # row or column inside a spilling crop reads zero as well
    upper = torch.clamp_max(offset + crop, limit - 1)
    v0 = ((i0 >= 0) & (i0 < upper)).float()
    v1 = ((i1 >= 0) & (i1 < upper)).float()
    return i0.clamp(0, limit - 1).long(), i1.clamp(0, limit - 1).long(), (1 - w1) * v0, w1 * v1


def crop_search(frames, boxes, factor: float, out_sz: int):
    """frames (S, H, W, 3) uint8, boxes (S, 4) xywh -> ((S, out, out, 3)
    normalized crops, (S,) resize factors)."""
    x1, y1, crop, rf = crop_params(boxes, factor, out_sz)
    h, w = frames.shape[1], frames.shape[2]
    ry0, ry1, wy0, wy1 = _taps(out_sz, crop, y1, h)
    rx0, rx1, wx0, wx1 = _taps(out_sz, crop, x1, w)
    b = torch.arange(frames.shape[0], device=frames.device)[:, None]
    rows = frames[b, ry0].float() * wy0[..., None, None] + frames[b, ry1].float() * wy1[..., None, None]
    b3 = b[:, :, None]
    r = torch.arange(out_sz, device=frames.device)[None, :, None]
    img = (rows[b3, r, rx0[:, None, :]] * wx0[:, None, :, None]
           + rows[b3, r, rx1[:, None, :]] * wx1[:, None, :, None])
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    return (img / 255.0 - mean) / std, rf


def crop_box_normalized(box, factor: float):
    w, h = box[..., 2], box[..., 3]
    crop = torch.ceil(torch.sqrt(w * h) * factor)
    return torch.stack([0.5 - w / crop / 2, 0.5 - h / crop / 2, w / crop, h / crop], -1)


def anno2mask(box_xywh, size: int):
    """(S, size*size) bool: cells whose centre lies strictly inside the box
    (normalized xywh), and the cell holding the box centre."""
    x1, y1 = box_xywh[:, 0] * size, box_xywh[:, 1] * size
    x2, y2 = (box_xywh[:, 0] + box_xywh[:, 2]) * size, (box_xywh[:, 1] + box_xywh[:, 3]) * size
    c = torch.arange(size, dtype=box_xywh.dtype, device=box_xywh.device) + 0.5
    xin = (c[None] > x1[:, None]) & (c[None] < x2[:, None])
    yin = (c[None] > y1[:, None]) & (c[None] < y2[:, None])
    mask = yin[:, :, None] & xin[:, None, :]
    cx = torch.floor((x1 + x2) / 2).to(torch.int32).clamp(0, size - 1)
    cy = torch.floor((y1 + y2) / 2).to(torch.int32).clamp(0, size - 1)
    idx = torch.arange(size, device=box_xywh.device)
    ctr = (idx[None, :, None] == cy[:, None, None]) & (idx[None, None, :] == cx[:, None, None])
    return (mask | ctr).reshape(box_xywh.shape[0], size * size)


def hann2d_flat(sz: int, device):
    n = torch.arange(sz, dtype=torch.float32, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (sz - 1))
    return torch.outer(w, w).reshape(-1)


def map_back_and_clip(box_net, prev, rf, sz: int, h: int, w: int, margin: int = 10):
    """A crop-normalized cxcywh box -> image xywh, clipped."""
    pred = box_net * sz / rf[:, None]
    half = 0.5 * sz / rf
    cx = pred[:, 0] + prev[:, 0] + 0.5 * prev[:, 2] - half
    cy = pred[:, 1] + prev[:, 1] + 0.5 * prev[:, 3] - half
    bw, bh = pred[:, 2], pred[:, 3]
    x1, y1 = cx - 0.5 * bw, cy - 0.5 * bh
    x2, y2 = x1 + bw, y1 + bh
    x1, x2 = x1.clamp(0, w - margin), x2.clamp(margin, w)
    y1, y2 = y1.clamp(0, h - margin), y2.clamp(margin, h)
    return torch.stack([x1, y1, (x2 - x1).clamp_min(margin), (y2 - y1).clamp_min(margin)], -1)


class Fp8Weights(dict):
    """The weights of the precision control: every operand of a product
    (Linear inputs and weights, attention q, k, probabilities and v, conv
    inputs and weights) rounded to float8 e4m3 with a per-tensor scale
    (amax / 448) before an fp32 product, as an fp8 GEMM computes."""

    @staticmethod
    def round(t):
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _r(W, t):
    return W.round(t) if isinstance(W, Fp8Weights) else t


# ---------------------------------------------------------------- layers
def _lin(W, name, x):
    return _r(W, x) @ _r(W, W[name + ".weight"]).t() + W[name + ".bias"]


def _conv(W, name, x, **kw):
    return F.conv2d(_r(W, x), _r(W, W[name + ".weight"]), W[name + ".bias"], **kw)


def _attend(W, q, k, v, key_bias):
    """q, k, v (B, H, N, D); key_bias (B, N) additive."""
    logits = _r(W, q) @ _r(W, k).transpose(-1, -2) * q.shape[-1] ** -0.5 + key_bias[:, None, None, :]
    return _r(W, torch.softmax(logits, -1)) @ _r(W, v)


def vit_block(W, i: int, x, key_masked, heads: int):
    b, n, c = x.shape
    p = f"backbone.vit.blocks.{i}."
    h = F.layer_norm(x, (c,), W[p + "norm1.weight"], W[p + "norm1.bias"], 1e-6)
    q, k, v = _lin(W, p + "attn.qkv", h).reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    bias = torch.where(key_masked, -1e10, 0.0)
    a = _attend(W, q, k, v, bias).transpose(1, 2).reshape(b, n, c)
    x = x + _lin(W, p + "attn.proj", a)
    h = F.layer_norm(x, (c,), W[p + "norm2.weight"], W[p + "norm2.bias"], 1e-6)
    return x + _lin(W, p + "mlp.fc2", F.gelu(_lin(W, p + "mlp.fc1", h)))


def bert_text(W, d: dict, ids, mask):
    """Embeddings and the pre-fusion BERT layers: (S, Nt, C) text features."""
    bt, cb = d["bert"], d["bert"]["hidden"]
    e = "backbone.bert.embeddings."
    n = ids.shape[1]
    x = (W[e + "word_embeddings.weight"][ids.long()] + W[e + "position_embeddings.weight"][:n][None]
         + W[e + "token_type_embeddings.weight"][0])
    x = F.layer_norm(x, (cb,), W[e + "LayerNorm.weight"], W[e + "LayerNorm.bias"], 1e-12)
    if cb != d["embed_dim"]:
        x = _lin(W, "backbone.text_proj", x)
        cb = d["embed_dim"]
    bias = (1.0 - mask.float()) * -10000.0
    heads = bt["heads"]
    for j in range(min(d["fusion_layers"])):
        p = f"backbone.bert.encoder.layer.{j}."
        b_, n_, c_ = x.shape

        def split(t):
            return t.reshape(b_, n_, heads, c_ // heads).transpose(1, 2)

        q, k, v = (split(_lin(W, p + "attention.self." + m, x)) for m in ("query", "key", "value"))
        ctx = _attend(W, q, k, v, bias).transpose(1, 2).reshape(b_, n_, c_)
        x = F.layer_norm(_lin(W, p + "attention.output.dense", ctx) + x, (c_,),
                         W[p + "attention.output.LayerNorm.weight"],
                         W[p + "attention.output.LayerNorm.bias"], 1e-12)
        y = F.gelu(_lin(W, p + "intermediate.dense", x))
        x = F.layer_norm(_lin(W, p + "output.dense", y) + x, (c_,), W[p + "output.LayerNorm.weight"],
                         W[p + "output.LayerNorm.bias"], 1e-12)
    return x


def _patches(W, img):
    name = "backbone.vit.patch_embed.proj"
    x = _conv(W, name, img.permute(0, 3, 1, 2), stride=W[name + ".weight"].shape[-1])
    return x.flatten(2).transpose(1, 2)


def select_by_flag(group, flag):
    """group (S, 3, ...), flag (S,) in {0, 1, 2} -> (S, ...)."""
    return group[torch.arange(group.shape[0], device=group.device), flag.long()]


def backbone(W, d: dict, template, search, txt, text_mask, flag):
    """The ViT with text fusion over precomputed text features."""
    c = d["embed_dim"]
    nz = W["backbone.vit.pos_embed_z"].shape[1]
    z = _patches(W, template) + W["backbone.vit.pos_embed_z"]
    x = _patches(W, search) + W["backbone.vit.pos_embed_x"]
    s = z.shape[0]
    img = torch.cat([W["backbone.vit.cls_token"].expand(s, 1, c), z, x], 1)
    nl = (flag == 1)[:, None]
    visual = torch.cat([nl, nl.expand(s, nz), torch.zeros_like(x[..., 0], dtype=torch.bool)], 1)
    joint = torch.cat([visual, (flag == 0)[:, None] | (text_mask == 0)], 1)
    me = W["backbone.vit.modal_embed"]
    fusion = set(d["fusion_layers"])
    for i in range(d["depth"]):
        if i in fusion:
            e = vit_block(W, i, torch.cat([img + me[0], txt + me[1]], 1), joint, d["heads"])
            img, txt = e[:, :img.shape[1]], e[:, img.shape[1]:]
        else:
            img = vit_block(W, i, img, visual, d["heads"])
    return {"search": img[:, 1 + nz:], "template": img[:, 1:1 + nz], "vis_token": img[:, :1],
            "txt_token": txt[:, :1], "flag": flag}


def l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _token(f):
    vis, txt = f["vis_token"], f["txt_token"]
    return select_by_flag(torch.cat([vis, txt, (vis + txt) / 2], 1), f["flag"])


def _tower(W, name: str, x):
    for s in range(4):
        p = f"box_head.{name}.{s}."
        x = _conv(W, p + "0", x, padding=1)
        inv = torch.rsqrt(W[p + "1.running_var"] + 1e-5) * W[p + "1.weight"]
        x = torch.relu((x - W[p + "1.running_mean"][None, :, None, None]) * inv[None, :, None, None]
                       + W[p + "1.bias"][None, :, None, None])
    return _conv(W, f"box_head.{name}.4", x)


def head(W, d: dict, f, prompt):
    """The test path of the head with a prompt: (cls (S, s), cont (S, s) the
    softmaxed target column, bbox_map (S, s, 4) crop-normalized cxcywh)."""
    search, flag = f["search"], f["flag"]
    s_, n, c = search.shape
    fsz = int(round(n ** 0.5))
    raw = torch.exp(W["box_head.logit_scale"]) * torch.einsum("bnc,bpc->bnp", l2n(search), l2n(prompt))
    target, rest = raw[:, :, :1], raw[:, :, 1:]
    rest = torch.cat([rest, torch.zeros_like(target)], -1)
    cont = torch.softmax(torch.cat([target, rest.amax(-1, keepdim=True), torch.zeros_like(target)], -1),
                         -1)[:, :, 0]
    x2d = search.reshape(s_, fsz, fsz, c).permute(0, 3, 1, 2)
    cls = torch.sigmoid(_tower(W, "conv_cls", x2d)).reshape(s_, n)
    offset = torch.sigmoid(_tower(W, "conv_offset", x2d)).reshape(s_, 2, n)
    size_tr = torch.sigmoid(_tower(W, "conv_bbox", x2d)).reshape(s_, 2, n)
    size_gr = torch.sigmoid(_tower(W, "conv_bbox_grounding", x2d)).reshape(s_, 2, n)
    size = select_by_flag(torch.stack([size_tr, size_gr, size_tr], 1), flag)
    cols = torch.arange(fsz, dtype=torch.float32, device=search.device).repeat(fsz)
    rows = torch.arange(fsz, dtype=torch.float32, device=search.device).repeat_interleave(fsz)
    ctr = (torch.stack([cols, rows])[None] + offset) / fsz
    return cls, cont, torch.cat([ctr, size], 1).transpose(1, 2)


def _divide_background(score):
    values = torch.sort(score, -1).values
    below = torch.cumsum(values, -1) < 0.25
    threshold = torch.where(below, torch.ones_like(values), values).amin(-1, keepdim=True)
    return score >= threshold


def prompter(W, d: dict, f, template_mask, context_mask):
    """The three prompt tokens (S, 3, C) from template and context features."""
    tem, ctx, flag = f["template"], f["search"], f["flag"]
    s_, _, c = ctx.shape
    cls_token = _token(f)
    q = W["box_head.prompter.query_embed.weight"][None].expand(s_, 3, c)
    src_q = torch.cat([q[:, :1] + cls_token[:, None], q[:, 1:]], 1)
    tgt = torch.cat([tem, ctx], 1)
    mask = torch.cat([template_mask, context_mask], 1)[:, None, :]
    sim = torch.einsum("bc,bnc->bn", l2n(cls_token), l2n(tgt))[:, None, :]
    sim = sim * torch.exp(W["box_head.prompter.logit_scale"])
    neg = torch.tensor(-1e20, device=ctx.device)
    tgt_token = torch.softmax(torch.where(mask, sim, neg), -1) @ tgt
    bgd_logit = torch.where(mask, neg, sim)
    dis_mask = _divide_background(torch.softmax(bgd_logit, -1))
    bgd_token = torch.softmax(torch.where(dis_mask, neg, bgd_logit), -1) @ tgt
    dis_token = torch.softmax(torch.where(dis_mask, bgd_logit, neg), -1) @ tgt
    src = torch.cat([tgt_token, dis_token, bgd_token], 1) + src_q
    src = _lin(W, "box_head.prompter.mlp.fc2", F.gelu(_lin(W, "box_head.prompter.mlp.fc1", src))) + src
    return select_by_flag(torch.stack([src, src_q, src], 1), flag)


# ---------------------------------------------------------------- tracker
class Sequence:
    """S streams' per-sequence constants, worked out from the raw inputs:
    first frames (S, H, W, 3) uint8, boxes (S, 4) xywh, text ids and masks
    (S, Nt) and flags (S,)."""

    def __init__(self, W, d: dict, frames, boxes, ids, mask, flags):
        self.W, self.d = W, d
        ts, ss = d["template_size"], d["search_size"]
        self.text_mask, self.flags = mask, flags
        self.template, _ = crop_search(frames, boxes, d["template_factor"], ts)
        self.template_mask = anno2mask(crop_box_normalized(boxes, d["template_factor"]), ts // d["patch"])
        context, _ = crop_search(frames, boxes, d["search_factor"], ss)
        context_mask = anno2mask(crop_box_normalized(boxes, d["search_factor"]), ss // d["patch"])
        self.txt = bert_text(W, d, ids, mask)
        f = backbone(W, d, self.template, context, self.txt, mask, flags)
        self.prompt = prompter(W, d, f, self.template_mask, context_mask)
        self.window = hann2d_flat(ss // d["patch"], frames.device)

    def step(self, frames, prev_box, prompt):
        """One step from a state (previous boxes, prompts): the maps, the box
        at every cell and the backbone's features."""
        d, ss = self.d, self.d["search_size"]
        search, rf = crop_search(frames, prev_box, d["search_factor"], ss)
        f = backbone(self.W, d, self.template, search, self.txt, self.text_mask, self.flags)
        cls, cont, bbox_map = head(self.W, d, f, prompt)
        h, w = frames.shape[1], frames.shape[2]
        n = bbox_map.shape[1]
        boxes = map_back_and_clip(bbox_map.reshape(-1, 4), prev_box.repeat_interleave(n, 0),
                                  rf.repeat_interleave(n, 0), ss, h, w).reshape(-1, n, 4)
        crop = torch.ceil(torch.sqrt(prev_box[:, 2] * prev_box[:, 3]) * d["search_factor"])
        return {"cls": cls, "cont": cont, "merged": cls * self.window * cont, "boxes": boxes,
                "box_net": bbox_map, "crop": crop.clamp_min(1.0), **f}

    def remine(self, best):
        """The prompt re-mined from the best frame's features: `best` holds
        search, template, vis_token, txt_token (S, ., C) and box_net (S, 4)
        crop-normalized cxcywh."""
        b = best["box_net"]
        xywh = torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2, b[:, 2], b[:, 3]], -1)
        ctx_mask = anno2mask(xywh, self.d["search_size"] // self.d["patch"])
        f = {k: best[k] for k in ("search", "template", "vis_token", "txt_token")}
        f["flag"] = self.flags
        return prompter(self.W, self.d, f, self.template_mask, ctx_mask)


def encode(words: list, vocab: dict, nt: int):
    """[CLS] words [SEP], zero-padded to nt: (ids, mask) lists. The words are
    whole vocabulary entries (the traffic draws them from its vocab)."""
    ids = [vocab["[CLS]"]] + [vocab[w] for w in words][:nt - 2] + [vocab["[SEP]"]]
    return ids + [0] * (nt - len(ids)), [1] * len(ids) + [0] * (nt - len(ids))
