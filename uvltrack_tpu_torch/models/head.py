"""Modality-Adaptive Box Head (MABH) and the distribution-based prompter
(port of uvltrack_tpu/models/head.py; reference
lib/models/heads/modality_adaptive_box_head.py, lib/models/heads/utils.py).

The head: four 5-stage conv towers over the (feat_sz x feat_sz) search
map, a contrastive prompt-vs-search score, and the argmax decode of
convert2bbox. Given a prompt (the tracker's step) the score has the test
columns; without one (the grounding forward, UVLTrack.forward) the prompts
are mined from the template and the half-batch-rotated search features
first. The prompter mines target / distractor / background tokens from
template+context features, splitting the background at the 0.25 CDF
(divide_background); flag==1 uses the bare learned query embeddings.

Module names follow the reference (conv_cls.{0..3}.{0 conv, 1 bn}, conv_cls.4
the final 1x1 conv; prompter.query_embed / mlp / logit_scale). Convs run
NCHW inside the towers; the head's inputs and outputs keep the JAX package's
token layouts. A tower conv quantized by prepare_inference_model takes
QConv's int8 branch (`_conv`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry import rotate_half_batch
from ..ops.quant import is_quantized, weight_of
from ..parallel.dp import current as current_dp
from .bert import dense
from .mufe import l2_normalize, select_by_flag

NEG_INF = -1e20


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """flax Conv / QConv at the compute dtype. fp weight: operands and bias
    in dtype, the convolution and the bias add each round to it. int8
    weight (QConv :57-63): the dtype-cast input against the int8 payload
    with an fp32 result, then * scale + bias in fp32 and one rounding to
    dtype. The fp32 convolution runs on the upcast values, which are exact
    in fp32 (and in TF32, cuDNN's default on the card, for a bf16 input)."""
    w = weight_of(conv)
    if is_quantized(w):
        y = F.conv2d(x.to(dtype).float(), w.q.float(), padding=conv.padding)
        y = y * w.scale[None, :, None, None] + conv.bias.float()[None, :, None, None]
        return y.to(dtype)
    y = F.conv2d(x.to(dtype), w.to(dtype), padding=conv.padding)
    return y + conv.bias.to(dtype)[None, :, None, None]


class ConvBnRelu(nn.Sequential):
    """3x3 conv -> BatchNorm in fp32 (eps 1e-5) -> ReLU (uvltrack/utils.py:
    5-18). Inference normalizes by the running stats; train=True by the
    batch's, as flax's BatchNorm(momentum=0.9) does: fast variance
    E[x^2] - E[x]^2 clamped at 0 (biased), and the running stats updated in
    place to 0.9 * running + 0.1 * batch, the variance biased too
    (nn.BatchNorm2d's own training mode keeps the unbiased one, so it is
    not used). Under data parallelism (parallel/dp.py) the statistics are
    the global batch's, equal on every rank, and so are the running stats."""

    MOMENTUM = 0.9

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype):
        super().__init__(nn.Conv2d(c_in, c_out, 3, padding=1),
                         nn.BatchNorm2d(c_out, eps=1e-5), nn.ReLU())
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        conv, bn = self[0], self[1]
        y = _conv(x, conv, self.dtype).float()
        if train:
            dp = current_dp()
            if dp is None:
                mean = y.mean((0, 2, 3))
                var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            else:  # the global batch's, from every rank's sums (parallel/dp.py)
                c = y.shape[1]
                stats = dp.sum(torch.cat([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3)),
                                          y.new_full((1,), y.numel() // c)]))
                mean = stats[:c] / stats[2 * c]
                var = (stats[c:2 * c] / stats[2 * c] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
        else:
            mean, var = bn.running_mean.float(), bn.running_var.float()
        # flax BatchNorm: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
        y = (y - mean[None, :, None, None]) * mul[None, :, None, None]
        return torch.relu(y + bn.bias.float()[None, :, None, None])


class ConvTower(nn.Sequential):
    """conv(ch) -> conv(ch/2) -> conv(ch/4) -> conv(ch/8) -> 1x1 conv(out)."""

    def __init__(self, c_in: int, channel: int, out: int, dtype: torch.dtype):
        chans = [c_in, channel, channel // 2, channel // 4, channel // 8]
        super().__init__(*[ConvBnRelu(chans[i], chans[i + 1], dtype) for i in range(4)],
                         nn.Conv2d(chans[4], out, 1))
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        for stage in list(self)[:4]:
            x = stage(x, train)
        return _conv(x, self[4], self.dtype)


class PrompterMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return dense(F.gelu(dense(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class DistributionPrompter(nn.Module):
    """Generates 3 prompt tokens (target, distractor, background)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.query_embed = nn.Embedding(3, dim)
        self.mlp = PrompterMlp(dim, int(dim * mlp_ratio), dtype)
        self.logit_scale = nn.Parameter(torch.tensor(0.0))

    @staticmethod
    def divide_background(bgd_score: torch.Tensor) -> torch.Tensor:
        """Cells in the upper (1-0.25) probability mass are distractors: sort
        ascending, accumulate until the CDF reaches 0.25; the smallest score
        past that point is the threshold. bgd_score (B, 1, N)."""
        values = torch.sort(bgd_score, dim=-1).values
        below = torch.cumsum(values, dim=-1) < 0.25
        one = torch.ones((), dtype=values.dtype, device=values.device)
        threshold = torch.where(below, one, values).amin(-1, keepdim=True)
        return bgd_score >= threshold

    def distribute_attn(self, tgt, sim_logit, tgt_mask):
        """tgt (B,N,C); sim_logit (B,1,N); tgt_mask (B,1,N) True=target cell."""
        sim32 = sim_logit.float()
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=sim32.device)
        tgt_score = torch.softmax(torch.where(tgt_mask, sim32, neg), dim=-1)
        tgt_token = torch.einsum("bqn,bnc->bqc", tgt_score.to(tgt.dtype), tgt)
        bgd_logit = torch.where(tgt_mask, neg, sim32)
        bgd_score = torch.softmax(bgd_logit, dim=-1)
        dis_mask = self.divide_background(bgd_score)
        pure_bgd = torch.softmax(torch.where(dis_mask, neg, bgd_logit), dim=-1)
        dis = torch.softmax(torch.where(dis_mask, bgd_logit, neg), dim=-1)
        bgd_token = torch.einsum("bqn,bnc->bqc", pure_bgd.to(tgt.dtype), tgt)
        dis_token = torch.einsum("bqn,bnc->bqc", dis.to(tgt.dtype), tgt)
        return tgt_token, bgd_token, dis_token

    def forward(self, tem, tem_mask, ctx, ctx_mask, cls_token, flag):
        """tem (B,Nz,C), ctx (B,Nx,C), masks (B,N*) bool, cls_token (B,C),
        flag (B,) -> prompts (B, 3, C)."""
        b, dt = ctx.shape[0], self.dtype
        src_q = self.query_embed.weight.to(dt)[None].expand(b, 3, self.dim).clone()
        src_q[:, 0] = src_q[:, 0] + cls_token.to(dt)
        tgt = torch.cat([tem, ctx], dim=1)
        tgt_mask = torch.cat([tem_mask, ctx_mask], dim=1)[:, None, :]
        sim = torch.einsum("bc,bnc->bn", l2_normalize(cls_token), l2_normalize(tgt))
        sim = (sim * torch.exp(self.logit_scale.float()))[:, None, :]
        tgt_token, bgd_token, dis_token = self.distribute_attn(tgt, sim, tgt_mask)
        src = torch.cat([tgt_token, dis_token, bgd_token], dim=1) + src_q
        src = self.mlp(src) + src
        # switcher: flag==1 (grounding) falls back to the bare query embeds
        group = torch.stack([src, src_q.to(src.dtype), src], dim=1)  # (B, 3, 3, C)
        return select_by_flag(group, flag)


class MABH(nn.Module):
    """Modality-adaptive box head over the (feat_sz x feat_sz) search map."""

    def __init__(self, inplanes: int, channel: int, feat_sz: int,
                 stride: int = 16, cls_tokenize: bool = True,
                 offset_sigmoid: bool = True, joint_cls: bool = False,
                 softmax_one: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat_sz, self.stride, self.dtype = feat_sz, stride, dtype
        self.cls_tokenize, self.offset_sigmoid = cls_tokenize, offset_sigmoid
        self.joint_cls, self.softmax_one = joint_cls, softmax_one
        self.conv_cls = ConvTower(inplanes, channel, 1, dtype)
        self.conv_offset = ConvTower(inplanes, channel, 2, dtype)
        self.conv_bbox = ConvTower(inplanes, channel, 2, dtype)
        self.conv_bbox_grounding = ConvTower(inplanes, channel, 2, dtype)
        self.prompter = DistributionPrompter(inplanes, dtype=dtype)
        self.logit_scale = nn.Parameter(torch.tensor(0.0))
        # flattened grid coords: row-major cell k=(row,col) -> (x=col, y=row)
        cols = np.tile(np.arange(feat_sz, dtype=np.float32), feat_sz)
        rows = np.repeat(np.arange(feat_sz, dtype=np.float32), feat_sz)
        coord = np.stack([cols, rows]) + (0.0 if offset_sigmoid else 0.5)
        self.register_buffer("coordinate", torch.tensor(coord), persistent=False)

    @staticmethod
    def _token(out_dict: dict) -> torch.Tensor:
        vis, txt = out_dict["vis_token"], out_dict["txt_token"]
        return select_by_flag(torch.cat([vis, txt, (vis + txt) / 2], dim=1),
                              out_dict["flag"])

    def cont_score_from_prompt(self, search, prompt, test: bool):
        """search (B,Nx,C) x prompt (B,3,C) -> contrastive score columns.
        Test with softmax_one: (B, Nx, 3) with a zero third column."""
        raw = torch.exp(self.logit_scale.float()) * torch.einsum(
            "bnc,bpc->bnp", l2_normalize(search), l2_normalize(prompt))
        target, rest = raw[:, :, :1], raw[:, :, 1:]
        if self.softmax_one:
            rest = torch.cat([rest, torch.zeros_like(target)], dim=-1)
        cols = [target, rest.amax(-1, keepdim=True)]
        if test and self.softmax_one:
            cols.append(torch.zeros_like(target))
        return torch.cat(cols, dim=-1)

    def convert2bbox(self, cls_map, offset_map, size_map, cont_score):
        """cls_map (B,s); offset/size (B,2,s); cont_score (B,s,K) ->
        (bbox_map (B,s,4) cxcywh normalized, best bbox (B,1,4))."""
        cont0 = torch.softmax(cont_score.float(), dim=-1)[:, :, 0]
        best = torch.argmax(cls_map * cont0, dim=-1)
        ctr = (self.coordinate[None] + offset_map) / self.feat_sz
        bbox_map = torch.cat([ctr, size_map], dim=1).transpose(1, 2)
        bbox = torch.gather(bbox_map, 1, best[:, None, None].expand(-1, 1, 4))
        return bbox_map, bbox

    def forward(self, out_dict: dict, prompt: torch.Tensor | None = None,
                train: bool = False) -> dict:
        """The test path when a prompt is given. With prompt=None (the
        grounding forward and training) the prompter mines prompts from the
        template and the half-batch-rotated search features, under
        out_dict's template_mask and context_mask, and the contrastive score
        keeps the two non-test columns. train=True runs the towers' BN on
        batch statistics and updates their running stats."""
        flag, search = out_dict["flag"], out_dict["search"]
        b, s, c = search.shape
        f = self.feat_sz
        if prompt is None:
            prompt = self.prompter(out_dict["template"], out_dict["template_mask"],
                                   rotate_half_batch(search), out_dict["context_mask"],
                                   self._token(out_dict), flag)
            cont_score = self.cont_score_from_prompt(search, prompt, test=False)
        else:
            cont_score = self.cont_score_from_prompt(search, prompt, test=True)
        x2d = search.reshape(b, f, f, c).permute(0, 3, 1, 2)  # NCHW
        cls_in = x2d * self._token(out_dict)[:, :, None, None] if self.cls_tokenize else x2d
        cls_map = torch.sigmoid(self.conv_cls(cls_in, train).float()).reshape(b, s)
        offset = self.conv_offset(x2d, train).float()
        if self.offset_sigmoid:
            offset = torch.sigmoid(offset)
        offset = offset.reshape(b, 2, s)
        size_tr = torch.sigmoid(self.conv_bbox(x2d, train).float()).reshape(b, 2, s)
        size_gr = torch.sigmoid(self.conv_bbox_grounding(x2d, train).float()).reshape(b, 2, s)
        size_map = select_by_flag(torch.stack([size_tr, size_gr, size_tr], dim=1), flag)
        bbox_map, bbox = self.convert2bbox(cls_map, offset, size_map, cont_score)
        cont0 = torch.softmax(cont_score.float(), dim=-1)[:, :, 0]
        out = dict(out_dict)
        out.update({
            "cls_score": cls_map * cont0 if self.joint_cls else cls_map,
            "bbox_map": bbox_map,
            "pred_boxes": bbox,
            "cont_score": cont_score,
            "prompts": prompt,
            "cls_score_test": cls_map,
        })
        return out

    def forward_prompt(self, out_dict: dict) -> torch.Tensor:
        """Recompute prompts from cached backbone features (tracker update)."""
        return self.prompter(out_dict["template"], out_dict["template_mask"],
                             out_dict["search"], out_dict["context_mask"],
                             self._token(out_dict), out_dict["flag"])
