"""Modality-Unified Feature Extractor (port of uvltrack_tpu/models/mufe.py;
reference lib/models/backbones/modality_unified_feature_extractor.py).

One ViT and a truncated BERT run layer by layer: below the fusion depth the
two streams attend separately, at the fusion layers one joint attention runs
over [CLS | template | search | text] under a flag-conditioned key mask
(cat_mask). flag (B,) int: 0=BBOX (text masked), 1=NL (CLS+template masked),
2=NL+BBOX (nothing extra masked).

dtype follows the JAX package: the visual stream is in the compute dtype,
the BERT stream leaves its fp32 LayerNorms in fp32, and the joint blocks
concatenate the two, so the joint stream (and everything after it) is fp32.

A BERT width other than the ViT's gets `text_proj` (the JAX package's
MUFE.text_proj): a Linear from the BERT width to the ViT width, fp32
parameters computing in the compute dtype, applied to the embeddings in both
text paths (forward and encode_text). No reference checkpoint carries it
(models/convert.py).

Training (forward(train=True)): stochastic depth when drop_path_rate > 0,
linear over depth from 0 (the masks drawn from the caller's
torch.Generator, two rows a block); `remat` (cfg TPU.REMAT) runs each ViT
block and BERT layer under torch.utils.checkpoint, which stores the block's
input only and recomputes the block in the backward, as jax.checkpoint
does. The position embeddings are parameters either way: `learnable_pos`
(MODEL.LEARNABLE_POSITION) tells the optimizer whether to update them
(train/optim.py), as the JAX package's optax mask does.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.dp import current as current_dp
from .bert import BertConfig, BertEmbeddings, BertLayer, bert_attention_bias, dense
from .vit import PatchEmbed, VitBlock, sincos_2d


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics in fp32: x / max(||x||, eps)."""
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def select_by_flag(group: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """group: (B, 3, ...), flag: (B,) in {0,1,2} -> (B, ...)."""
    idx = flag.long().reshape(flag.shape[0], *([1] * (group.ndim - 1)))
    idx = idx.expand(-1, 1, *group.shape[2:])
    return torch.gather(group, 1, idx).squeeze(1)


class VisionTransformer(nn.Module):
    """Parameter container named like the reference's `vit` submodule."""

    def __init__(self, embed_dim, depth, num_heads, template_size, search_size,
                 patch_size, dtype, drop_path_rate: float = 0.0):
        super().__init__()
        gz, gx = template_size // patch_size, search_size // patch_size
        self.patch_embed = PatchEmbed(embed_dim, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed_z = nn.Parameter(
            torch.tensor(sincos_2d(embed_dim, gz)[None], dtype=torch.float32))
        self.pos_embed_x = nn.Parameter(
            torch.tensor(sincos_2d(embed_dim, gx)[None], dtype=torch.float32))
        self.modal_embed = nn.Parameter(torch.zeros(2, embed_dim))
        dpr = np.linspace(0.0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            VitBlock(embed_dim, num_heads, 4.0, dtype, drop_path=float(dpr[i]))
            for i in range(depth))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, n_layers: int, dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype) for _ in range(n_layers))


class BertModel(nn.Module):
    """Parameter container named like the reference's `bert` submodule,
    holding only the min(FUSION_LAYER) pre-fusion layers."""

    def __init__(self, cfg: BertConfig, n_layers: int, dtype):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg, dtype)
        self.encoder = BertEncoder(cfg, n_layers, dtype)


class MUFE(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 template_size: int, search_size: int, patch_size: int = 16,
                 fusion_layers: Sequence[int] = (),
                 cont_loss_layers: Sequence[int] = (),
                 txt_token_mode: str = "cls", bert: BertConfig = BertConfig(),
                 dtype: torch.dtype = torch.float32, learnable_pos: bool = False,
                 remat: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        self.embed_dim, self.depth, self.dtype = embed_dim, depth, dtype
        self.learnable_pos, self.remat = learnable_pos, remat
        self.drop_path_rate = float(drop_path_rate)
        self.num_patches_z = (template_size // patch_size) ** 2
        self.num_patches_x = (search_size // patch_size) ** 2
        self.fusion_layers = tuple(fusion_layers)
        self.cont_loss_layers = tuple(cont_loss_layers)
        self.txt_token_mode = txt_token_mode
        n_bert = min(fusion_layers) if len(fusion_layers) else bert.num_layers
        self.vit = VisionTransformer(embed_dim, depth, num_heads, template_size,
                                     search_size, patch_size, dtype, drop_path_rate)
        self.bert = BertModel(bert, n_bert, dtype)
        self.text_proj = (nn.Linear(bert.hidden_size, embed_dim)
                          if bert.hidden_size != embed_dim else None)
        self.logit_scale = nn.Parameter(torch.tensor(0.0))

    # ------------------------------------------------------------------ masks
    def cat_mask(self, text_mask: torch.Tensor, flag: torch.Tensor):
        """Returns (joint_key_masked (B, 1+Nz+Nx+Nt), visual_key_masked)."""
        b = flag.shape[0]
        is_nl = (flag == 1)[:, None]
        c_masked = is_nl.expand(b, 1)
        z_masked = is_nl.expand(b, self.num_patches_z)
        x_masked = torch.zeros((b, self.num_patches_x), dtype=torch.bool,
                               device=flag.device)
        t_masked = (flag == 0)[:, None] | (text_mask == 0)
        joint = torch.cat([c_masked, z_masked, x_masked, t_masked], dim=1)
        visual = torch.cat([c_masked, z_masked, x_masked], dim=1)
        return joint, visual

    # ---------------------------------------------------------------- streams
    def patchify(self, template: torch.Tensor, search: torch.Tensor) -> torch.Tensor:
        """NHWC template/search -> (B, 1+Nz+Nx, C) [CLS | z | x] tokens."""
        v, dt = self.vit, self.dtype
        z = v.patch_embed(template) + v.pos_embed_z.to(dt)
        x = v.patch_embed(search) + v.pos_embed_x.to(dt)
        cls = v.cls_token.to(dt).expand(z.shape[0], 1, self.embed_dim)
        return torch.cat([cls, z, x], dim=1)

    def txt_token(self, txt_feat: torch.Tensor, text_mask: torch.Tensor) -> torch.Tensor:
        if self.txt_token_mode == "mean":
            m = text_mask[..., None].to(txt_feat.dtype)
            return (txt_feat * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp_min(1e-6)
        return txt_feat[:, :1]

    def contrastive_logits(self, img_feat, txt_feat, text_mask, flag):
        x = img_feat[:, 1 + self.num_patches_z:]
        vis_token = img_feat[:, :1]
        txt_tok = self.txt_token(txt_feat, text_mask)
        scale = torch.exp(self.logit_scale.float())
        xn = l2_normalize(x)
        vis_logits = scale * torch.einsum("bnc,bmc->bnm", xn, l2_normalize(vis_token))
        txt_logits = scale * torch.einsum("bnc,bmc->bnm", xn, l2_normalize(txt_tok))
        group = torch.stack([vis_logits, txt_logits,
                             (vis_logits + txt_logits) / 2], dim=1)
        return select_by_flag(group, flag)  # (B, Nx, 1)

    def _run(self, layer, *args):
        """A ViT block or BERT layer, under activation checkpointing with
        `remat` while autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _keep_masks(self, b: int, device, generator):
        """Per block: None (drop path 0 or inference), or the (2, B) keep
        masks of its two branches, uniform < 1 - drop_path. Under data
        parallelism every rank draws the global rows' masks (its generator
        seeded as every other rank's) and keeps its own rows
        (parallel/dp.py)."""
        dp = current_dp()
        masks = []
        for blk in self.vit.blocks:
            if blk.drop_path <= 0.0:
                masks.append(None)
                continue
            if dp is None:
                u = torch.rand((2, b), generator=generator, device=device)
            else:
                u = dp.local_rows(torch.rand((2, b * dp.size), generator=generator,
                                             device=device), dim=1)
            masks.append(u < 1.0 - blk.drop_path)
        return masks

    def _joint(self, i, img_feat, txt_feat, joint_masked, keep=None):
        dt, me = self.dtype, self.vit.modal_embed
        # bf16 visual + fp32 text -> fp32 joint stream, as jnp.concatenate
        e = torch.cat([img_feat + me[0].to(dt), txt_feat + me[1].to(dt)], dim=1)
        e = self._run(self.vit.blocks[i], e, joint_masked, keep)
        n_img = img_feat.shape[1]
        return e[:, :n_img], e[:, n_img:]

    def _outputs(self, img_feat, txt_feat, text_mask, flag) -> dict:
        return {
            "search": img_feat[:, 1 + self.num_patches_z:],
            "template": img_feat[:, 1:1 + self.num_patches_z],
            "text": txt_feat,
            "vis_token": img_feat[:, :1],
            "txt_token": self.txt_token(txt_feat, text_mask),
            "flag": flag.reshape(-1),
        }

    def embed_text(self, text_ids):
        """BERT's embeddings, projected to the ViT width by text_proj where
        the widths differ."""
        txt_feat = self.bert.embeddings(text_ids)
        if self.text_proj is not None:
            txt_feat = dense(txt_feat, self.text_proj, self.dtype)
        return txt_feat

    # ---------------------------------------------------------- cached text
    def encode_text(self, text_ids, text_mask):
        """The pre-fusion text stream: embeddings (and text_proj) then the
        min(fusion_layers) BertLayers. Constant for a tracking sequence, so
        the tracker computes it once at initialize."""
        txt_feat = self.embed_text(text_ids)
        bert_bias = bert_attention_bias(text_mask)
        for layer in self.bert.encoder.layer:
            txt_feat = layer(txt_feat, bert_bias)
        return txt_feat

    def forward_cached_text(self, template, search, txt_feat, text_mask, flag):
        """Inference forward on precomputed pre-fusion text features: the
        math of forward() minus the per-layer contrastive logits."""
        img_feat = self.patchify(template, search)
        joint_masked, visual_masked = self.cat_mask(text_mask, flag)
        fusion = set(self.fusion_layers)
        for i in range(self.depth):
            if i in fusion:
                img_feat, txt_feat = self._joint(i, img_feat, txt_feat, joint_masked)
            else:
                img_feat = self.vit.blocks[i](img_feat, visual_masked)
        return self._outputs(img_feat, txt_feat, text_mask, flag)

    # ---------------------------------------------------------------- forward
    def forward(self, template, search, text_ids, text_mask, flag, train: bool = False,
                generator: torch.Generator | None = None):
        """template/search: NHWC float; text_ids: (B,Nt) int; text_mask:
        (B,Nt); flag: (B,) int. Returns the backbone feature dict, with the
        per-layer contrastive "logits" of the cont_loss_layers. train=True
        with drop_path_rate > 0 drops paths, drawing from `generator` (a
        torch.Generator on the inputs' device)."""
        img_feat = self.patchify(template, search)
        txt_feat = self.embed_text(text_ids)
        bert_bias = bert_attention_bias(text_mask)
        joint_masked, visual_masked = self.cat_mask(text_mask, flag)
        keep = [None] * self.depth
        if train and self.drop_path_rate > 0:
            if generator is None:
                raise ValueError("stochastic depth (DROP_PATH_RATE > 0) draws from an "
                                 "explicit torch.Generator: pass generator=")
            keep = self._keep_masks(img_feat.shape[0], img_feat.device, generator)
        fusion, cont = set(self.fusion_layers), set(self.cont_loss_layers)
        logits_list: List[torch.Tensor] = []
        for i in range(self.depth):
            if i in fusion:
                img_feat, txt_feat = self._joint(i, img_feat, txt_feat, joint_masked, keep[i])
            else:
                img_feat = self._run(self.vit.blocks[i], img_feat, visual_masked, keep[i])
                txt_feat = self._run(self.bert.encoder.layer[i], txt_feat, bert_bias)
            if i in cont:
                logits_list.append(self.contrastive_logits(img_feat, txt_feat,
                                                           text_mask, flag))
        out = self._outputs(img_feat, txt_feat, text_mask, flag)
        if logits_list:
            b, s = out["search"].shape[:2]
            fsz = int(round(s ** 0.5))
            out["logits"] = torch.stack(logits_list, dim=1).reshape(b, -1, fsz, fsz)
        return out
