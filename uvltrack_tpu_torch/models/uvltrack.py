"""UVLTrack model: MUFE backbone + MABH head with the inference entry points
the tracker needs (port of uvltrack_tpu/models/uvltrack.py; reference
lib/models/uvltrack/uvltrack.py:8-57).

The module tree is named like the reference ('backbone.vit...',
'backbone.bert...', 'box_head...'), so a reference-keyed state dict loads
through models/convert.py. `forward` is the JAX package's __call__: at
train=False the tracker's NL mode runs it as its grounding forward, and
train=True is the training forward (train/actor.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import registry
from ..ops import attention, quant
from .bert import bert_config_from_type
from .head import MABH
from .mufe import MUFE
from .vit import VIT_VARIANTS, sincos_2d, vit_variant_from_path


class UVLTrack(nn.Module):
    def __init__(self, backbone: MUFE, box_head: MABH):
        super().__init__()
        self.backbone = backbone
        self.box_head = box_head

    def forward(self, template, search, text_ids, text_mask, template_mask,
                context_mask, flag, train: bool = False,
                generator: torch.Generator | None = None):
        """The full forward without a prompt (UVLTrack.__call__): MUFE with
        live BERT, then the head mining prompts from the rotated batch
        (MABH.forward with prompt=None); the grounding-size tower's boxes
        under flag 1. train=True: stochastic depth from `generator` where
        DROP_PATH_RATE > 0, and batch-statistics BN in the head."""
        out = self.backbone(template, search, text_ids, text_mask, flag, train=train,
                            generator=generator)
        out["template_mask"] = template_mask
        out["context_mask"] = context_mask
        return self.box_head(out, train=train)

    def forward_prompt_init(self, template, search, text_ids, text_mask,
                            template_mask, context_mask, flag):
        out = self.backbone(template, search, text_ids, text_mask, flag)
        out["template_mask"] = template_mask
        out["context_mask"] = context_mask
        return self.box_head.forward_prompt(out)

    def forward_prompt(self, out_dict, template_mask, context_mask):
        out = dict(out_dict, template_mask=template_mask, context_mask=context_mask)
        return self.box_head.forward_prompt(out)

    def forward_test(self, template, search, text_ids, text_mask, prompt, flag):
        out = self.backbone(template, search, text_ids, text_mask, flag)
        return self.box_head(out, prompt)

    def encode_text(self, text_ids, text_mask):
        """Pre-fusion text features, constant per tracking sequence."""
        return self.backbone.encode_text(text_ids, text_mask)

    def forward_test_cached(self, template, search, txt_feat, text_mask,
                            prompt, flag):
        """forward_test with the pre-fusion text stream precomputed: the
        per-frame step runs no BERT layer."""
        out = self.backbone.forward_cached_text(template, search, txt_feat,
                                                text_mask, flag)
        return self.box_head(out, prompt)


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """The entry points' device: "cuda" unless the caller asks otherwise; a
    CUDA device without a card raises instead of running on the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("uvltrack_tpu_torch runs on a CUDA device and none "
                           "is available; pass device='cpu' to run on the CPU")
    return device


def cast_inference_params(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """In place (to hold one copy of the weights): every >=2-D fp32
    parameter to `dtype` -- linear and conv kernels, embedding tables, pos
    embeds, cls/modal/query embeds -- while 1-D and scalar parameters (biases,
    norms, logit scales) and the BN running stats stay fp32
    (cast_inference_variables)."""
    for p in model.parameters():
        if p.ndim >= 2 and p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return model


def prepare_inference_model(cfg, model: nn.Module) -> nn.Module:
    """The inference weight prep of prepare_inference_variables, in place:
    the bf16 cast per cfg.TPU.COMPUTE_DTYPE, then weight-only int8 per
    cfg.TPU.WEIGHT_QUANT (ops/quant.py quantize_vit_params at its default
    min_dim, from the cast values). Idempotent: the Tracker calls it again
    on a prepared model, and a quantized weight is left as it is."""
    if str(cfg.TPU.COMPUTE_DTYPE) == "bfloat16":
        cast_inference_params(model)
    wq = str(cfg.TPU.WEIGHT_QUANT or "")
    if wq:
        if wq != "int8":
            raise ValueError(f"TPU.WEIGHT_QUANT={wq!r}: only 'int8'")
        quant.quantize_vit_params(model)
    return model.eval()


def configure_attention(cfg) -> None:
    """cfg.TPU.USE_PALLAS_ATTENTION selects the CUDA kernels ("cuda"),
    else the composed PyTorch math ("plain")."""
    attention.set_backend("cuda" if bool(cfg.TPU.USE_PALLAS_ATTENTION) else "plain")


@registry.MODELS.register("uvltrack")
def build_model(cfg, device=None, seed: int = 0) -> UVLTrack:
    """UVLTrack from a config, on `device` ("cuda" by default), computing in
    cfg.TPU.COMPUTE_DTYPE with fp32 parameters (prepare_inference_model casts
    them for inference; training keeps them), with seeded random weights
    (init_model); load real weights with models/convert.py. Reads the
    training knobs MODEL.BACKBONE.DROP_PATH_RATE, MODEL.LEARNABLE_POSITION
    and TPU.REMAT."""
    configure_attention(cfg)
    device = resolve_device(device)
    variant = VIT_VARIANTS[vit_variant_from_path(cfg.MODEL.BACKBONE.PRETRAINED_PATH)]
    dtype = DTYPES[cfg.TPU.COMPUTE_DTYPE]
    with torch.device(device):
        backbone = MUFE(
            embed_dim=variant["embed_dim"], depth=variant["depth"],
            num_heads=variant["num_heads"],
            template_size=cfg.DATA.TEMPLATE.SIZE,
            search_size=cfg.DATA.SEARCH.SIZE,
            fusion_layers=tuple(cfg.MODEL.BACKBONE.FUSION_LAYER),
            cont_loss_layers=tuple(cfg.MODEL.BACKBONE.CONT_LOSS_LAYER),
            txt_token_mode=cfg.MODEL.BACKBONE.TXT_TOKEN_MODE,
            bert=bert_config_from_type(cfg.MODEL.BACKBONE.LANGUAGE.TYPE),
            dtype=dtype, learnable_pos=bool(cfg.MODEL.LEARNABLE_POSITION),
            remat=bool(cfg.TPU.REMAT),
            drop_path_rate=float(cfg.MODEL.BACKBONE.DROP_PATH_RATE))
        head = MABH(
            inplanes=cfg.MODEL.HIDDEN_DIM, channel=cfg.MODEL.HEAD.HEAD_DIM,
            feat_sz=cfg.DATA.SEARCH.SIZE // 16, stride=16,
            cls_tokenize=cfg.MODEL.HEAD.CLS_TOKENIZE,
            offset_sigmoid=cfg.MODEL.HEAD.OFFSET_SIGMOID,
            joint_cls=cfg.MODEL.HEAD.JOINT_CLS,
            softmax_one=cfg.MODEL.HEAD.SOFTMAX_ONE, dtype=dtype)
        model = UVLTrack(backbone, head)
    return init_model(model, seed)


def _init_value(name: str, shape, rng: np.random.Generator):
    """numpy init of one reference-named tensor, after the flax initializers
    (xavier-uniform ViT kernels, lecun-normal convs, N(0, 0.02) tokens and
    embedding tables, N(0, 1) query embeds, sin-cos pos embeds, unit norms,
    zero biases)."""
    leaf = name.rsplit(".", 1)[-1]

    def normal(std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    if leaf == "logit_scale":
        return np.asarray(np.log(1.0 / 0.07), np.float32)
    if leaf in ("pos_embed_z", "pos_embed_x"):
        return sincos_2d(shape[-1], int(round(np.sqrt(shape[1]))))[None]
    if leaf in ("cls_token", "modal_embed") or (
            "bert.embeddings" in name and len(shape) == 2):
        return normal(0.02)
    if name.endswith("query_embed.weight"):
        return normal(1.0)
    if leaf in ("bias", "running_mean", "num_batches_tracked"):
        return np.zeros(shape)
    if leaf in ("weight", "running_var") and len(shape) == 1:
        return np.ones(shape)
    if len(shape) == 2:  # Linear (out, in)
        lim = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * lim
    if len(shape) == 4:  # Conv (O, I, kh, kw)
        return normal(1.0 / np.sqrt(np.prod(shape[1:])))
    raise ValueError(f"no init rule for {name} {tuple(shape)}")


@torch.no_grad()
def init_model(model: UVLTrack, seed: int = 0) -> UVLTrack:
    """Fill every parameter and buffer of the state dict from
    numpy.random.default_rng(seed), in state-dict order."""
    rng = np.random.default_rng(seed)
    for name, t in model.state_dict().items():
        v = _init_value(name, tuple(t.shape), rng)
        t.copy_(torch.as_tensor(np.asarray(v)).to(t.dtype))
    return model


class ForwardTest(nn.Module):
    """The deployable per-frame inference program (forward_test_fn): the
    model's forward_test returning (bbox_map, cls_score_test, cont_score).
    Its parameters are the model's own, so `torch.export` lifts them as the
    program's inputs (never constants baked into the graph)."""

    def __init__(self, model: UVLTrack):
        super().__init__()
        self.model = model

    def forward(self, template, search, text_ids, text_mask, prompt, flag):
        out = self.model.forward_test(template, search, text_ids, text_mask, prompt, flag)
        return out["bbox_map"], out["cls_score_test"], out["cont_score"]


def forward_test_fn(model: UVLTrack) -> ForwardTest:
    """The program that cli/export.py exports and cli/profile.py times
    (uvltrack_tpu/models/uvltrack.py::forward_test_fn): a module over the
    model's own parameters; call it with example_test_inputs."""
    return ForwardTest(model)


def example_test_inputs(cfg, model: UVLTrack, batch: int = 1, seed: int = 0) -> tuple:
    """Concrete example arguments for forward_test_fn, on the model's device
    (the JAX example_test_inputs from the same numpy draws): random NHWC
    images at the configured template/search sizes, in-vocab text ids with a
    full mask, a (B, 3, C) prompt, flag=2 (NL+BBOX)."""
    tz, sx = int(cfg.DATA.TEMPLATE.SIZE), int(cfg.DATA.SEARCH.SIZE)
    nt = int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN)
    c = model.backbone.embed_dim
    vocab = model.backbone.bert.embeddings.word_embeddings.num_embeddings
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return (
        t(rng.normal(size=(batch, tz, tz, 3)), torch.float32),
        t(rng.normal(size=(batch, sx, sx, 3)), torch.float32),
        t(rng.integers(0, vocab, size=(batch, nt)), torch.int32),
        t(np.ones((batch, nt)), torch.int32),
        t(rng.normal(size=(batch, 3, c)), torch.float32),
        t(np.full((batch,), 2), torch.int32),
    )
