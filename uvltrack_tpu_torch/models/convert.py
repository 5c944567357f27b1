"""Weight bridge into the port's reference-named modules (the port's own copy
of the rule table of uvltrack_tpu/models/convert.py::_uvltrack_rules and its
helpers, :57-139 and :324-363).

- `from_jax_variables(params, batch_stats)`: a flax variable tree as nested
  dicts of numpy arrays (np.asarray of each leaf) -> the reference-keyed
  state dict of the port's UVLTrack, linear kernels transposed to (out, in)
  and conv kernels HWIO -> OIHW. This is how the tests hand the JAX package's
  weights to the port.
- `load_reference_state(model, state)`: a reference-keyed state dict (the
  'net' dict of a released UVLTrack .pth.tar, or from_jax_variables' output)
  into the model, strict about missing keys like the reference's
  load_state_dict; keys the model has no place for are returned. A model
  with `backbone.text_proj` (BERT width != ViT width) loads only a state
  that carries it (from_jax_variables'); a reference checkpoint never does,
  and is refused, as the JAX package's convert_uvltrack refuses it.
- `load_torch_file(path)`: a checkpoint file's state dict ('net' entry).
- `save_torch_checkpoint(path, model_or_state, epoch)`: the reference's
  file, {'net': state, 'epoch': N}, as the JAX package's
  save_torch_checkpoint writes it (convert.py:421-431): the rule table's
  keys, fp32 (a bf16 model upcast) and each BN's num_batches_tracked.
- `load_pretrained(cfg, model)`: the training start (convert.py:247-288 of
  the JAX package): an MAE-pretrained ViT (`convert_mae_vit`) and a BERT
  archive (`load_bert_archive`, `convert_bert`) from local paths, each
  skipped with a warning when its file is missing, so synthetic training
  runs from the seeded init.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)  # flax (in, out) -> torch (out, in)


def _t_conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _vit_block_rules(i: int):
    b, d = f"vit.blocks.{i}.", ["backbone", f"block_{i}"]
    return [
        (b + "norm1.weight", d + ["norm1", "scale"], None),
        (b + "norm1.bias", d + ["norm1", "bias"], None),
        (b + "attn.qkv.weight", d + ["qkv", "kernel"], _t_linear),
        (b + "attn.qkv.bias", d + ["qkv", "bias"], None),
        (b + "attn.proj.weight", d + ["proj", "kernel"], _t_linear),
        (b + "attn.proj.bias", d + ["proj", "bias"], None),
        (b + "norm2.weight", d + ["norm2", "scale"], None),
        (b + "norm2.bias", d + ["norm2", "bias"], None),
        (b + "mlp.fc1.weight", d + ["mlp", "fc1", "kernel"], _t_linear),
        (b + "mlp.fc1.bias", d + ["mlp", "fc1", "bias"], None),
        (b + "mlp.fc2.weight", d + ["mlp", "fc2", "kernel"], _t_linear),
        (b + "mlp.fc2.bias", d + ["mlp", "fc2", "bias"], None),
    ]


def _bert_layer_rules(i: int):
    b, d = f"bert.encoder.layer.{i}.", ["backbone", f"bert_layer_{i}"]
    return [
        (b + "attention.self.query.weight", d + ["query", "kernel"], _t_linear),
        (b + "attention.self.query.bias", d + ["query", "bias"], None),
        (b + "attention.self.key.weight", d + ["key", "kernel"], _t_linear),
        (b + "attention.self.key.bias", d + ["key", "bias"], None),
        (b + "attention.self.value.weight", d + ["value", "kernel"], _t_linear),
        (b + "attention.self.value.bias", d + ["value", "bias"], None),
        (b + "attention.output.dense.weight", d + ["attn_out", "kernel"], _t_linear),
        (b + "attention.output.dense.bias", d + ["attn_out", "bias"], None),
        (b + "attention.output.LayerNorm.weight", d + ["attn_norm", "scale"], None),
        (b + "attention.output.LayerNorm.bias", d + ["attn_norm", "bias"], None),
        (b + "intermediate.dense.weight", d + ["intermediate", "kernel"], _t_linear),
        (b + "intermediate.dense.bias", d + ["intermediate", "bias"], None),
        (b + "output.dense.weight", d + ["output", "kernel"], _t_linear),
        (b + "output.dense.bias", d + ["output", "bias"], None),
        (b + "output.LayerNorm.weight", d + ["out_norm", "scale"], None),
        (b + "output.LayerNorm.bias", d + ["out_norm", "bias"], None),
    ]


def _bert_embed_rules():
    e, d = "bert.embeddings.", ["backbone", "bert_embeddings"]
    return [
        (e + "word_embeddings.weight", d + ["word_embeddings", "embedding"], None),
        (e + "position_embeddings.weight", d + ["position_embeddings", "embedding"], None),
        (e + "token_type_embeddings.weight", d + ["token_type_embeddings", "embedding"], None),
        (e + "LayerNorm.weight", d + ["LayerNorm", "scale"], None),
        (e + "LayerNorm.bias", d + ["LayerNorm", "bias"], None),
    ]


TOWERS = ("conv_cls", "conv_offset", "conv_bbox", "conv_bbox_grounding")


def _tower_rules(tower: str):
    """torch Sequential conv(i).{0 conv, 1 bn} x4 + [4] final 1x1."""
    rules = []
    for i in range(4):
        s, d = f"box_head.{tower}.{i}.", ["head", tower, f"stage_{i}"]
        rules += [
            (s + "0.weight", d + ["conv", "kernel"], _t_conv),
            (s + "0.bias", d + ["conv", "bias"], None),
            (s + "1.weight", d + ["bn", "scale"], None),
            (s + "1.bias", d + ["bn", "bias"], None),
        ]
    return rules + [
        (f"box_head.{tower}.4.weight", ["head", tower, "final", "kernel"], _t_conv),
        (f"box_head.{tower}.4.bias", ["head", tower, "final", "bias"], None),
    ]


def _tower_bn_stats(tower: str):
    rules = []
    for i in range(4):
        s, d = f"box_head.{tower}.{i}.1.", ["head", tower, f"stage_{i}", "bn"]
        rules += [(s + "running_mean", d + ["mean"]), (s + "running_var", d + ["var"])]
    return rules


def uvltrack_rules(depth: int, n_bert: int):
    """(reference key without the 'backbone.' prefix, flax param path,
    transform) for every parameter, and (key, batch_stats path) for every BN
    running statistic."""
    rules = [
        ("logit_scale", ["backbone", "logit_scale"], None),
        ("vit.cls_token", ["backbone", "cls_token"], None),
        ("vit.pos_embed_z", ["backbone", "pos_embed_z"], None),
        ("vit.pos_embed_x", ["backbone", "pos_embed_x"], None),
        ("vit.modal_embed", ["backbone", "modal_embed"], None),
        ("vit.patch_embed.proj.weight", ["backbone", "patch_embed", "proj", "kernel"], _t_conv),
        ("vit.patch_embed.proj.bias", ["backbone", "patch_embed", "proj", "bias"], None),
        ("box_head.logit_scale", ["head", "logit_scale"], None),
        ("box_head.prompter.logit_scale", ["head", "prompter", "logit_scale"], None),
        ("box_head.prompter.query_embed.weight", ["head", "prompter", "query_embed"], None),
        ("box_head.prompter.mlp.fc1.weight", ["head", "prompter", "mlp", "fc1", "kernel"], _t_linear),
        ("box_head.prompter.mlp.fc1.bias", ["head", "prompter", "mlp", "fc1", "bias"], None),
        ("box_head.prompter.mlp.fc2.weight", ["head", "prompter", "mlp", "fc2", "kernel"], _t_linear),
        ("box_head.prompter.mlp.fc2.bias", ["head", "prompter", "mlp", "fc2", "bias"], None),
    ]
    for i in range(depth):
        rules += _vit_block_rules(i)
    rules += _bert_embed_rules()
    for i in range(n_bert):
        rules += _bert_layer_rules(i)
    for tower in TOWERS:
        rules += _tower_rules(tower)
    bn_rules = [r for tower in TOWERS for r in _tower_bn_stats(tower)]
    return rules, bn_rules


def text_proj_rules():
    """The rules of `text_proj` (BERT width != ViT width; the port's own key)."""
    return [("text_proj.weight", ["backbone", "text_proj", "kernel"], _t_linear),
            ("text_proj.bias", ["backbone", "text_proj", "bias"], None)]


def layer_scale_rules(i: int):
    """The rules of block i's LayerScale gammas (ls1, ls2), where it has them."""
    return [(f"vit.blocks.{i}.ls{j}.gamma", ["backbone", f"block_{i}", f"ls{j}_gamma"], None)
            for j in (1, 2)]


def state_key(src: str) -> str:
    """The reference prefixes backbone parameters with 'backbone.'."""
    return ("backbone." + src if src.startswith(("vit.", "bert.", "logit_scale", "text_proj."))
            else src)


def _get(tree: dict, path: List[str]) -> np.ndarray:
    for k in path:
        tree = tree[k]
    v = np.asarray(tree)
    # bf16 (ml_dtypes) leaves of an inference-cast tree go up to fp32
    return v.astype(np.float32) if v.dtype.kind in "fV" and v.dtype.itemsize < 4 else v


def from_jax_variables(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Flax UVLTrack variables (nested dicts of numpy arrays) -> the port's
    reference-keyed state dict; num_batches_tracked is 0 (no flax home)."""
    bk = params["backbone"]
    depth = sum(1 for k in bk if k.startswith("block_"))
    n_bert = sum(1 for k in bk if k.startswith("bert_layer_"))
    rules, bn_rules = uvltrack_rules(depth, n_bert)
    if "text_proj" in bk:  # BERT width != ViT width: the port's own key
        rules += text_proj_rules()
    for i in range(depth):  # LayerScale, where the blocks carry it
        rules += [r for j, r in zip((1, 2), layer_scale_rules(i))
                  if f"ls{j}_gamma" in bk[f"block_{i}"]]
    state = {}
    for src, dst, tf in rules:
        v = _get(params, dst)
        state[state_key(src)] = torch.from_numpy(np.array(tf(v) if tf else v))
    for src, dst in bn_rules:
        state[src] = torch.from_numpy(np.array(_get(batch_stats, dst)))
        nb = src.rsplit(".", 1)[0] + ".num_batches_tracked"
        state.setdefault(nb, torch.tensor(0, dtype=torch.int64))
    return state


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file, on the CPU: its 'net'
    ('model', 'state_dict') entry where it has one, as the reference's
    .pth.tar keeps the network under 'net' (tensor entries only)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("net", "model", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: v for k, v in obj.items() if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def save_torch_checkpoint(path: str, model_or_state, epoch: int = 0) -> None:
    """Write a reference-loadable .pth.tar, {'net': state, 'epoch': epoch}
    (lib/test/tracker/uvltrack.py:24 reads ['net']), from a model or its
    reference-keyed state dict: every key of the rule table (LayerScale's
    gammas where the blocks carry them), in the JAX writer's order, each
    tensor on the CPU, bf16 upcast to fp32, and after each BN's running
    stats its num_batches_tracked (the model's; 0 where the state has none,
    as the JAX writer writes without passthrough). A model split by
    tensor parallelism is refused (pass parallel/tp.py::gather_params_tp's
    state), and so is a text_proj (BERT width != ViT width), which the
    reference has no layer for."""
    if isinstance(model_or_state, torch.nn.Module):
        if getattr(model_or_state, "tp_size", 1) != 1:
            raise ValueError("a tensor-parallel model's slices: write "
                             "parallel/tp.py::gather_params_tp's state instead")
        state = model_or_state.state_dict()
    else:
        state = dict(model_or_state)
    if any(k.startswith("backbone.text_proj.") for k in state):
        raise ValueError("model has backbone.text_proj (BERT hidden_size != embed_dim); the "
                         "reference has no such layer, so the checkpoint could not be loaded "
                         "by it -- match the BERT variant to the ViT width instead")
    depth = len({k.split(".")[3] for k in state if k.startswith("backbone.vit.blocks.")})
    n_bert = len({k.split(".")[4] for k in state
                  if k.startswith("backbone.bert.encoder.layer.")})
    rules, bn_rules = uvltrack_rules(depth, n_bert)
    rules += [r for i in range(depth) for r in layer_scale_rules(i)
              if state_key(r[0]) in state]

    def up(t):
        t = torch.as_tensor(t).detach().to("cpu")
        return (t.float() if t.is_floating_point() and t.element_size() < 4 else t).clone()

    net = {state_key(src): up(state[state_key(src)]) for src, _, _ in rules}
    for src, _ in bn_rules:
        net[src] = up(state[src])
        nb = src.rsplit(".", 1)[0] + ".num_batches_tracked"
        net.setdefault(nb, up(state.get(nb, torch.tensor(0, dtype=torch.int64))))
    torch.save({"net": net, "epoch": epoch}, path)


def _bert_norm_name(key: str) -> str:
    """Old BERT checkpoints' LayerNorm.gamma / .beta -> .weight / .bias (a
    LayerScale's own `gamma` keeps its name)."""
    return re.sub(r"LayerNorm\.gamma$", "LayerNorm.weight",
                  re.sub(r"LayerNorm\.beta$", "LayerNorm.bias", key))


@torch.no_grad()
def load_reference_state(model: torch.nn.Module, state: dict,
                         strict: bool = True) -> List[str]:
    """Copy a reference-keyed state dict (numpy or torch values) into the
    model, keeping each parameter's device and dtype. Old BERT gamma/beta
    names are normalized. Raises on missing keys when strict (a truncated or
    wrong-config checkpoint would otherwise track with random weights) and
    on any shape mismatch; returns the keys the model has no place for."""
    state = {_bert_norm_name(k): v for k, v in state.items()}
    own = model.state_dict()
    proj = [k for k in own if k.startswith("backbone.text_proj.")]
    if proj and not all(k in state for k in proj):
        # text_proj exists only where the BERT width differs from the ViT's,
        # a pairing the reference cannot run, so no reference checkpoint
        # carries it: loading one would track with a random text projection
        raise ValueError(
            "model has backbone.text_proj (BERT hidden_size != embed_dim); "
            "reference checkpoints never contain these weights -- match the "
            "BERT variant to the ViT width (base/768, large/1024) as the "
            "reference does")
    missing = [k for k in own if k not in state]
    if missing and strict:
        raise ValueError(f"state dict is missing {len(missing)} keys of the "
                         f"model (config/depth mismatch?), e.g. {missing[:5]}")
    for k, t in own.items():
        if k not in state:
            continue
        v = torch.as_tensor(np.asarray(state[k]) if not torch.is_tensor(state[k]) else state[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(t.shape)}")
        t.copy_(v.to(device=t.device, dtype=t.dtype))
    return [k for k in state if k not in own]



# ------------------------------------------------------------- pretrained
def _copy_matching(model: torch.nn.Module, pairs) -> List[str]:
    """Copy (source key, value, model key) triples whose model key exists
    into the model (shape-checked, cast to each parameter's dtype); return
    the source keys used."""
    own = model.state_dict()
    used = []
    with torch.no_grad():
        for src, v, dst in pairs:
            if dst not in own:
                continue
            v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            if tuple(v.shape) != tuple(own[dst].shape):
                raise ValueError(f"shape mismatch at {dst}: {tuple(v.shape)} vs "
                                 f"{tuple(own[dst].shape)}")
            own[dst].copy_(v.to(device=own[dst].device, dtype=own[dst].dtype))
            used.append(src)
    return used


def convert_mae_vit(state: dict, model: torch.nn.Module) -> List[str]:
    """An MAE-pretrained ViT ('model' dict: blocks.{i}.*, patch_embed.proj.*,
    cls_token) into the model's ViT, in place, for the blocks it has; the
    MAE pos_embed is not used (the tracker has its own sin-cos embeddings,
    strict=False in the reference). Returns the unused keys."""
    pairs = [(k, v, "backbone.vit." + k) for k, v in state.items()
             if k.startswith(("blocks.", "patch_embed.proj.")) or k == "cls_token"]
    used = set(_copy_matching(model, pairs))
    return [k for k in state if k not in used]


def convert_bert(state: dict, model: torch.nn.Module) -> List[str]:
    """A BERT pytorch_model.bin state (keys with or without 'bert.', old
    gamma/beta names normalized) into the model's embeddings and its
    pre-fusion encoder layers, in place. Returns the unused keys."""
    pairs = []
    for k, v in state.items():
        name = _bert_norm_name(k)
        name = name[len("bert."):] if name.startswith("bert.") else name
        if name.startswith(("embeddings.", "encoder.layer.")):
            pairs.append((k, v, "backbone.bert." + name))
    used = set(_copy_matching(model, pairs))
    return [k for k in state if k not in used]


def load_bert_archive(path: str) -> Dict[str, torch.Tensor]:
    """Released-BERT weights from any shape the reference accepts
    (bert_backbone.py:584-623): a tar.gz holding pytorch_model.bin, a
    directory holding it, or a bare .bin/.pth state-dict file."""
    import os
    import tarfile
    import tempfile

    weights_name = "pytorch_model.bin"
    if os.path.isdir(path):
        return load_torch_file(os.path.join(path, weights_name))
    if tarfile.is_tarfile(path):
        with tarfile.open(path, "r:*") as archive, tempfile.TemporaryDirectory() as tmp:
            member = next((m for m in archive.getmembers()
                           if os.path.basename(m.name) == weights_name), None)
            if member is None:
                raise FileNotFoundError(f"{weights_name} not in {path}")
            archive.extract(member, tmp, filter="data")
            return load_torch_file(os.path.join(tmp, member.name))
    return load_torch_file(path)


def load_pretrained(cfg, model: torch.nn.Module, settings=None) -> torch.nn.Module:
    """MAE-ViT + BERT pretrained weights into a freshly built model, in
    place (modality_unified_feature_extractor.py:20-37). Paths resolve
    against the repo (eval/environment.py::resolve_path); a missing file is
    skipped with a warning on stderr, so the model keeps its seeded init."""
    import os
    import sys

    from ..eval.environment import env_settings, resolve_path

    settings = settings or env_settings()
    mae_path = resolve_path(settings, cfg.MODEL.BACKBONE.PRETRAINED_PATH)
    if mae_path and os.path.exists(mae_path):
        unused = convert_mae_vit(load_torch_file(mae_path), model)
        sys.stderr.write(f"loaded MAE ViT from {mae_path} ({len(unused)} unused keys)\n")
    elif cfg.MODEL.BACKBONE.PRETRAINED_PATH:
        sys.stderr.write(f"MAE weights not found at {mae_path}; training from random init\n")
    bert_path = resolve_path(settings, cfg.MODEL.BACKBONE.LANGUAGE.PATH or "")
    if not (bert_path and os.path.exists(bert_path)):
        # the reference passes LANGUAGE.TYPE to from_pretrained (a directory)
        bert_path = resolve_path(settings, cfg.MODEL.BACKBONE.LANGUAGE.TYPE)
    if bert_path and os.path.exists(bert_path):
        unused = convert_bert(load_bert_archive(bert_path), model)
        sys.stderr.write(f"loaded BERT from {bert_path} ({len(unused)} unused keys)\n")
    else:
        sys.stderr.write("BERT archive not found; language branch keeps random init\n")
    return model
