"""The port's training path (uvltrack_tpu_torch/{core,data,train,models,cli})
against the JAX package on the micro model of tests/test_train_stack.py
(C=32, 2 blocks, 4 heads, a 1-layer BERT, 32/64 px crops, batch 4 x 2
search frames, fp32), its variables perturbed from a numpy seed and handed
to the port through from_jax_variables.

Tolerances, fp32 on the CPU:
- core functions, losses, train-forward outputs, new BN batch_stats: 1e-5
  absolute and relative (the same math, sums in another order); cont_gt
  and the synthetic batch: equal; heatmaps: the same support, values
  within an ulp (numpy's exp against XLA's);
- every parameter's gradient, the accumulated gradients and grad_norm:
  within 1e-5 of each parameter's largest |gradient| plus 1e-6 absolute
  (the floor holds the gradients that are zero in exact arithmetic: conv
  biases before batch-statistics BN, BERT's key bias; measured 4e-8);
- one AdamW step from the same gradients: 1e-6 absolute on the parameters.
The JAX functions are compiled once, in the module-scoped fixture `jx`.
"""

import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.config.cfgnode import CfgNode
from uvltrack_tpu_torch.models.bert import BertConfig
from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
from uvltrack_tpu_torch.models.head import MABH
from uvltrack_tpu_torch.models.mufe import MUFE
from uvltrack_tpu_torch.models.uvltrack import UVLTrack

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
GRAD_FLOOR = 1e-6


def _port_model(remat=False, drop_path_rate=0.0):
    bert = BertConfig(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4,
                      intermediate_size=64, max_position=16)
    return UVLTrack(MUFE(embed_dim=32, depth=2, num_heads=4, template_size=32, search_size=64,
                         fusion_layers=(1,), cont_loss_layers=(0, 1), txt_token_mode="cls",
                         bert=bert, remat=remat, drop_path_rate=drop_path_rate),
                    MABH(inplanes=32, channel=32, feat_sz=4, cls_tokenize=False,
                         softmax_one=True))


def _tree(x):
    return {k: _tree(v) for k, v in x.items()} if hasattr(x, "items") else np.asarray(x)


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jx():
    """The micro model's JAX side, each function compiled once: the
    perturbed variables, a synthetic batch, loss + gradients + new
    batch_stats (value_and_grad of forward_and_loss), the train forward's
    outputs, the eval metrics, and the GRAD_ACCUM=2 step's accumulated
    gradients (through optax.scale(1e6): updates = 1e6 * grads)."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_port_model import _perturb
    from test_train_stack import micro_cfg, micro_model
    from uvltrack_tpu.data.synthetic import synthetic_batch
    from uvltrack_tpu.train.actor import forward_and_loss
    from uvltrack_tpu.train.step import create_train_state, make_train_step

    cfg, jm = micro_cfg(), micro_model()
    batch = synthetic_batch(np.random.default_rng(0), 4, n_search=2, template_size=32,
                            search_size=64, n_text=8, vocab=100)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda r: jm.init(
        r, jb["template_images"][0, :2], jb["search_images"][0, :2], jb["text"][0, :2],
        jb["text_mask"][0, :2], jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jb["flag"][:2], train=False))(jax.random.PRNGKey(0))
    v = _perturb(_tree(v), np.random.default_rng(0))

    def loss_fn(params, bs, b):
        return forward_and_loss(jm, {"params": params, "batch_stats": bs}, b, cfg, train=True)

    (loss, (metrics, new_ms)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], jb)
    from uvltrack_tpu.core.geometry import anno2mask, rotate_half_batch
    from uvltrack_tpu.train.actor import flatten_batch

    fb = flatten_batch(jb)
    out, _ = jax.jit(lambda var: jm.apply(
        var, fb["template_images"], fb["search_images"], fb["text"], fb["text_mask"],
        anno2mask(fb["template_anno"], 2), rotate_half_batch(anno2mask(fb["search_anno"], 4)),
        fb["flag"], train=True, mutable=["batch_stats"]))(v)
    ev = jax.jit(lambda var, b: forward_and_loss(jm, var, b, cfg, train=False)[1][0])(v, jb)

    cfg2 = micro_cfg()
    cfg2.TPU.GRAD_ACCUM = 2
    tx = optax.scale(1e6)
    state = create_train_state({"params": v["params"], "batch_stats": v["batch_stats"]}, tx)
    st2, m2 = jax.jit(make_train_step(jm, tx, cfg2))(state, jb)
    acc = jax.tree_util.tree_map(lambda a, b: (np.asarray(a, np.float64) - b) / 1e6,
                                 st2.params, v["params"])
    return dict(cfg=cfg, v=v, batch=batch, loss=float(loss), metrics=_tree(metrics),
                bs=_tree(new_ms["batch_stats"]), grads=_tree(grads), out=_tree(out),
                eval=_tree(ev), acc_grads=_tree(acc), acc_metrics=_tree(m2),
                acc_bs=_tree(st2.batch_stats))


def _port(jx, **kw):
    tm = _port_model(**kw)
    assert load_reference_state(tm, from_jax_variables(jx["v"]["params"],
                                                       jx["v"]["batch_stats"])) == []
    return tm


def _cfg(jx, **over):
    cfg = CfgNode(jx["cfg"].to_dict())
    for k, val in over.items():
        sec, leaf = k.rsplit(".", 1)
        node = cfg
        for p in sec.split("."):
            node = node[p]
        node[leaf] = val
    return cfg


def _close(got, ref, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _grads_close(named, ref_state):
    for n, g in named.items():
        ref = ref_state[n].float()
        assert g is not None, n
        bound = TOL * float(ref.abs().max()) + GRAD_FLOOR
        err = float((g.float() - ref).abs().max())
        assert err <= bound, (n, err, bound)


# ------------------------------------------------------------------ core
@pytest.mark.parametrize("dynamic", [True, False])
def test_heatmap_equals_jax(dynamic):
    import jax.numpy as jnp

    from uvltrack_tpu.core import heatmap as jh
    from uvltrack_tpu_torch.core import heatmap as th

    rng = np.random.default_rng(1)
    h, w = (rng.uniform(0.5, 12, 64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(th.gaussian_radius(h, w, 0.7),
                               np.asarray(jh.gaussian_radius(jnp.asarray(h), jnp.asarray(w), 0.7)),
                               rtol=1e-6)
    boxes = np.stack([rng.uniform(0, 0.6, 64), rng.uniform(0, 0.6, 64), rng.uniform(
        0.05, 0.4, 64), rng.uniform(0.05, 0.4, 64)], -1).astype(np.float32)
    got = th.generate_cls_label(boxes, 16, 0.7, dynamic)
    ref = np.asarray(jh.generate_cls_label(jnp.asarray(boxes), 16, 0.7, dynamic))
    assert got.dtype == np.float32
    # the same support; values within an ulp (numpy's exp against XLA's)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=0)


def test_box_ops_match_jax():
    import jax.numpy as jnp

    from uvltrack_tpu.core import box_ops as jb
    from uvltrack_tpu_torch.core import box_ops as tb

    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(0, 1, (32, 2)), rng.uniform(0.05, 0.5, (32, 2))], -1)
    b = np.concatenate([rng.uniform(0, 1, (32, 2)), rng.uniform(0.05, 0.5, (32, 2))], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ta, tbx = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("box_xywh_to_xyxy", "box_xywh_to_cxcywh", "box_cxcywh_to_xyxy",
                 "box_xyxy_to_cxcywh", "box_area"):
        _close(getattr(tb, name)(ta), getattr(jb, name)(jnp.asarray(a)))
    xa, xb = tb.box_cxcywh_to_xyxy(ta), tb.box_cxcywh_to_xyxy(tbx)
    ja, jbb = jb.box_cxcywh_to_xyxy(jnp.asarray(a)), jb.box_cxcywh_to_xyxy(jnp.asarray(b))
    for name in ("box_iou", "generalized_box_iou", "giou_loss"):
        for got, ref in zip(getattr(tb, name)(xa, xb), getattr(jb, name)(ja, jbb)):
            _close(got, ref)


@pytest.mark.parametrize("ctr_ratio", [0.75, 0.5])
def test_cont_gt_equals_jax(ctr_ratio):
    import jax.numpy as jnp

    from uvltrack_tpu.core.geometry import cont_gt as jcont
    from uvltrack_tpu_torch.core.geometry import cont_gt

    rng = np.random.default_rng(3)
    boxes = np.stack([rng.uniform(0, 0.6, 16), rng.uniform(0, 0.6, 16), rng.uniform(
        0.05, 0.5, 16), rng.uniform(0.05, 0.5, 16)], -1).astype(np.float32)
    got = cont_gt(torch.from_numpy(boxes), 16, ctr_ratio)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcont(jnp.asarray(boxes), 16, ctr_ratio)))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batch_equals_jax(seed):
    """One default_rng seed, the same arrays (the cfg mapping included)."""
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu.data.synthetic import synthetic_batch_from_cfg as jsyn
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.data.synthetic import synthetic_batch_from_cfg

    yaml = str(REPO / "experiments/uvltrack/_smoke_cpu.yaml")
    a = synthetic_batch_from_cfg(np.random.default_rng(seed), load_cfg(yaml), 4)
    b = jsyn(np.random.default_rng(seed), jload(yaml), 4)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["focal_mean", "focal_sum", "weighted_ce_ignore", "ce_mean",
                                  "aux_contrastive_loss", "box_losses"])
def test_losses_match_jax(name):
    import jax.numpy as jnp

    from uvltrack_tpu.train import losses as jl
    from uvltrack_tpu_torch.train import losses as tl

    rng = np.random.default_rng(4)
    boxes = np.stack([rng.uniform(0, 0.6, 8), rng.uniform(0, 0.6, 8),
                      rng.uniform(0.1, 0.5, 8), rng.uniform(0.1, 0.5, 8)], -1).astype(np.float32)
    if name.startswith("focal"):
        pred = rng.uniform(0.01, 0.99, (8, 256)).astype(np.float32)
        gt = rng.uniform(0, 1, (8, 256)).astype(np.float32)
        gt[:, 17] = 1.0
        red = name.split("_")[1]
        args, kw = (pred, gt), dict(reduction=red)
        fn = "gauss_weighted_focal_loss"
    elif name == "weighted_ce_ignore":
        args, kw, fn = (rng.normal(size=(64, 2)).astype(np.float32),
                        rng.integers(-1, 2, 64).astype(np.int32),
                        np.asarray([0.8, 0.2], np.float32)), {}, name
    elif name == "ce_mean":
        args, kw, fn = (rng.normal(size=(64, 10)).astype(np.float32),
                        rng.integers(0, 10, 64).astype(np.int32)), {}, name
    elif name == "aux_contrastive_loss":
        args, kw, fn = (rng.normal(size=(8, 3, 16, 16)).astype(np.float32), boxes), {}, name
    else:
        args, kw, fn = (rng.uniform(0.2, 0.8, (8, 1, 4)).astype(np.float32), boxes), {}, name
    got = getattr(tl, fn)(*(torch.from_numpy(a) for a in args), **kw)
    ref = getattr(jl, fn)(*(jnp.asarray(a) for a in args), **kw)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple)
                    else (ref,)):
        _close(g, r)


# ------------------------------------------------------- forward and loss
def test_train_forward_and_batch_stats_match_flax(jx):
    """UVLTrack.forward(train=True): every output against flax's, and the
    BN running stats the port updates in place against flax's new
    batch_stats (0.9 * old + 0.1 * the batch's biased statistics)."""
    from uvltrack_tpu_torch.core.geometry import anno2mask, rotate_half_batch
    from uvltrack_tpu_torch.train.actor import flatten_batch

    tm = _port(jx)
    fb = flatten_batch(_tb(jx["batch"]))
    out = tm(fb["template_images"], fb["search_images"], fb["text"], fb["text_mask"],
             anno2mask(fb["template_anno"], 2), rotate_half_batch(anno2mask(fb["search_anno"], 4)),
             fb["flag"], train=True)
    for k in ("cls_score", "bbox_map", "pred_boxes", "cont_score", "prompts", "logits",
              "search", "template", "text"):
        _close(out[k], jx["out"][k])
    new = from_jax_variables(jx["v"]["params"], jx["bs"])
    stats = {n: b for n, b in tm.named_buffers() if "running" in n}
    assert len(stats) == 4 * 4 * 2
    for n, b in stats.items():
        _close(b, new[n])


def test_forward_and_loss_and_every_gradient_match_jax(jx):
    from uvltrack_tpu_torch.train.actor import forward_and_loss

    tm = _port(jx)
    loss, metrics = forward_and_loss(tm, _tb(jx["batch"]), _cfg(jx), train=True)
    _close(loss, jx["loss"])
    assert set(metrics) == set(jx["metrics"])
    for k, v in metrics.items():
        _close(v, jx["metrics"][k])
    loss.backward()
    ref = from_jax_variables(jx["grads"], jx["v"]["batch_stats"])
    named = {n: p.grad for n, p in tm.named_parameters()}
    assert set(named) <= set(ref) and len(named) > 100
    _grads_close(named, ref)


def test_eval_metrics_match_jax_and_leave_bn_stats(jx):
    from uvltrack_tpu_torch.train.step import TrainState, make_eval_step

    tm = _port(jx)
    before = {n: b.clone() for n, b in tm.named_buffers()}
    metrics = make_eval_step(tm, _cfg(jx))(TrainState(tm, None), _tb(jx["batch"]))
    assert "Acc@0.5" in metrics and set(metrics) == set(jx["eval"])
    for k, v in metrics.items():
        _close(v, jx["eval"][k])
    assert all(torch.equal(b, before[n]) for n, b in tm.named_buffers())


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("learnable_pos", [False, True])
def test_param_labels_match_jax(jx, learnable_pos):
    from uvltrack_tpu.train.optim import param_labels as jlabels
    from uvltrack_tpu_torch.train.optim import param_labels

    from uvltrack_tpu_torch.models.convert import state_key, uvltrack_rules

    labels = param_labels(_port(jx), learnable_pos)
    jl = jlabels(jx["v"]["params"], learnable_pos)
    ref = {}
    for src, dst, _ in uvltrack_rules(2, 1)[0]:
        leaf = jl
        for k in dst:
            leaf = leaf[k]
        ref[state_key(src)] = leaf
    assert labels == ref
    frozen = {n for n, lab in labels.items() if lab == "frozen"}
    assert frozen == (set() if learnable_pos else
                      {"backbone.vit.pos_embed_z", "backbone.vit.pos_embed_x"})


@pytest.mark.parametrize("kind", ["CosineAnnealingLR", "step", "Mstep", "WarmMstep"])
def test_lr_schedules_match_jax(jx, kind):
    from uvltrack_tpu.train.optim import lr_schedule as jsched
    from uvltrack_tpu_torch.train.optim import lr_schedule

    cfg = _cfg(jx)
    cfg.TRAIN.EPOCH = 100
    cfg.TRAIN.SCHEDULER.TYPE = kind
    cfg.TRAIN.LR_DROP_EPOCH = 40
    cfg.TRAIN.SCHEDULER.MILESTONES = [30, 60]
    cfg.TRAIN.SCHEDULER.WARM_EPOCH = 5
    ours, ref = lr_schedule(cfg, 10), jsched(type(jx["cfg"])(cfg.to_dict()), 10)
    for step in (0, 9, 10, 45, 299, 300, 399, 400, 599, 600, 655, 999):
        # the JAX schedule computes in fp32: within its rounding of LR
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * cfg.TRAIN.LR)


@pytest.mark.parametrize("learnable_pos", [False, True])
def test_adamw_step_matches_optax(jx, learnable_pos):
    """The same gradients (the JAX package's) through TrainOptimizer and
    through build_optimizer's optax chain: the parameters after one step,
    grad_norm, and the position embeddings unchanged when frozen. The
    clip engages (grad_norm > GRAD_CLIP_NORM)."""
    import jax
    import optax

    from uvltrack_tpu.train.optim import build_optimizer as jbuild
    from uvltrack_tpu_torch.train.optim import build_optimizer

    cfg = _cfg(jx, **{"MODEL.LEARNABLE_POSITION": learnable_pos})
    jcfg = type(jx["cfg"])(cfg.to_dict())
    tm = _port(jx)
    tm.backbone.learnable_pos = learnable_pos  # what build_model sets from the cfg
    grads = from_jax_variables(jx["grads"], jx["v"]["batch_stats"])
    for n, p in tm.named_parameters():
        p.grad = grads[n].clone()
    pos0 = tm.backbone.vit.pos_embed_z.detach().clone()
    opt = build_optimizer(cfg, tm, steps_per_epoch=10)
    norm = opt.step(0)
    ref_norm = float(optax.global_norm(jx["grads"]))
    assert ref_norm > float(cfg.TRAIN.GRAD_CLIP_NORM)
    _close(norm, ref_norm)
    tx = jbuild(jcfg, jx["v"]["params"], steps_per_epoch=10)
    params = jax.tree_util.tree_map(np.asarray, jx["v"]["params"])
    upd, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(jx["grads"], params)
    new = from_jax_variables(_tree(optax.apply_updates(params, upd)), jx["v"]["batch_stats"])
    for n, p in tm.named_parameters():
        _close(p, new[n], atol=1e-6, rtol=0)
    assert torch.equal(tm.backbone.vit.pos_embed_z, pos0) != learnable_pos


def test_train_step_grad_norm_and_update(jx):
    """The port's whole step (GRAD_ACCUM=1): grad_norm equals optax's
    global norm of JAX's gradients, the metrics JAX's, the step count
    advances, frozen position embeddings stay, the qkv weights move."""
    import optax

    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state, make_train_step

    cfg = _cfg(jx)
    tm = _port(jx)
    pos0, qkv0 = (tm.backbone.vit.pos_embed_x.detach().clone(),
                  tm.backbone.vit.blocks[0].attn.qkv.weight.detach().clone())
    opt = build_optimizer(cfg, tm, 10)
    state, metrics = make_train_step(tm, opt, cfg)(create_train_state(tm, opt), _tb(jx["batch"]))
    assert state.step == 1
    _close(metrics["grad_norm"], float(optax.global_norm(jx["grads"])))
    _close(metrics["Loss/total"], jx["loss"])
    assert torch.equal(tm.backbone.vit.pos_embed_x, pos0)
    assert not torch.equal(tm.backbone.vit.blocks[0].attn.qkv.weight, qkv0)


def test_grad_accum_matches_the_jax_accumulated_step(jx):
    """TPU.GRAD_ACCUM=2 (REDUCTION mean): the accumulated gradients, the
    averaged metrics, grad_norm and the last microbatch's BN stats against
    the JAX scan's, through a recording optimizer on the port's side and
    optax.scale(1e6) on JAX's."""
    from uvltrack_tpu_torch.train.optim import global_norm
    from uvltrack_tpu_torch.train.step import _split_microbatches, make_train_step, TrainState

    class Recorder:
        def step(self, step):
            self.grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
            return global_norm(list(self.grads.values()))

    cfg = _cfg(jx, **{"TPU.GRAD_ACCUM": 2})
    tm = _port(jx)
    rec = Recorder()
    batch = _tb(jx["batch"])
    micro = _split_microbatches(batch, 2)
    assert micro["search_images"].shape[:3] == (2, 2, 2) and micro["flag"].shape == (2, 2)
    _, metrics = make_train_step(tm, rec, cfg)(TrainState(tm, rec), batch)
    ref = from_jax_variables(jx["acc_grads"], jx["v"]["batch_stats"])
    _grads_close(rec.grads, ref)
    for k, v in metrics.items():
        _close(v, jx["acc_metrics"][k])
    bs = from_jax_variables(jx["v"]["params"], jx["acc_bs"])
    for n, b in tm.named_buffers():
        if "running" in n:
            _close(b, bs[n])


# ---------------------------------------------------- remat, drop path, LS
def test_remat_gradients_equal_the_plain_gradients(jx):
    """TPU.REMAT (torch.utils.checkpoint around every ViT block and BERT
    layer): the same loss and bitwise the same gradients."""
    from uvltrack_tpu_torch.train.actor import forward_and_loss

    grads = []
    for remat in (False, True):
        tm = _port(jx, remat=remat)
        loss, _ = forward_and_loss(tm, _tb(jx["batch"]), _cfg(jx))
        loss.backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])


def test_drop_path_draws_from_the_generator(jx):
    """DROP_PATH_RATE > 0: a train forward needs an explicit generator; one
    seed gives the same masks (the same loss, bitwise), another differs; a
    block whose two branches are dropped returns its input, a kept branch
    is divided by 1 - drop_path; inference draws nothing."""
    from uvltrack_tpu_torch.ops.attention import attention_ln_qkv_core, attn_proj_core
    from uvltrack_tpu_torch.train.actor import forward_and_loss

    tm = _port(jx, drop_path_rate=0.5)
    assert [b.drop_path for b in tm.backbone.vit.blocks] == [0.0, 0.5]
    batch, cfg = _tb(jx["batch"]), _cfg(jx)
    with pytest.raises(ValueError, match="generator"):
        forward_and_loss(tm, batch, cfg)
    losses = [float(forward_and_loss(tm, batch, cfg, generator=torch.Generator().manual_seed(s))[0])
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    assert torch.isfinite(forward_and_loss(tm, batch, cfg, train=False)[0])
    blk, x = tm.backbone.vit.blocks[1], torch.randn(3, 29, 32)
    with torch.no_grad():
        assert torch.equal(blk(x, None, torch.zeros(2, 3, dtype=torch.bool)), x)
        attn_only = blk(x, None, torch.tensor([[True, False, True], [False] * 3]))
        a, ln = blk.attn, blk.norm1
        attn = attn_proj_core(attention_ln_qkv_core(x, ln.weight, ln.bias, a.qkv.weight,
                                                    a.qkv.bias, 4), a.proj.weight, a.proj.bias)
    assert torch.equal(attn_only[1], x[1])
    _close(attn_only[[0, 2]], (x + attn / 0.5)[[0, 2]])


def _load_block(tb, params):
    """A flax VitBlock's params into the port's VitBlock (models/convert.py's
    rule table for block 0, and the LayerScale gammas)."""
    from uvltrack_tpu_torch.models.convert import _vit_block_rules

    own = tb.state_dict()
    with torch.no_grad():
        for src, dst, tf in _vit_block_rules(0):
            v = params
            for k in dst[2:]:
                v = v[k]
            own[src[len("vit.blocks.0."):]].copy_(torch.from_numpy(np.array(tf(v) if tf else v)))
        for j in (1, 2):
            own[f"ls{j}.gamma"].copy_(torch.from_numpy(np.array(params[f"ls{j}_gamma"])))


def test_layer_scale_block_matches_flax():
    """VitBlock's LayerScale (init_values; off in the shipped configs) on
    the composed branch against the flax VitBlock."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_model import _perturb
    from uvltrack_tpu.models.vit import VitBlock as JBlock
    from uvltrack_tpu_torch.models.vit import VitBlock

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    masked = np.zeros((2, 21), bool)
    masked[0, -5:] = True
    jb = JBlock(32, 4, init_values=0.3)
    v = _perturb(_tree(jax.jit(lambda r: jb.init(r, x, masked))(jax.random.PRNGKey(0))),
                 np.random.default_rng(1))
    ref = jax.jit(lambda var: jb.apply(var, jnp.asarray(x), jnp.asarray(masked)))(v)
    tb = VitBlock(32, 4, init_values=0.3)
    _load_block(tb, v["params"])
    with torch.no_grad():
        _close(tb(torch.from_numpy(x), torch.from_numpy(masked)), ref)


def test_from_jax_variables_carries_layer_scale_and_fp32(jx):
    """ls1_gamma / ls2_gamma where a block carries them; fp32 parameters and
    batch_stats cross without a cast (bitwise), into fp32 parameters."""
    from uvltrack_tpu_torch.models.vit import LayerScale

    params = {**jx["v"]["params"], "backbone": dict(jx["v"]["params"]["backbone"])}
    rng = np.random.default_rng(2)
    params["backbone"]["block_0"] = dict(params["backbone"]["block_0"],
                                         ls1_gamma=rng.normal(size=32).astype(np.float32),
                                         ls2_gamma=rng.normal(size=32).astype(np.float32))
    state = from_jax_variables(params, jx["v"]["batch_stats"])
    tm = _port_model()
    tm.backbone.vit.blocks[0].ls1 = LayerScale(32, 1.0)
    tm.backbone.vit.blocks[0].ls2 = LayerScale(32, 1.0)
    assert load_reference_state(tm, state) == []
    np.testing.assert_array_equal(tm.backbone.vit.blocks[0].ls2.gamma.detach().numpy(),
                                  params["backbone"]["block_0"]["ls2_gamma"])
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_array_equal(tm.backbone.vit.blocks[1].attn.qkv.weight.detach().numpy(),
                                  jx["v"]["params"]["backbone"]["block_1"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        tm.box_head.conv_cls[0][1].running_var.numpy(),
        jx["v"]["batch_stats"]["head"]["conv_cls"]["stage_0"]["bn"]["var"])


# ------------------------------------------------- checkpoints and trainer
def _state(jx, seed_shift=0.0):
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state

    tm = _port(jx)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(seed_shift)
    return create_train_state(tm, build_optimizer(_cfg(jx), tm, 2))


def _train_steps(jx, state, n=1):
    from uvltrack_tpu_torch.train.step import make_train_step

    step = make_train_step(state.model, state.optimizer, _cfg(jx))
    for _ in range(n):
        state, _ = step(state, _tb(jx["batch"]))
    return state


def _same_state(a, b):
    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}."))
            elif isinstance(v, list):
                out.update(flat(dict(enumerate(v)), f"{pre}{k}."))
            else:
                out[pre + str(k)] = v
        return out
    fa, fb = flat(a.state_dict()), flat(b.state_dict())
    assert fa.keys() == fb.keys()
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_round_trip_and_retention(jx, tmp_path):
    """A TrainState after a step (model, BN stats, Adam moments, step) saves
    and restores into a fresh one exactly; ep%04d.pt numbering; the last
    keep_last epochs and every keep_every-th are kept; restore_raw."""
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager

    state = _train_steps(jx, _state(jx))
    ck = CheckpointManager(str(tmp_path), keep_last=2, keep_every=3)
    assert not ck.has_checkpoint()
    for ep in range(1, 8):
        if ep % 2:
            ck.save_async(ep, state, {"train": {"loss": float(ep)}})
        else:
            ck.save(ep, state)
    assert ck.epochs() == [3, 6, 7]
    assert sorted(os.listdir(tmp_path)) == ["ep0003.pt", "ep0006.pt", "ep0007.pt"]
    fresh = _state(jx, seed_shift=1.0)
    fresh, extra, ep = ck.restore(fresh)
    assert (ep, extra, fresh.step) == (7, {"train": {"loss": 7.0}}, 1)
    _same_state(state, fresh)
    raw, _, ep = ck.restore_raw(str(tmp_path / "ep0006.pt"))
    assert ep == 6 and set(raw) == {"model", "optimizer", "step"}
    _, _, ep = ck.restore(fresh, epoch=3)
    assert ep == 3


def test_async_save_error_surfaces_at_wait(jx, tmp_path):
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager

    ck = CheckpointManager(str(tmp_path))
    (tmp_path / "ep0001.pt").mkdir()  # the atomic rename onto it fails
    ck.save_async(1, _state(jx))
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error is raised once


def _synthetic_loader(n, seed=0):
    from uvltrack_tpu_torch.data.synthetic import synthetic_batch

    class Loader:
        def __iter__(self):
            rng = np.random.default_rng(seed)
            for _ in range(n):
                yield _tb(synthetic_batch(rng, 4, n_search=2, template_size=32, search_size=64,
                                          n_text=8, vocab=100))
    return Loader()


def test_trainer_resumes_and_logs(jx, tmp_path):
    """Epoch 1, then a new Trainer on a fresh state resumes from its
    checkpoint (the saved state, bitwise) and trains epoch 2; the .log and
    .jsonl carry finite losses; validate() reports Acc@0.5."""
    from uvltrack_tpu_torch.train.step import make_eval_step, make_train_step
    from uvltrack_tpu_torch.train.trainer import Trainer

    cfg = _cfg(jx)
    log = str(tmp_path / "logs" / "run.log")

    def trainer(state):
        return Trainer(cfg, make_train_step(state.model, state.optimizer, cfg), state,
                       _synthetic_loader(2), {"val": _synthetic_loader(1, seed=5)},
                       eval_step=make_eval_step(state.model, cfg),
                       checkpoint_dir=str(tmp_path / "ck"), log_path=log)

    cfg.TRAIN.VAL_EPOCH_INTERVAL = 1
    first = trainer(_state(jx))
    first.train(1)
    second = trainer(_state(jx, seed_shift=1.0))
    loaded = []
    orig = second.train_epoch

    def spy():
        loaded.append({n: p.detach().clone() for n, p in second.state.model.named_parameters()})
        return orig()
    second.train_epoch = spy
    second.train(2)
    ref = dict(first.state.model.named_parameters())
    assert all(torch.equal(v, ref[n]) for n, v in loaded[0].items())
    assert second.epoch == 2 and second.state.step == 4
    text = Path(log).read_text()
    assert "resumed from epoch 1" in text and "[epoch 2/2]" in text
    recs = [json.loads(line) for line in Path(log + ".jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["train"]["Loss/total"]) for r in recs)
    assert "Acc@0.5" in recs[1]["val"]["val"]


def _tiny_cli(monkeypatch):
    """The micro model's widths on the port's build_model (VIT_VARIANTS and
    the BERT config), as tests/test_torch_port_cli_test.py stands in."""
    from uvltrack_tpu_torch.models import bert as tbert
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.vit import VIT_VARIANTS

    monkeypatch.setitem(VIT_VARIANTS, "base", dict(embed_dim=32, depth=2, num_heads=4))
    # BERT's vocabulary stays: the synthetic batch draws ids from 30522
    monkeypatch.setattr(tuv, "bert_config_from_type", lambda t: tbert.BertConfig(
        hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
        max_position=16))
    return ["--config", "_smoke_cpu", "--synthetic", "2", "--device", "cpu", "--batch_size", "4",
            "--set", "MODEL.HIDDEN_DIM=32", "--set", "MODEL.HEAD.HEAD_DIM=32",
            "--set", "MODEL.BACKBONE.FUSION_LAYER=[1]",
            "--set", "MODEL.BACKBONE.CONT_LOSS_LAYER=[0,1]",
            "--set", "MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN=8",
            "--set", "TRAIN.PRINT_INTERVAL=1", "--set", "TRAIN.VAL_EPOCH_INTERVAL=0"]


def test_cli_train_synthetic_checkpoints_and_resumes(monkeypatch, tmp_path, capsys):
    """cli.train.main --synthetic 2 --device cpu on _smoke_cpu.yaml (its
    TPU.GRAD_ACCUM=2) cut to the micro widths: epoch 1, then --epochs 2
    resumes at epoch 2; finite losses; a checkpoint an epoch; the missing
    pretrained files are skipped with a warning."""
    from uvltrack_tpu_torch.cli import train as ctrain

    argv = _tiny_cli(monkeypatch) + ["--save_dir", str(tmp_path)]
    t1 = ctrain.main(argv + ["--epochs", "1"])
    assert t1.cfg.TPU.GRAD_ACCUM == 2 and t1.state.step == 2
    err = capsys.readouterr().err
    assert "MAE weights not found" in err and "BERT archive not found" in err
    t2 = ctrain.main(argv + ["--epochs", "2"])
    assert t2.epoch == 2 and t2.state.step == 4
    ck = tmp_path / "checkpoints" / "train" / "uvltrack" / "_smoke_cpu"
    assert sorted(os.listdir(ck)) == ["ep0001.pt", "ep0002.pt"]
    log = tmp_path / "logs" / "uvltrack-_smoke_cpu.log"
    assert "resumed from epoch 1" in log.read_text()
    recs = [json.loads(x) for x in (log.parent / (log.name + ".jsonl")).read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(np.isfinite(v) for r in recs for v in r["train"].values())


def test_cli_train_refuses_what_the_port_lacks(monkeypatch):
    """--multihost needs all of torchrun's environment and names what is
    missing (it trains: tests/test_torch_port_parallel.py); a mesh of
    processes without --multihost is refused; without a card, --device
    cuda stops before the model is built (real data:
    tests/test_torch_port_train_data.py)."""
    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.parallel.mesh import DIST_ENV

    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(SystemExit, match="MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK not set"):
        ctrain.main(["--synthetic", "1", "--multihost", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --multihost"):
        ctrain.main(_tiny_cli(monkeypatch) + ["--set", "TPU.MESH_DATA=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctrain.main(_tiny_cli(monkeypatch) + ["--device", "cuda"])


# ------------------------------------------------------------- pretrained
def test_load_pretrained_matches_jax_converters(jx, tmp_path):
    """An MAE ViT state dict and a BERT archive (tar.gz holding
    pytorch_model.bin, old gamma/beta names, 'bert.' prefixes), written by
    the test from random numbers, through the port's load_pretrained and
    the JAX package's: the same parameters."""
    import tarfile

    from uvltrack_tpu.models import convert as jconv
    from uvltrack_tpu_torch.models.convert import load_pretrained
    from uvltrack_tpu_torch.eval.environment import env_settings

    rng = np.random.default_rng(11)
    tm = _port(jx)
    own = tm.state_dict()
    mae = {k[len("backbone.vit."):]: torch.from_numpy(rng.normal(size=tuple(v.shape))
                                                        .astype(np.float32))
           for k, v in own.items() if k.startswith("backbone.vit.") and
           (k.startswith("backbone.vit.blocks.") or "patch_embed" in k or k.endswith("cls_token"))}
    mae["pos_embed"] = torch.zeros(1, 197, 32)
    mae["blocks.5.norm1.weight"] = torch.ones(32)  # a block the model does not have
    bert = {}
    for k, v in own.items():
        if k.startswith("backbone.bert."):
            name = "bert." + k[len("backbone.bert."):]
            name = name.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
                "LayerNorm.bias", "LayerNorm.beta")
            bert[name] = torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
    torch.save({"model": mae}, tmp_path / "mae.pth")
    (tmp_path / "bert").mkdir()
    torch.save(bert, tmp_path / "bert" / "pytorch_model.bin")
    with tarfile.open(tmp_path / "bert.tar.gz", "w:gz") as tar:
        tar.add(tmp_path / "bert" / "pytorch_model.bin", arcname="bert/pytorch_model.bin")
    cfg = _cfg(jx, **{"MODEL.BACKBONE.PRETRAINED_PATH": str(tmp_path / "mae.pth"),
                      "MODEL.BACKBONE.LANGUAGE.PATH": str(tmp_path / "bert.tar.gz")})
    before = tm.backbone.vit.blocks[0].attn.qkv.weight.detach().clone()
    load_pretrained(cfg, tm, env_settings())
    jparams = jconv.load_pretrained(type(jx["cfg"])(cfg.to_dict()),
                                    {"params": jx["v"]["params"]}, env_settings())["params"]
    ref = from_jax_variables(jparams, jx["v"]["batch_stats"])
    for n, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), ref[n].numpy(), err_msg=n)
    assert not torch.equal(tm.backbone.vit.blocks[0].attn.qkv.weight, before)


def test_build_model_reads_the_training_knobs(monkeypatch):
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model

    argv = _tiny_cli(monkeypatch)  # the micro widths
    cfg = load_cfg(str(REPO / "experiments/uvltrack/_smoke_cpu.yaml"))
    cfg.merge_from_list([a for a in argv[argv.index("--set"):] if a != "--set"])
    cfg.MODEL.BACKBONE.DROP_PATH_RATE = 0.2
    cfg.MODEL.LEARNABLE_POSITION = True
    cfg.TPU.REMAT = True
    m = build_model(cfg, device="cpu")
    assert m.backbone.remat and m.backbone.learnable_pos
    assert [b.drop_path for b in m.backbone.vit.blocks] == [0.0, 0.2]
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_port_imports_no_optax():
    """The grep of tests/test_torch_port_ops.py covers jax, flax and the JAX
    package; training adds optax to the list."""
    files = sorted((REPO / "uvltrack_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import optax|from optax)", re.M)
    assert {"train/step.py", "train/optim.py", "cli/train.py", "ops/autograd.py"} <= {
        str(p.relative_to(REPO / "uvltrack_tpu_torch")) for p in files[:-1]}
    assert [str(p) for p in files if pat.search(p.read_text())] == []
