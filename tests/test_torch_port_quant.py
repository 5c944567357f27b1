"""Weight-only int8 in uvltrack_tpu_torch against the JAX package: the
quantization recipe and its selection, the plain versions of the q8 kernels
(#5, #6) and of the bf16 fused-projection kernel (#4) against the Pallas
kernels run in interpret mode, the int8 attention/MLP entry points and the
head's int8 conv against their JAX counterparts, and the int8 model and
tracker against the JAX package's. Tests marked `gpu` (skipped without a
card) hold the new CUDA instantiations against their plain versions and
count the launches of each dispatch on the card.

Inputs come from numpy seeds and go through both frameworks. Tolerances:
fp32 compute at 5e-5 abs / 5e-4 rel (the JAX package's own bound for the q8
kernels, tests/test_quant.py); bf16 compute at two bf16 steps of the
output's scale (one rounding may fall the other way where sums are taken in
another order); models and trackers at the bounds of
tests/test_torch_port_model.py and tests/test_torch_port_tracker.py.

The machine with the card has no JAX, so JAX is imported inside the CPU
tests, and the `gpu` tests run there with
`python -m pytest tests/test_torch_port_quant.py -m gpu --noconftest`.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_port_ops import _ln_case, _t
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
from uvltrack_tpu_torch.ops import quant

ATOL, RTOL = 5e-5, 5e-4
XDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _jax():
    """The oracle: the JAX package's Pallas kernels and quantization."""
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import pallas_attention as pa
    from uvltrack_tpu.ops import quant as jquant
    return jnp, pa, jquant


def _close(out, ref, compute: str, atol=ATOL, rtol=RTOL):
    """fp32: atol/rtol; bf16: two bf16 steps at the output's largest value."""
    out = np.asarray(out.detach().float() if torch.is_tensor(out) else out, np.float32)
    ref = np.asarray(ref, np.float32)
    if compute == "bf16":
        step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        atol, rtol = 2 * step, 0.0
    np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def _proj_case(c=64, seed=17):
    rng = np.random.default_rng(seed)
    wp = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)  # flax (in, out)
    bp = (rng.normal(size=(c,)) * 0.02).astype(np.float32)
    return wp, bp


# --------------------------------------------------------- quantization
@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_weight_is_bit_exact_with_jax(bf16):
    """Payload identical after the transpose, scale exactly equal; from a
    bf16-cast weight too (prepare_inference_model casts first)."""
    jnp, _, jquant = _jax()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(48, 80)) * 0.3).astype(np.float32)  # flax (in, out)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    jw = jnp.asarray(w).astype(jnp.bfloat16) if bf16 else jnp.asarray(w)
    tw = _t(w.T).to(torch.bfloat16) if bf16 else _t(w.T)
    jqt, tqt = jquant.quantize_weight(jw), quant.quantize_weight(tw)
    assert tqt.q.dtype == torch.int8 and tuple(tqt.q.shape) == (80, 48)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q).T)
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(tqt.materialize(torch.float32).numpy(),
                                  np.asarray(jqt.materialize(jnp.float32)).T)


def test_quant_dot_matches_jax_quant_dot():
    jnp, _, jquant = _jax()
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(48, 80)) * 0.2).astype(np.float32)
    y = rng.normal(size=(10, 48)).astype(np.float32)
    ref = jquant.quant_dot(jnp.asarray(y), jquant.quantize_weight(jnp.asarray(w)))
    out = quant.quant_dot(_t(y), quant.quantize_weight(_t(w.T)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    dense = quant.quant_dot(_t(y), quant.quantize_weight(_t(w.T)).materialize())
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)


def test_quantize_vit_params_picks_jax_selection_on_the_tiny_model():
    """min_dim=1 on the tiny model: the same 32 tensors as the JAX package
    (16 ViT matmuls + 16 tower convs), each payload and scale bit for bit,
    and none of BERT, the patch embedding or a final 1x1 conv."""
    jnp, _, jquant = _jax()
    from test_torch_port_model import make_pair
    from uvltrack_tpu_torch.models.convert import state_key, uvltrack_rules

    _, v, tm = make_pair(seed=21)
    jparams = jquant.quantize_vit_params(v["params"], min_dim=1)
    quant.quantize_vit_params(tm, min_dim=1)
    assert jquant.count_quantized(jparams) == quant.count_quantized(tm) == 32
    mods = dict(tm.named_modules())
    bk = v["params"]["backbone"]
    rules, _ = uvltrack_rules(sum(k.startswith("block_") for k in bk),
                              sum(k.startswith("bert_layer_") for k in bk))
    picked = 0
    for src, dst, tf in rules:
        leaf = jparams
        for k in dst:
            leaf = leaf[k]
        key = state_key(src)
        mod = mods[key.rsplit(".", 1)[0]]
        if not isinstance(leaf, jquant.QuantizedTensor):
            assert "weight_q" not in mod._buffers or not key.endswith(".weight"), key
            continue
        picked += 1
        q = np.asarray(leaf.q)
        np.testing.assert_array_equal(mod.weight_q.numpy(), tf(q), err_msg=key)
        np.testing.assert_array_equal(mod.weight_scale.numpy(), np.asarray(leaf.scale))
    assert picked == 32
    assert "weight" in dict(tm.backbone.vit.patch_embed.proj.named_parameters())
    assert quant.count_quantized(tm.backbone.bert) == 0


def test_uvltrack_b_quantizes_56_tensors_bit_exact_with_jax():
    """UVLTrack-B (12 blocks x 4 matmuls + stages 0/1 of the 4 towers at
    HEAD_DIM=256) from prepare_inference_model: 56 tensors, each equal to
    the JAX recipe on the same bf16-cast weight, and a second call changes
    nothing."""
    jnp, _, jquant = _jax()
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    cfg = load_cfg("experiments/uvltrack/_smoke_cpu.yaml")
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.WEIGHT_QUANT = "int8"
    m = build_model(cfg, device="cpu", seed=1)
    bf16 = {n: p.detach().to(torch.bfloat16) for n, p in m.named_parameters()}
    prepare_inference_model(cfg, m)
    mods = quant.quantized_modules(m)
    assert len(mods) == quant.count_quantized(m) == 56
    assert sum(n.startswith("backbone.vit.blocks.") for n, _ in mods) == 48
    assert sorted({n.split(".")[-2] for n, _ in mods if n.startswith("box_head")}) == ["0", "1"]
    for name, mod in mods:
        w = bf16[name + ".weight"].float().numpy()
        flax = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)  # (in, out) / HWIO
        jqt = jquant.quantize_weight(jnp.asarray(flax).astype(jnp.bfloat16))
        back = np.asarray(jqt.q).T if w.ndim == 2 else np.asarray(jqt.q).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(mod.weight_q.numpy(), back, err_msg=name)
        np.testing.assert_array_equal(mod.weight_scale.numpy(), np.asarray(jqt.scale))
    saved = quant.quantized_bytes_saved(m)
    assert saved == sum(md.weight_q.numel() - 4 * md.weight_scale.numel() for _, md in mods)
    before = {n: md.weight_q.clone() for n, md in mods}
    prepare_inference_model(cfg, m)
    assert quant.count_quantized(m) == 56 and quant.quantized_bytes_saved(m) == saved
    for n, md in quant.quantized_modules(m):
        assert torch.equal(md.weight_q, before[n]), n


def test_prepare_inference_model_is_idempotent_and_checks_the_mode():
    from test_torch_port_model import make_pair
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import prepare_inference_model

    cfg = load_cfg("experiments/uvltrack/_smoke_cpu.yaml")
    cfg.TPU.WEIGHT_QUANT = "int8"
    _, _, tm = make_pair(seed=22)
    prepare_inference_model(cfg, tm)
    # the tiny model's widths are below the 128 gate: quantize its whole
    # selection, from the cast values as prepare_inference_model does
    quant.quantize_vit_params(tm, min_dim=1)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    prepare_inference_model(cfg, tm)
    assert quant.count_quantized(tm) == 32
    after = tm.state_dict()
    assert sorted(after) == sorted(state)
    for k, v in state.items():
        assert torch.equal(after[k], v), k
    # the int8 buffers are not parameters: the bf16 cast leaves them alone
    assert all(p.dtype != torch.int8 for p in tm.parameters())
    cfg.TPU.WEIGHT_QUANT = "int4"
    with pytest.raises(ValueError, match="WEIGHT_QUANT"):
        prepare_inference_model(cfg, tm)


# ------------------------------------------------------- kernel plain versions
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 361])
def test_q8_prefix_plain_matches_pallas_kernel(n, mask, x_dtype):
    """Kernel #5's plain version == _ln_qkv_attn_kernel_q8 in the Pallas
    interpreter, computing in x's dtype."""
    jnp, pa, jquant = _jax()
    x, g, be, w, wb, kb = _ln_case(n, mask=mask, seed=31)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    jqt = jquant.quantize_weight(jnp.asarray(w))
    ref = pa.fused_ln_qkv_attention_q8(jx, jnp.asarray(g), jnp.asarray(be), jqt.q, jqt.scale,
                                       jnp.asarray(wb), jnp.asarray(kb), heads=4,
                                       interpret=True)
    tq = quant.quantize_weight(_t(w.T))
    out = lqa.ln_qkv_attention_q8_plain(_t(x).to(XDT[x_dtype]), _t(g), _t(be), tq.q,
                                        tq.scale, _t(wb), _t(kb), heads=4)
    assert out.dtype == XDT[x_dtype]
    _close(out, np.asarray(ref.astype(jnp.float32)), x_dtype)


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 361])
def test_q8_proj_plain_matches_pallas_kernel(n, mask, x_dtype):
    """Kernel #6's plain version == _ln_qkv_attn_proj_kernel_q8 in the
    Pallas interpreter: post-residual, in x's dtype."""
    jnp, pa, jquant = _jax()
    x, g, be, w, wb, kb = _ln_case(n, mask=mask, seed=32)
    wp, bp = _proj_case()
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    jqt, jqp = jquant.quantize_weight(jnp.asarray(w)), jquant.quantize_weight(jnp.asarray(wp))
    ref = pa.fused_ln_qkv_attn_proj_q8(jx, jnp.asarray(g), jnp.asarray(be), jqt.q, jqt.scale,
                                       jnp.asarray(wb), jqp.q, jqp.scale, jnp.asarray(bp),
                                       jnp.asarray(kb), heads=4, interpret=True)
    tq, tp = quant.quantize_weight(_t(w.T)), quant.quantize_weight(_t(wp.T))
    out = lqp.ln_qkv_attn_proj_q8_plain(_t(x).to(XDT[x_dtype]), _t(g), _t(be), tq.q, tq.scale,
                                        _t(wb), tp.q, tp.scale, _t(bp), _t(kb), heads=4)
    assert out.dtype == XDT[x_dtype]
    _close(out, np.asarray(ref.astype(jnp.float32)), x_dtype)


@pytest.mark.parametrize("dtypes", ["fp32x-fp32w", "fp32x-bf16w", "bf16x-bf16w"])
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 361])
def test_fused_proj_plain_matches_pallas_kernel(n, mask, dtypes):
    """Kernel #4's plain version == _ln_qkv_attn_proj_kernel in the Pallas
    interpreter: computing in the weights' dtype, the projection rounded
    once to x's dtype, the residual added in x's dtype."""
    jnp, pa, _ = _jax()
    x, g, be, w, wb, kb = _ln_case(n, mask=mask, seed=33)
    wp, bp = _proj_case()
    xd, wd = dtypes.split("-")
    jx = jnp.asarray(x).astype(jnp.bfloat16 if xd == "bf16x" else jnp.float32)
    jwd = jnp.bfloat16 if wd == "bf16w" else jnp.float32
    ref = pa.fused_ln_qkv_attn_proj(jx, jnp.asarray(g), jnp.asarray(be),
                                    jnp.asarray(w).astype(jwd), jnp.asarray(wb),
                                    jnp.asarray(wp).astype(jwd), jnp.asarray(bp),
                                    jnp.asarray(kb), heads=4, interpret=True)
    twd = torch.bfloat16 if wd == "bf16w" else torch.float32
    out = lqp.ln_qkv_attn_proj_plain(_t(x).to(XDT[xd[:4]]), _t(g), _t(be), _t(w.T).to(twd),
                                     _t(wb), _t(wp.T).to(twd), _t(bp), _t(kb), heads=4)
    assert out.dtype == XDT[xd[:4]]
    _close(out, np.asarray(ref.astype(jnp.float32)), "bf16" if wd == "bf16w" else "fp32")


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    build.reset_launch_counts()
    x, g, be, w, wb, kb = (_t(a) for a in _ln_case(130, seed=34))
    wp, bp = (_t(a) for a in _proj_case())
    tq, tp = quant.quantize_weight(w.t()), quant.quantize_weight(wp.t())
    for xx in (x, x.to(torch.bfloat16)):
        a = lqa.ln_qkv_attention_q8(xx, g, be, tq.q, tq.scale, wb, kb, 4)
        torch.testing.assert_close(a, lqa.ln_qkv_attention_q8_plain(
            xx, g, be, tq.q, tq.scale, wb, kb, 4), rtol=0, atol=0)
        torch.testing.assert_close(
            lqp.proj_residual(xx, a, tp.q, bp, tp.scale),
            lqp.proj_residual_plain(xx, a, tp, bp), rtol=0, atol=0)
        torch.testing.assert_close(
            lqp.ln_qkv_attn_proj_q8(xx, g, be, tq.q, tq.scale, wb, tp.q, tp.scale, bp, kb, 4),
            lqp.ln_qkv_attn_proj_q8_plain(xx, g, be, tq.q, tq.scale, wb, tp.q, tp.scale, bp,
                                          kb, 4), rtol=0, atol=0)
        wb16, wp16 = w.t().contiguous().bfloat16(), wp.t().contiguous().bfloat16()
        torch.testing.assert_close(
            lqp.ln_qkv_attn_proj(xx, g, be, wb16, wb, wp16, bp, kb, 4),
            lqp.ln_qkv_attn_proj_plain(xx, g, be, wb16, wb, wp16, bp, kb, 4), rtol=0, atol=0)
    assert build.launch_counts() == dict.fromkeys(build.SOURCES, 0)
    assert build.instantiation_counts() == {}


# ------------------------------------------------------------- entry points
@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [21, 130])
def test_int8_attention_block_core_matches_jax(n, compute, fused, monkeypatch):
    """x + proj(attn(qkv(LN x))) with int8 qkv and proj weights, the port's
    "cuda" backend on CPU tensors against the JAX entry point on the CPU:
    both take the XLA-fallback math in the compute dtype, whatever
    UVLTRACK_FUSED_PROJ says."""
    jnp, _, jquant = _jax()
    from uvltrack_tpu.ops import attention as jattn

    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", fused)
    x, g, be, w, wb, kb = _ln_case(n, c=32, b=2, seed=35)
    wp, bp = _proj_case(c=32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (jnp.float32, torch.float32)
    jqt = jquant.quantize_weight(jnp.asarray(w).astype(jd))
    jqp = jquant.quantize_weight(jnp.asarray(wp).astype(jd))
    jb = jnp.asarray(kb)[:, None, None, :]
    ref = jattn.attention_block_core(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jqt,
                                     jnp.asarray(wb), jqp, jnp.asarray(bp), 4, jb,
                                     compute_dtype=jd)
    tq = quant.quantize_weight(_t(w.T).to(td))
    tp = quant.quantize_weight(_t(wp.T).to(td))
    tattn.force_backend("cuda")
    try:
        out = tattn.attention_block_core(_t(x), _t(g), _t(be), tq, _t(wb), tp, _t(bp), 4,
                                         _t(np.asarray(jb)), compute_dtype=td)
    finally:
        tattn.force_backend(None)
    assert out.dtype == torch.float32
    _close(out, np.asarray(ref), compute, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_int8_ln_mlp_core_matches_jax(compute):
    jnp, _, jquant = _jax()
    from uvltrack_tpu.ops import attention as jattn

    rng = np.random.default_rng(36)
    c, f = 32, 128
    x = rng.normal(size=(2, 9, c)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    be = (0.1 * rng.normal(size=c)).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / 6).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / 11).astype(np.float32)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (jnp.float32, torch.float32)
    j1, j2 = (jquant.quantize_weight(jnp.asarray(a).astype(jd)) for a in (w1, w2))
    ref = jattn.ln_mlp_core(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), j1,
                            jnp.asarray(b1), j2, jnp.asarray(b2), compute_dtype=jd)
    t1, t2 = (quant.quantize_weight(_t(a.T).to(td)) for a in (w1, w2))
    out = tattn.ln_mlp_core(_t(x), _t(g), _t(be), t1, _t(b1), t2, _t(b2), compute_dtype=td)
    assert out.dtype == td
    _close(out, np.asarray(ref.astype(jnp.float32)), compute)


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_conv_bn_relu_int8_matches_jax_qconv(compute):
    """The head's int8 conv (QConv with a QuantizedTensor kernel) inside
    ConvBnRelu: the dtype-cast input against the int8 payload, fp32 scale
    and bias, one rounding, then BN and ReLU."""
    jnp, _, jquant = _jax()
    from uvltrack_tpu.models.head import ConvBnRelu as JConvBnRelu
    from uvltrack_tpu_torch.models.head import ConvBnRelu

    rng = np.random.default_rng(37)
    cin, cout = 16, 24
    x = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)  # NHWC
    k = (rng.normal(size=(3, 3, cin, cout)) / 12).astype(np.float32)  # HWIO
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    beta = (0.1 * rng.normal(size=cout)).astype(np.float32)
    mean = (0.1 * rng.normal(size=cout)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (jnp.float32, torch.float32)
    jqk = jquant.quantize_weight(jnp.asarray(k).astype(jd))
    jm = JConvBnRelu(cout, dtype=jd)
    ref = jm.apply({"params": {"conv": {"kernel": jqk, "bias": jnp.asarray(b)},
                               "bn": {"scale": jnp.asarray(scale), "bias": jnp.asarray(beta)}},
                    "batch_stats": {"bn": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}},
                   jnp.asarray(x))
    tm = ConvBnRelu(cin, cout, td).eval()
    with torch.no_grad():
        tm[0].weight.copy_(_t(k.transpose(3, 2, 0, 1)).to(td))
        tm[0].bias.copy_(_t(b))
        tm[1].weight.copy_(_t(scale))
        tm[1].bias.copy_(_t(beta))
        tm[1].running_mean.copy_(_t(mean))
        tm[1].running_var.copy_(_t(var))
    assert quant.quantize_module(tm[0]) and not quant.quantize_module(tm[0])
    np.testing.assert_array_equal(tm[0].weight_q.numpy(),
                                  np.asarray(jqk.q).transpose(3, 2, 0, 1))
    with torch.no_grad():
        out = tm(_t(x.transpose(0, 3, 1, 2)))
    _close(out.permute(0, 2, 3, 1), np.asarray(ref.astype(jnp.float32)), "fp32",
           atol=1e-4 if compute == "fp32" else 3e-2, rtol=1e-4 if compute == "fp32" else 3e-2)


# ----------------------------------------------------------------- models
def _int8_pair(compute: str, seed: int):
    """The JAX tiny model with prepare_inference_variables(int8) and the
    port's tiny model with prepare_inference_model(int8) on the same
    perturbed weights; min_dim=1 on both sides so every selected tensor is
    quantized."""
    import jax.numpy as jnp

    from test_torch_port_model import jax_model, make_pair, port_model
    from uvltrack_tpu.config import default_cfg
    from uvltrack_tpu.models.uvltrack import prepare_inference_variables
    from uvltrack_tpu.ops import quant as jquant
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
    from uvltrack_tpu_torch.models.uvltrack import prepare_inference_model

    _, v, _ = make_pair(seed=seed)
    cfg = default_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16" if compute == "bf16" else "float32"
    cfg.TPU.WEIGHT_QUANT = "int8"
    real = jquant.quantize_vit_params
    jquant.quantize_vit_params = lambda p, min_dim=128: real(p, min_dim=1)
    try:
        vq = prepare_inference_variables(cfg, v)
    finally:
        jquant.quantize_vit_params = real
    assert jquant.count_quantized(vq["params"]) == 32
    jm = jax_model(dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32)
    tm = port_model(dtype=XDT[compute]).eval()
    load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"]))
    prepare_inference_model(CfgNode(cfg.to_dict()), tm)
    quant.quantize_vit_params(tm, min_dim=1)
    assert quant.count_quantized(tm) == 32
    return jm, vq, tm


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_int8_model_matches_jax(compute):
    """forward_test_cached and forward_prompt_init of the int8 tiny model,
    fp32 at the model tests' 1e-4, bf16 at their 3e-2."""
    import jax.numpy as jnp

    from test_torch_port_model import _inputs, japply
    from test_torch_port_model import _t as _tn  # keeps int and bool dtypes
    from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack

    tol = dict(atol=1e-4, rtol=1e-4) if compute == "fp32" else dict(atol=3e-2, rtol=3e-2)
    # the weights, inputs and prompt of test_bf16_forward_matches_jax_at_bf16_tolerance
    jm, vq, tm = _int8_pair(compute, seed=9)
    tz, sx, ids, mask, tmask, cmask, flag = _inputs(2, seed=10)
    prompt = np.random.default_rng(11).normal(size=(2, 3, 32)).astype(np.float32)
    ja = [jnp.asarray(a) for a in (tz, sx, ids, mask, tmask, cmask, flag)]
    jtxt = japply(jm, vq, ja[2], ja[3], method=JUVLTrack.encode_text)
    ref = japply(jm, vq, ja[0], ja[1], jtxt, ja[3], jnp.asarray(prompt), ja[6],
                 method=JUVLTrack.forward_test_cached)
    with torch.no_grad():
        txt = tm.encode_text(_tn(ids), _tn(mask))
        out = tm.forward_test_cached(_tn(tz), _tn(sx), txt, _tn(mask), _tn(prompt), _tn(flag))
        for key in ("cls_score_test", "bbox_map", "cont_score", "pred_boxes"):
            _close(out[key], np.asarray(ref[key].astype(jnp.float32)), "fp32", **tol)
        ref_p = np.asarray(japply(jm, vq, *ja, method=JUVLTrack.forward_prompt_init)
                           .astype(jnp.float32))
        out_p = tm.forward_prompt_init(*(_tn(a) for a in (tz, sx, ids, mask, tmask, cmask, flag)))
    if compute == "bf16":
        # the prompter sums tokens of scale ~7 in bf16 at every step, so its
        # rounding lands on every element alike: 3e-2 of the prompt's scale
        # (the bf16 model without int8 differs from JAX by ~1% of it too)
        tol = dict(atol=3e-2 * float(np.abs(ref_p).max()), rtol=0.0)
    _close(out_p, ref_p, "fp32", **tol)


@pytest.mark.parametrize("mode", ["BBOX", "NLBBOX"])
def test_int8_tracker_matches_jax_frame_by_frame(mode, tmp_path):
    """The port's int8 Tracker against the JAX int8 Tracker, fp32, with
    re-mines every 2 frames: boxes within 1e-3 px, scores within 1e-4."""
    from test_torch_port_tracker import _frame
    from test_tracker import tiny_cfg
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
    from uvltrack_tpu.ops import quant as jquant
    from uvltrack_tpu.track.tracker import Tracker as JTracker
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.track.tracker import Tracker

    jm, vq, tm = _int8_pair("fp32", seed=26)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "red", "box",
                                "the", "moving"]) + "\n")
    jcfg = tiny_cfg()
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.TPU.WEIGHT_QUANT = "int8"
    jcfg.TEST.MODE = mode
    jt = JTracker(jcfg, jm, vq, tokenizer=JTok(str(vocab)))  # vq is quantized already
    assert jquant.count_quantized(jt.jt.variables["params"]) == 32
    tt = Tracker(CfgNode(jcfg.to_dict()), tm, tokenizer=BertTokenizer(str(vocab)))
    assert quant.count_quantized(tt.model) == 32
    info = {"init_bbox": [30.0, 20.0, 20.0, 24.0], "language": "a red box moving"}
    assert tt.initialize(_frame(60), info) == jt.initialize(_frame(60), info)
    for i in range(5):
        f = _frame(61 + i)
        ref, out = jt.track(f), tt.track(f)
        np.testing.assert_allclose(out["target_bbox"], ref["target_bbox"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(out["score"], ref["score"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tt.state.prompt.numpy(), np.asarray(jt.state.prompt),
                                   atol=1e-4, rtol=1e-4)
    assert tt.remines == 2  # frames 2, 4


def test_int8_tracker_tracks_close_to_fp():
    """int8 weights against bf16 weights (TPU.COMPUTE_DTYPE=bfloat16), no
    re-mine, on the model, weights, frames and box of
    tests/test_quant.py::test_quantized_tracker_tracks_close_to_fp (whose
    tiny model computes in fp32 from the cast weights): IoU >= 0.7 every
    frame, its bound."""
    import jax
    import jax.numpy as jnp

    from test_model import tiny_inputs, tiny_model
    from test_torch_port_model import _np_tree, port_model
    from test_tracker import tiny_cfg
    from uvltrack_tpu.core.box_ops import box_iou, box_xywh_to_xyxy
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
    from uvltrack_tpu_torch.models.uvltrack import prepare_inference_model
    from uvltrack_tpu_torch.track.tracker import Tracker

    model, inp = tiny_model(), tiny_inputs()
    v = _np_tree(jax.jit(lambda r: model.init(r, *inp, train=False))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 255, size=(80, 100, 3)).astype(np.uint8) for _ in range(4)]
    boxes = {}
    for name in ("fp", "q8"):
        cfg = CfgNode(tiny_cfg().to_dict())
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.WEIGHT_QUANT = "int8" if name == "q8" else ""
        cfg.TEST.UPDATE_INTERVAL = 100
        cfg.TEST.THRESHOLD = 2.0
        tm = port_model().eval()
        load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"]))
        prepare_inference_model(cfg, tm)
        if name == "q8":  # the tiny widths are below the 128 gate
            quant.quantize_vit_params(tm, min_dim=1)
        t = Tracker(cfg, tm)
        assert quant.count_quantized(t.model) == (32 if name == "q8" else 0)
        t.initialize(frames[0], {"init_bbox": [30.0, 20.0, 20.0, 24.0]})
        boxes[name] = [t.track(f)["target_bbox"] for f in frames[1:]]
    for bf, bq in zip(boxes["fp"], boxes["q8"]):
        iou, _ = box_iou(box_xywh_to_xyxy(jnp.asarray([bf], jnp.float32)),
                         box_xywh_to_xyxy(jnp.asarray([bq], jnp.float32)))
        assert float(iou.reshape(-1)[0]) >= 0.7, (bf, bq)


# ------------------------------------------------------------- on the card
# Run on a machine with a card: python -m pytest tests/test_torch_port_quant.py -m gpu
# bf16 compute: the bounds of tests/test_torch_port_ops.py (one bf16 step at
# each output's scale); fp32 compute: |diff| <= 2e-4 + 2e-4 * |plain|, fp32
# sums in another order (the hi/lo bf16 passes keep 2^-17 of each operand).
# The projection alone (|proj| about 0.1 on average, below 0.4 for 99% of
# elements) takes two bf16 steps at 0.25-0.5 as its absolute term.
GPU_ATOL, GPU_RTOL, GPU_ATTN_ATOL, GPU_PROJ_ATOL = 2e-2, 2e-2, 6e-3, 2e-3
F32_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gpu_q8_case(n, mask, dev, c=768, seed=0, b=1):
    x, g, be, w, wb, kb = (_t(a).to(dev) for a in _ln_case(n, c=c, b=b, seed=seed, mask=mask))
    wp, bp = (_t(a).to(dev) for a in _proj_case(c=c, seed=seed + 1))
    # the model's path: bf16 weights, quantized from their bf16 values
    wq = quant.quantize_weight(w.t().contiguous().bfloat16())
    wpq = quant.quantize_weight(wp.t().contiguous().bfloat16())
    return x, g, be, w.t().contiguous().bfloat16(), wq, wb, wp.t().contiguous().bfloat16(), \
        wpq, bp, kb


def _gpu_close(out, ref, f32: bool, atol=GPU_ATOL):
    if f32:
        torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=GPU_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [768, 1024])
@pytest.mark.parametrize("x_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 321, 361, 681])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_q8_and_proj_kernels_match_plain(cuda, b, n, mask, x_dtype, c):
    """Every int8 ln_qkv and proj_residual instantiation against its plain
    version at UVLTrack-B's width (C=768, 12 heads) and UVLTrack-L's (C=1024,
    16 heads), at B = 1 and at the lockstep batches 4 and 8 (B*N rows, split-K
    tiles across the batch boundary)."""
    x, g, be, w16, wq, wb, wp16, wpq, bp, kb = _gpu_q8_case(n, mask, cuda, c=c, b=b)
    heads = c // 64
    x = x.to(XDT[x_dtype])
    f32 = x_dtype == "fp32"
    build.reset_launch_counts()
    qkv = lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb)
    attn = lqa.qkv_attention(qkv, kb, heads)
    torch.cuda.synchronize()
    assert qkv.dtype == attn.dtype == x.dtype
    _gpu_close(qkv, lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb), f32)
    _gpu_close(attn, lqa.qkv_attention_plain(qkv, kb, heads), f32, GPU_ATTN_ATOL)
    _gpu_close(attn, lqa.ln_qkv_attention_q8_plain(x, g, be, wq.q, wq.scale, wb, kb, heads), f32,
               GPU_ATTN_ATOL)
    # the epilogue kernel on the same attention output: #6 (x's dtype, int8)
    out = lqp.proj_residual(x, attn, wpq.q, bp, wpq.scale)
    _gpu_close(out, lqp.proj_residual_plain(x, attn, wpq, bp), f32)
    # #4 (bf16 attention output and weights; the sum exact, then one rounding)
    a16 = attn.to(torch.bfloat16)
    out4 = lqp.proj_residual(x, a16, wp16, bp)
    _gpu_close(out4, lqp.proj_residual_plain(x, a16, wp16, bp), f32)
    torch.cuda.synchronize()
    inst = f"{x_dtype}x"
    assert build.instantiation_counts() == {
        f"ln_qkv[{inst}-int8w]": 1, f"qkv_attention[{x_dtype}]": 1,
        f"proj_residual[{inst}-{x_dtype}a-int8w]": 1, f"proj_residual[{inst}-bf16a-bf16w]": 1}
    # the projection alone: on a zero residual stream out = cast_x(proj)
    # exactly, so a bf16 epilogue is held at the projection's scale
    z = torch.zeros_like(x)
    _gpu_close(lqp.proj_residual(z, attn, wpq.q, bp, wpq.scale),
               lqp.proj_residual_plain(z, attn, wpq, bp), f32, GPU_PROJ_ATOL)
    _gpu_close(lqp.proj_residual(z, a16, wp16, bp), lqp.proj_residual_plain(z, a16, wp16, bp),
               f32, GPU_PROJ_ATOL)
    # the compositions #6 and #4 against their plain versions
    _gpu_close(lqp.ln_qkv_attn_proj_q8(x, g, be, wq.q, wq.scale, wb, wpq.q, wpq.scale, bp, kb,
                                       heads),
               lqp.ln_qkv_attn_proj_q8_plain(x, g, be, wq.q, wq.scale, wb, wpq.q, wpq.scale, bp,
                                             kb, heads), f32)
    _gpu_close(lqp.ln_qkv_attn_proj(x, g, be, w16, wb, wp16, bp, kb, heads),
               lqp.ln_qkv_attn_proj_plain(x, g, be, w16, wb, wp16, bp, kb, heads), False)


@pytest.mark.gpu
@pytest.mark.parametrize("inst", ["bf16x-bf16a-bf16w", "fp32x-bf16a-bf16w", "bf16x-bf16a-int8w",
                                  "fp32x-fp32a-int8w"])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_proj_residual_is_deterministic(cuda, b, inst):
    """Two proj_residual launches on the same inputs are bitwise equal at
    the main path's shape (the cluster's split-K partials summed in rank
    order), for each instantiation, at B = 1, 4 and 8."""
    x, g, be, w16, wq, wb, wp16, wpq, bp, kb = _gpu_q8_case(361, "tail", cuda, b=b)
    xt, at, wt = (part[:4] for part in inst.split("-"))
    x = x.to(XDT[xt])
    attn = lqa.qkv_attention(lqa.ln_qkv_q8(x.float(), g, be, wq.q, wq.scale, wb), kb, 12)
    attn = attn.to(XDT[at])
    args = (wpq.q, bp, wpq.scale) if wt == "int8" else (wp16, bp)
    outs = [lqp.proj_residual(x, attn, *args) for _ in range(2)]
    torch.cuda.synchronize()
    assert outs[0].dtype == x.dtype
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_dispatch_launch_counts(cuda, quantized, fused, monkeypatch):
    """One visual block (bf16 stream, N=321) and one joint block (fp32
    stream, N=361) through attention_block_core on the "cuda" backend:
    each dispatch launches its instantiations once; unfused, a bf16
    projection runs on `dense` (an int8 one keeps the upcast)."""
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", fused)
    x, g, be, w16, wq, wb, wp16, wpq, bp, kb = _gpu_q8_case(361, "tail", cuda)
    wqkv, wproj = (wq, wpq) if quantized else (w16, wp16)
    bias = kb[:, None, None, :]
    build.reset_launch_counts()
    tattn.force_backend("cuda")
    try:
        vis = tattn.attention_block_core(x[:, :321].bfloat16().contiguous(), g, be, wqkv, wb, wproj,
                                         bp, 12, bias[..., :321], torch.bfloat16)
        joint = tattn.attention_block_core(x, g, be, wqkv, wb, wproj, bp, 12, bias,
                                           torch.bfloat16)
    finally:
        tattn.force_backend(None)
    torch.cuda.synchronize()
    assert vis.dtype == torch.bfloat16 and joint.dtype == torch.float32
    w = "int8w" if quantized else "bf16w"
    want = {f"ln_qkv[bf16x-{w}]": 1, f"ln_qkv[fp32x-{w}]": 1}
    want.update({"qkv_attention[bf16]": 1, "qkv_attention[fp32]": 1} if quantized
                else {"qkv_attention[bf16]": 2})
    if fused == "1":
        want.update({"proj_residual[bf16x-bf16a-int8w]": 1, "proj_residual[fp32x-fp32a-int8w]": 1}
                    if quantized else
                    {"proj_residual[bf16x-bf16a-bf16w]": 1, "proj_residual[fp32x-bf16a-bf16w]": 1})
    elif not quantized:
        want["dense[bf16a-bf16w-fp32o]"] = 2
    assert build.instantiation_counts() == want


@pytest.mark.gpu
def test_cuda_q8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, g, be, w16, wq, wb, wp16, wpq, bp, kb = _gpu_q8_case(64, "open", cuda)
    with pytest.raises(ValueError):
        lqa.ln_qkv_q8(x, g, be, w16, wq.scale, wb)  # bf16 payload
    with pytest.raises(ValueError):
        lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale[:10], wb)  # wrong scale
    a32 = torch.zeros(1, 64, 768, device=cuda)
    with pytest.raises(ValueError):
        lqp.proj_residual(x.bfloat16(), a32, wpq.q, bp, wpq.scale)  # no such instantiation
    with pytest.raises(ValueError):
        lqp.proj_residual(x, a32.bfloat16(), wpq.q, bp)  # int8 without its scale
    with pytest.raises(ValueError):
        lqp.proj_residual(x, a32, wp16.t(), bp)  # not contiguous / fp32 A with bf16 W
    # K past what one k-tile a cluster block takes: K % 64, K < 64 * PROJ_SPLIT
    for k in (96, 128):
        a = torch.zeros(1, 64, k, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            lqp.proj_residual(x.bfloat16(), a, wp16[:, :k].contiguous(), bp)
    # C past the LN block the int8 ln_qkv holds in shared memory (1024)
    c = 1088
    xw = torch.zeros(1, 64, c, device=cuda)
    gw = torch.ones(c, device=cuda)
    wqw = torch.zeros(3 * c, c, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):
        lqa.ln_qkv_q8(xw, gw, gw, wqw, torch.ones(3 * c, device=cuda),
                      torch.zeros(3 * c, device=cuda))


def test_gpu_tests_need_no_jax_at_import():
    """The card's machine has no JAX: this module imports it only inside
    the CPU tests."""
    src = open(os.path.abspath(__file__)).read()
    head = src[:src.index("\ndef ")]
    assert "import jax" not in head and "from uvltrack_tpu." not in head
