"""Four places where uvltrack_tpu_torch once differed from the JAX package,
each held against it on the CPU in fp32:

- UVLTRACK_FUSED_PREFIX and kernel #2's own entry (attention_qkv_core): on
  the same inputs and environment the port's entry points take the prefix
  kernel, the attention kernel alone, or neither, exactly when the JAX
  package's take theirs (the card stood in for as in
  tests/test_torch_port_fused.py), with the same outputs;
- a bias that is not key padding, (B, 1, N, N), in the ViT cores and in
  VitBlock: the generic path, no ValueError;
- a BERT width other than the ViT's: MUFE's text_proj, carried by the weight
  bridge and refused in a reference checkpoint.

(TPU.CACHE_TEXT=False is held frame by frame in
tests/test_torch_port_tracker.py.) Tolerances: 5e-5/5e-4 for the ops (the
JAX package's kernel tests), 1e-4 for layers and the backbone
(tests/test_torch_port_model.py).
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_port_fused import _jax, _spy, _t, gates  # noqa: F401  (gates: a fixture)
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
from uvltrack_tpu_torch.ops import quant

ATOL, RTOL = 5e-5, 5e-4


def _block_case(n, c=32, b=2, seed=4, mask="random"):
    """x, LN scale/bias, qkv and proj weights in flax (in, out) layout, and
    the (B, 1, 1, N) key-padding bias (random: 30% of the keys masked)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    be = (0.1 * rng.normal(size=c)).astype(np.float32)
    w = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    wb = (0.02 * rng.normal(size=3 * c)).astype(np.float32)
    wp = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    bp = (0.02 * rng.normal(size=c)).astype(np.float32)
    masked = rng.random((b, n)) < (0.3 if mask == "random" else 0.0)
    masked[:, 0] = False
    kb = np.where(masked, -1e10, 0.0).astype(np.float32)[:, None, None, :]
    return x, g, be, w, wb, wp, bp, kb


def _full_bias(kb, seed=9):
    """A (B, 1, N, N) bias that is not key padding: the key padding plus a
    per-query, per-key term."""
    b, _, _, n = kb.shape
    rng = np.random.default_rng(seed)
    return (kb + rng.normal(size=(b, 1, n, n))).astype(np.float32)


# ------------------------------------------- UVLTRACK_FUSED_PREFIX, kernel #2
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,env", [(21, None), (130, None), (21, "16")])
@pytest.mark.parametrize("prefix", [None, "1", "0"])
def test_fused_prefix_gate_matches_jax(prefix, n, env, int8, gates, monkeypatch):
    """attention_ln_qkv_core past the gate: the fused prefix (#1, or #5 for
    int8 weights) unless UVLTRACK_FUSED_PREFIX=0, which runs LN + qkv plain
    and the attention alone on kernel #2, in both packages; below the gate
    neither runs a kernel."""
    jnp, jattn, pa = gates
    from uvltrack_tpu.ops.quant import quantize_weight as jquantize

    if prefix is not None:
        monkeypatch.setenv("UVLTRACK_FUSED_PREFIX", prefix)
    else:
        monkeypatch.delenv("UVLTRACK_FUSED_PREFIX", raising=False)
    if env:
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", env)
    calls = []
    _spy(monkeypatch, pa, "ln_qkv_attention_trainable", calls, "jax prefix")
    _spy(monkeypatch, pa, "fused_ln_qkv_attention_q8", calls, "jax prefix")
    _spy(monkeypatch, pa, "_qkv_attention_trainable", calls, "jax attention")
    _spy(monkeypatch, lqa, "ln_qkv", calls, "port ln_qkv")
    _spy(monkeypatch, lqa, "ln_qkv_q8", calls, "port ln_qkv")
    _spy(monkeypatch, lqa, "qkv_attention", calls, "port attention")
    x, g, be, w, wb, _, _, kb = _block_case(n, b=1)
    jw, tw = jnp.asarray(w), _t(w.T)
    if int8:
        jw, tw = jquantize(jw), quant.quantize_weight(tw)
    ref = jattn.attention_ln_qkv_core(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jw,
                                      jnp.asarray(wb), 4, jnp.asarray(kb))
    out = tattn.attention_ln_qkv_core(_t(x), _t(g), _t(be), tw, _t(wb), 4, _t(kb))
    if n < int(env or 128):
        want = []
    elif prefix == "0":
        want = ["jax attention", "port attention"]
    else:
        want = ["jax prefix", "port ln_qkv", "port attention"]
    assert calls == want
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prefix", ["1", "0"])
def test_fused_projection_needs_the_fused_prefix(prefix, gates, monkeypatch):
    """attention_block_core under UVLTRACK_FUSED_PROJ=1 runs #4 only while
    the prefix is fused; UVLTRACK_FUSED_PREFIX=0 turns it off in both
    packages, and the branch is composed around kernel #2."""
    jnp, jattn, pa = gates
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", "1")
    monkeypatch.setenv("UVLTRACK_FUSED_PREFIX", prefix)
    calls = []
    _spy(monkeypatch, pa, "ln_qkv_attn_proj_trainable", calls, "jax #4")
    _spy(monkeypatch, lqp, "ln_qkv_attn_proj", calls, "port #4")
    _spy(monkeypatch, pa, "_qkv_attention_trainable", calls, "jax #2")
    _spy(monkeypatch, lqa, "qkv_attention", calls, "port #2")
    x, g, be, w, wb, wp, bp, kb = _block_case(21)
    ref = jattn.attention_block_core(*(jnp.asarray(a) for a in (x, g, be, w, wb, wp, bp)), 4,
                                     jnp.asarray(kb))
    out = tattn.attention_block_core(_t(x), _t(g), _t(be), _t(w.T), _t(wb), _t(wp.T), _t(bp),
                                     4, _t(kb))
    if prefix == "1":  # the port's #4 composes #1's pair and the epilogue
        assert calls == ["jax #4", "port #4", "port #2"]
    else:
        assert calls == ["jax #2", "port #2"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bias", ["none", "padding", "full"])
@pytest.mark.parametrize("n", [21, 130])
def test_attention_qkv_core_matches_jax(n, bias, gates):
    """Kernel #2's entry on the fused qkv layout: the kernel past the gate
    for key padding or no bias; a full bias takes the plain softmax in both
    packages."""
    jnp, jattn, pa = gates
    rng = np.random.default_rng(6)
    qkv = rng.normal(size=(2, n, 3 * 4 * 8)).astype(np.float32)
    kb = _block_case(n)[-1]
    b = {"none": None, "padding": kb, "full": _full_bias(kb)}[bias]
    ref = jattn.attention_qkv_core(jnp.asarray(qkv), 4, None if b is None else jnp.asarray(b))
    out = tattn.attention_qkv_core(_t(qkv), 4, None if b is None else _t(b))
    assert out.shape == (2, n, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


# ------------------------------------------ a bias that is not key padding
@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("fused_proj", ["0", "1"])
def test_generic_bias_takes_the_generic_path(fused_proj, backend, gates, monkeypatch):
    """A (B, 1, N, N) bias in attention_ln_qkv_core and attention_block_core:
    LN + qkv plain, then attention with the full bias; no kernel, no #4,
    and the JAX package's outputs, on either backend."""
    jnp, jattn, pa = gates
    monkeypatch.setattr(tattn, "_BACKEND", backend)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", fused_proj)
    calls = []
    for name in ("ln_qkv", "ln_qkv_q8", "qkv_attention", "ln_qkv_attention"):
        _spy(monkeypatch, lqa, name, calls, name)
    _spy(monkeypatch, lqp, "ln_qkv_attn_proj", calls, "ln_qkv_attn_proj")
    x, g, be, w, wb, wp, bp, kb = _block_case(21)
    full = _full_bias(kb)
    jargs = [jnp.asarray(a) for a in (x, g, be, w, wb)]
    targs = [_t(x), _t(g), _t(be), _t(w.T), _t(wb)]
    ref = jattn.attention_ln_qkv_core(*jargs, 4, jnp.asarray(full))
    out = tattn.attention_ln_qkv_core(*targs, 4, _t(full))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    ref = jattn.attention_block_core(*jargs, jnp.asarray(wp), jnp.asarray(bp), 4,
                                     jnp.asarray(full))
    out = tattn.attention_block_core(*targs, _t(wp.T), _t(bp), 4, _t(full))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert calls == []


def test_vit_block_with_a_generic_bias_matches_jax(gates, monkeypatch):
    """VitBlock whose key mask becomes a (B, 1, N, N) bias in both packages
    (key_padding_bias replaced in each vit module), with the kernels' gates
    open: the generic path, the JAX block's output."""
    jnp, jattn, pa = gates
    from test_torch_port_model import make_pair
    from uvltrack_tpu.models import vit as jvit
    from uvltrack_tpu_torch.models import vit as tvit

    _, v, tm = make_pair()
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    km = rng.random((2, 21)) < 0.3
    extra = rng.normal(size=(2, 1, 21, 21)).astype(np.float32)
    monkeypatch.setattr(jvit, "key_padding_bias",
                        lambda m: jattn.key_padding_bias(m) + jnp.asarray(extra))
    monkeypatch.setattr(tvit, "key_padding_bias",
                        lambda m: tattn.key_padding_bias(m) + _t(extra))
    calls = []
    _spy(monkeypatch, lqa, "ln_qkv_attention", calls, "port #1")
    ref = jvit.VitBlock(32, 4).apply({"params": v["params"]["backbone"]["block_1"]},
                                     jnp.asarray(x), jnp.asarray(km))
    out = tm.backbone.vit.blocks[1](_t(x), torch.from_numpy(km))
    assert calls == []
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ------------------------------------------------- BERT width != ViT width
@functools.lru_cache(maxsize=None)
def _text_proj_pair():
    """A JAX UVLTrack at ViT width 48 with a BERT of width 32 (fusion from
    block 0, so no BERT layer runs at the other width: the JAX package's
    BertLayer adds its residual at its own width), variables perturbed from
    a seed, and the port's model holding the same weights."""
    import jax
    from test_model import NT
    from test_torch_port_model import _np_tree, _perturb
    from uvltrack_tpu.models.bert import BertConfig as JBertConfig
    from uvltrack_tpu.models.head import MABH as JMABH
    from uvltrack_tpu.models.mufe import MUFE as JMUFE
    from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack
    from uvltrack_tpu_torch.models.bert import BertConfig
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
    from uvltrack_tpu_torch.models.head import MABH
    from uvltrack_tpu_torch.models.mufe import MUFE
    from uvltrack_tpu_torch.models.uvltrack import UVLTrack

    geo = dict(embed_dim=48, depth=2, num_heads=4, template_size=32, search_size=64,
               fusion_layers=(0, 1), cont_loss_layers=(0, 1), txt_token_mode="cls")
    bert = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position=16)
    head = dict(inplanes=48, channel=32, feat_sz=4, cls_tokenize=False, offset_sigmoid=True,
                joint_cls=False, softmax_one=True)
    jm = JUVLTrack(backbone=JMUFE(**geo, bert=JBertConfig(**bert)), head=JMABH(**head))
    inp = _inputs(NT)
    v = jax.jit(lambda r: jm.init(r, *inp, train=False))(jax.random.PRNGKey(0))
    v = _perturb(_np_tree(v), np.random.default_rng(0))
    tm = UVLTrack(MUFE(**geo, bert=BertConfig(**bert)), MABH(**head)).eval()
    state = from_jax_variables(v["params"], v["batch_stats"])
    assert {"backbone.text_proj.weight", "backbone.text_proj.bias"} <= set(state)
    assert load_reference_state(tm, state) == []
    return jm, v, tm, inp, state


def _inputs(nt):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, size=(2, nt)).astype(np.int32)
    mask = np.ones((2, nt), np.int32)
    mask[:, 5:] = 0
    return (rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(2, 64, 64, 3)).astype(np.float32), ids, mask,
            rng.random((2, 4)) > 0.5, rng.random((2, 16)) > 0.5,
            np.asarray([2, 1], np.int32))


def test_mufe_with_a_narrower_bert_matches_jax():
    """text_proj in both text paths: the backbone forward (live BERT
    embeddings, contrastive logits) and encode_text + forward_cached_text,
    and the full forward through the head, in fp32."""
    import jax.numpy as jnp
    from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack

    jm, v, tm, inp, _ = _text_proj_pair()
    template, search, ids, mask, tmask, cmask, flag = inp
    jin = [jnp.asarray(a) for a in inp]
    tin = [torch.from_numpy(np.asarray(a)) for a in inp]
    with torch.no_grad():
        ref = jm.apply(v, *jin[:4], jin[6], method=lambda m, *a: m.backbone(*a))
        out = tm.backbone(*tin[:4], tin[6])
        for k in ("search", "text", "txt_token", "logits"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        jtxt = jm.apply(v, jin[2], jin[3], method=JUVLTrack.encode_text)
        txt = tm.encode_text(tin[2], tin[3])
        assert txt.shape == (2, ids.shape[1], 48)
        np.testing.assert_allclose(txt.numpy(), np.asarray(jtxt), atol=1e-4, rtol=1e-4)
        ref = jm.apply(v, jin[0], jin[1], jtxt, jin[3], jin[6],
                       method=lambda m, *a: m.backbone.forward_cached_text(*a))
        out = tm.backbone.forward_cached_text(tin[0], tin[1], txt, tin[3], tin[6])
        np.testing.assert_allclose(out["search"].numpy(), np.asarray(ref["search"]),
                                   atol=1e-4, rtol=1e-4)
        ref = jm.apply(v, *jin, train=False)
        out = tm(*tin)
        for k in ("cls_score_test", "bbox_map", "cont_score"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=k)


def test_reference_checkpoint_is_refused_for_a_text_proj_model():
    """A state without text_proj (every reference checkpoint) does not load
    into a model that has one, strict or not: the projection would stay
    random, as the JAX package's convert_uvltrack refuses it."""
    from uvltrack_tpu_torch.models.convert import load_reference_state

    _, _, tm, _, state = _text_proj_pair()
    ref_ckpt = {k: t for k, t in state.items() if "text_proj" not in k}
    for strict in (True, False):
        with pytest.raises(ValueError, match="text_proj"):
            load_reference_state(tm, ref_ckpt, strict=strict)
