"""Kernels #3 (masked attention on head-major q, k, v; BERT's path) and #7
(fused LN + MLP) of uvltrack_tpu_torch against the JAX package, and the
kernel gates of ops/attention.py against the JAX package's.

- The plain versions against the Pallas kernels run in interpret mode, in
  fp32 at the JAX package's own kernel-test tolerances
  (tests/test_pallas_attention.py: 2e-5/1e-4 for attention, 5e-5/5e-4 for
  the MLP).
- The gates: on the same inputs and environment, the port's entry point
  takes its kernel exactly when the JAX package's takes its Pallas kernel
  (UVLTRACK_PALLAS_MIN_N read at call time, UVLTRACK_FUSED_MLP, int8
  weights). The card is stood in for by monkeypatching `_on_card` (port) and
  `_on_tpu` (JAX) and spying on the kernel entry points.
- BertLayer and VitBlock with the gates open on both sides (the Pallas
  kernels in the interpreter, the port's wrappers on CPU tensors taking
  their plain versions) against each other at 1e-4.
- Marker `gpu` (skipped without a card): the CUDA kernels against their
  plain versions on the card; run there with
  `python -m pytest tests/test_torch_port_fused.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import fused_attention as fa
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import quant


def _jax():
    """The oracle, imported inside the CPU tests: the card's machine has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import attention as jattn
    from uvltrack_tpu.ops import pallas_attention as pa
    return jnp, jattn, pa


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _key_bias(b, n, mask, rng):
    """bert: trailing text padding at -10000 (5 to n-1 real tokens); all: BERT's
    all-masked row (BBOX mode's zero text mask) on batch element 0, padding
    on the rest; vit: -1e10 on the trailing 40 keys (flag-0 text keys), at
    most half of them; open: nothing."""
    kb = np.zeros((b, n), np.float32)
    for i in range(b):
        if mask in ("bert", "all"):
            kb[i, int(rng.integers(5, n)):] = -10000.0
        elif mask == "vit":
            kb[i, -min(40, n // 2):] = -1e10
    if mask == "all":
        kb[0] = -10000.0
    return kb


def _attn_case(n, mask, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    return q, k, v, _key_bias(b, n, mask, rng)


def _mlp_case(n, c=64, f=256, b=1, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g = (rng.normal(size=c) * 0.1 + 1.0).astype(np.float32)
    be = (rng.normal(size=c) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32)  # flax (in, out)
    b1 = (rng.normal(size=f) * 0.02).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = (rng.normal(size=c) * 0.02).astype(np.float32)
    return x, g, be, w1, b1, w2, b2


# ------------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("mask", ["bert", "all", "vit"])
@pytest.mark.parametrize("n", [40, 48, 128])
def test_fused_attention_plain_matches_pallas_kernel(n, mask):
    """Kernel #3's plain version == _attn_kernel in the Pallas interpreter;
    an all-masked row is the uniform average of v in both."""
    jnp, jattn, pa = _jax()
    q, k, v, kb = _attn_case(n, mask)
    ref = pa.fused_attention(*(jnp.asarray(a) for a in (q, k, v, kb)), interpret=True)
    out = fa.fused_attention_plain(_t(q), _t(k), _t(v), _t(kb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    if mask == "all":
        np.testing.assert_allclose(out[0].numpy(), np.broadcast_to(
            v[0].mean(1, keepdims=True), v[0].shape), atol=2e-5, rtol=1e-4)


def test_fused_attention_plain_matches_pallas_kernel_in_bf16():
    """bf16 q, k, v: the same rounding points (e cast to bf16 for P.V, the
    output rounded once), so the two stay within one bf16 step."""
    jnp, jattn, pa = _jax()
    q, k, v, kb = _attn_case(40, "bert", d=64, seed=3)
    ref = pa.fused_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                             jnp.asarray(kb), interpret=True)
    out = fa.fused_attention_plain(*(_t(a).bfloat16() for a in (q, k, v)), _t(kb))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=8e-3, rtol=1e-2)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [48, 130])
def test_ln_mlp_plain_matches_pallas_kernel(n, x_dtype):
    """Kernel #7's plain version == _ln_mlp_kernel in the Pallas interpreter,
    for an fp32 and a bf16 residual stream."""
    jnp, jattn, pa = _jax()
    x, g, be, w1, b1, w2, b2 = _mlp_case(n)
    ref = pa.fused_ln_mlp(jnp.asarray(x, x_dtype), *(jnp.asarray(a) for a in
                                                      (g, be, w1, b1, w2, b2)),
                          interpret=True)
    tx = _t(x).to(getattr(torch, x_dtype))
    out = lm.ln_mlp_plain(tx, _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-4)
    two = lm.fc2_bias_plain(lm.ln_fc1_gelu_plain(tx, _t(g), _t(be), _t(w1.T), _t(b1)),
                            _t(w2.T), _t(b2))
    torch.testing.assert_close(two, out, rtol=0, atol=0)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    build.reset_launch_counts()
    q, k, v, kb = (_t(a) for a in _attn_case(40, "bert"))
    torch.testing.assert_close(fa.fused_attention(q, k, v, kb),
                               fa.fused_attention_plain(q, k, v, kb), rtol=0, atol=0)
    x, g, be, w1, b1, w2, b2 = (_t(a) for a in _mlp_case(21))
    args = (x, g, be, w1.t(), b1, w2.t(), b2)
    torch.testing.assert_close(lm.ln_mlp(*args), lm.ln_mlp_plain(*args), rtol=0, atol=0)
    assert build.launch_counts() == dict.fromkeys(build.SOURCES, 0)


# ------------------------------------------------------------------ gates
@pytest.fixture
def gates(monkeypatch):
    """Both packages on their kernel backend, with the card stood in for:
    the port's `_on_card` and the JAX package's `_on_tpu` say yes, the
    Pallas kernels run in the interpreter. monkeypatch restores all."""
    jnp, jattn, pa = _jax()
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setattr(jattn, "_BACKEND", "pallas")
    monkeypatch.setattr(pa, "_on_tpu", lambda: True)
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    for knob in ("UVLTRACK_PALLAS_MIN_N", "UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PROJ"):
        monkeypatch.delenv(knob, raising=False)
    return jnp, jattn, pa


def _spy(monkeypatch, module, name, calls, key, fn=None):
    """Replace module.name by a wrapper that records `key` in `calls` and
    calls fn, by default the original."""
    fn = fn or getattr(module, name)

    def spy(*a, **kw):
        calls.append(key)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("env", [None, "32", "200"])
def test_min_seq_len_reads_the_environment_at_call_time(env, monkeypatch):
    jnp, jattn, pa = _jax()
    if env is None:
        monkeypatch.delenv("UVLTRACK_PALLAS_MIN_N", raising=False)
    else:
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", env)
    assert tattn.min_seq_len() == pa.min_seq_len() == int(env or 128)


@pytest.mark.parametrize("env", [None, "32"])
@pytest.mark.parametrize("n", [40, 129])
def test_attention_core_gate_matches_jax(n, env, gates, monkeypatch):
    """Kernel #3 engages for N >= min_seq_len() read off q's token axis: with
    130 heads, a gate that read q.shape[1] would open at N=40 under the
    default 128. A non-key-padding bias falls back to the plain path in both
    packages instead of raising."""
    jnp, jattn, pa = gates
    if env:
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", env)
    calls = []
    # the JAX kernel's stand-in: its XLA math (130 heads would unroll 130
    # times in the interpreter; the math is held by the tests above)
    _spy(monkeypatch, pa, "fused_attention", calls, "jax",
         lambda q, k, v, kb: jattn.xla_attention(q, k, v, kb[:, None, None, :]))
    _spy(monkeypatch, fa, "fused_attention", calls, "port")
    q, k, v, kb = _attn_case(n, "bert", b=1, h=130, d=8)
    bias = kb[:, None, None, :]
    ref = jattn.attention_core(*(jnp.asarray(a) for a in (q, k, v, bias)))
    out = tattn.attention_core(_t(q), _t(k), _t(v), _t(bias))
    want = ["jax", "port"] if n >= int(env or 128) else []
    assert calls == want
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    calls.clear()
    full = np.broadcast_to(bias, (1, 1, n, n)).copy()  # not key padding
    ref = jattn.attention_core(*(jnp.asarray(a) for a in (q, k, v, full)))
    out = tattn.attention_core(_t(q), _t(k), _t(v), _t(full))
    assert calls == []
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n,env", [(21, None), (130, None), (21, "16")])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_ln_mlp_core_gate_matches_jax(fused, n, env, int8, gates, monkeypatch):
    """Kernel #7 engages under UVLTRACK_FUSED_MLP=1 for fp weights at
    N >= min_seq_len(), in both packages (the JAX package's 14 MB VMEM
    estimate is far off at this width); int8 weights stay plain."""
    jnp, jattn, pa = gates
    from uvltrack_tpu.ops.quant import quantize_weight as jquantize

    monkeypatch.setenv("UVLTRACK_FUSED_MLP", fused)
    if env:
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", env)
    calls = []
    _spy(monkeypatch, pa, "ln_mlp_trainable", calls, "jax")
    _spy(monkeypatch, lm, "ln_mlp", calls, "port")
    x, g, be, w1, b1, w2, b2 = _mlp_case(n, c=32, f=128, b=2)
    jw1, jw2 = jnp.asarray(w1), jnp.asarray(w2)
    tw1, tw2 = _t(w1.T), _t(w2.T)
    if int8:
        jw1, jw2 = jquantize(jw1), jquantize(jw2)
        tw1, tw2 = quant.quantize_weight(tw1), quant.quantize_weight(tw2)
    ref = jattn.ln_mlp_core(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jw1,
                            jnp.asarray(b1), jw2, jnp.asarray(b2))
    out = tattn.ln_mlp_core(_t(x), _t(g), _t(be), tw1, _t(b1), tw2, _t(b2))
    on = fused == "1" and not int8 and n >= int(env or 128)
    assert calls == (["jax", "port"] if on else [])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("n,env", [(21, None), (21, "16"), (130, None)])
def test_block_cores_follow_min_seq_len(n, env, gates, monkeypatch):
    """Kernel #1's gate (attention_ln_qkv_core) reads UVLTRACK_PALLAS_MIN_N
    too, as the JAX package's prefix gate does."""
    jnp, jattn, pa = gates
    if env:
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", env)
    calls = []
    _spy(monkeypatch, pa, "ln_qkv_attention_trainable", calls, "jax")
    _spy(monkeypatch, lqa, "ln_qkv_attention", calls, "port")
    rng = np.random.default_rng(4)
    c = 32
    x = rng.normal(size=(1, n, c)).astype(np.float32)
    g, be = (1 + 0.1 * rng.normal(size=c)).astype(np.float32), np.zeros(c, np.float32)
    w = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    wb = (0.02 * rng.normal(size=3 * c)).astype(np.float32)
    ref = jattn.attention_ln_qkv_core(*(jnp.asarray(a) for a in (x, g, be, w, wb)), 4)
    out = tattn.attention_ln_qkv_core(_t(x), _t(g), _t(be), _t(w.T), _t(wb), 4)
    assert calls == (["jax", "port"] if n >= int(env or 128) else [])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-4)


# ------------------------------------------------- layers on the kernel path
@pytest.mark.parametrize("mask", ["padded", "all_masked"])
def test_bert_layer_on_the_kernel_path_matches_jax(mask, gates, monkeypatch):
    """BertLayer with UVLTRACK_PALLAS_MIN_N=8 at 8 tokens: the JAX layer runs
    _attn_kernel in the interpreter, the port's attention_core reaches
    fused_attention (the plain version on CPU tensors). With some real
    tokens the kernel path equals the plain path; on an all-masked row it
    does not, in either package: the clamp sends every score to -80 and the
    kernels average v uniformly, while the plain softmax, shift-invariant,
    ignores the uniform -10000 and weighs the keys by their scores."""
    jnp, jattn, pa = gates
    from test_model import NT, TINY
    from test_torch_port_model import make_pair
    from uvltrack_tpu.models.bert import BertLayer as JLayer
    from uvltrack_tpu.models.bert import bert_attention_bias as jbias
    from uvltrack_tpu_torch.models.bert import bert_attention_bias

    _, v, tm = make_pair()
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", str(NT))
    calls = []
    _spy(monkeypatch, pa, "fused_attention", calls, "jax")
    _spy(monkeypatch, fa, "fused_attention", calls, "port")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, NT, 32)).astype(np.float32)
    m = np.ones((2, NT), np.int32)
    m[1, 3:] = 0
    if mask == "all_masked":
        m[0] = 0
    bias = bert_attention_bias(torch.from_numpy(m))
    jlayer = JLayer(TINY["bert"])
    jparams = {"params": v["params"]["backbone"]["bert_layer_1"]}
    ref = jlayer.apply(jparams, jnp.asarray(x), jbias(jnp.asarray(m)))
    layer = tm.backbone.bert.encoder.layer[1]
    out = layer(_t(x), bias).detach()
    assert calls == ["jax", "port"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "128")
    plain = layer(_t(x), bias).detach()
    jplain = jlayer.apply(jparams, jnp.asarray(x), jbias(jnp.asarray(m)))
    assert calls == ["jax", "port"]
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(plain[1].numpy(), out[1].numpy(), atol=1e-4, rtol=1e-4)
    if mask == "all_masked":
        assert not np.allclose(plain[0].numpy(), out[0].numpy(), atol=1e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_vit_block_with_the_fused_mlp_matches_jax(masked, gates, monkeypatch):
    """VitBlock under UVLTRACK_FUSED_MLP=1 with the gate at 16 tokens: the JAX
    block runs _ln_qkv_attn_kernel and _ln_mlp_kernel in the interpreter,
    the port's block reaches ln_qkv_attention and ln_mlp (plain versions on
    CPU tensors)."""
    jnp, jattn, pa = gates
    from test_torch_port_model import make_pair
    from uvltrack_tpu.models.vit import VitBlock as JVitBlock

    _, v, tm = make_pair()
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setenv("UVLTRACK_FUSED_MLP", "1")
    calls = []
    _spy(monkeypatch, pa, "ln_mlp_trainable", calls, "jax")
    _spy(monkeypatch, lm, "ln_mlp", calls, "port")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 21, 32)).astype(np.float32)
    km = (rng.random((2, 21)) < 0.3) if masked else None
    ref = JVitBlock(32, 4).apply({"params": v["params"]["backbone"]["block_1"]},
                                 jnp.asarray(x), None if km is None else jnp.asarray(km))
    out = tm.backbone.vit.blocks[1](_t(x), None if km is None else torch.from_numpy(km))
    assert calls == ["jax", "port"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- on the card
# bf16 tolerance of kernel vs plain, |diff| <= atol + 2e-2 * |plain|: the same
# rounding points, sums in another order, so one bf16 step (2^-8 relative)
# may differ. The absolute term is about two bf16 steps at each output's
# scale: attention outputs are averages of v (|out| about 0.1 to 1 at BERT's
# 40 keys) and take 6e-3, as qkv_attention; the GELU hidden tensor (|h| up
# to about 4) takes 2e-2; the MLP output (|out| about 0.5) 6e-3.
GPU_RTOL = 2e-2
GPU_ATOL = {"attention": 6e-3, "hidden": 2e-2, "ln_mlp": 6e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bert_qkv(n, dev, b=1, h=12, seed=0):
    """BERT's layout: three (B, N, H*64) products viewed as (B, H, N, 64)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, h * 64, generator=g).to(dev, torch.bfloat16)
            .view(b, n, h, 64).transpose(1, 2) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["bert", "all", "vit", "open"])
@pytest.mark.parametrize("h", [12, 16])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [40, 48, 63, 64, 65, 128, 321, 361, 681])
def test_cuda_attention_matches_plain(cuda, n, b, h, mask):
    """Kernel #3 on the wgmma body (csrc/attention.cuh) in BERT's strided
    layout at ragged N, B in {1, 2, 4, 8}, H in {12, 16} (C = 768 and 1024), with
    an all-masked row (mask "all", batch element 0); the head-major
    contiguous layout gives the same numbers."""
    q, k, v = _bert_qkv(n, cuda, b=b, h=h, seed=n + h)
    kb = _t(_key_bias(b, n, mask, np.random.default_rng(n + b))).to(cuda)
    build.reset_launch_counts()
    out = fa.fused_attention(q, k, v, kb)
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {"attention[bf16]": 1}
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    ref = fa.fused_attention_plain(q, k, v, kb)
    torch.testing.assert_close(out.float(), ref.float(), atol=GPU_ATOL["attention"],
                               rtol=GPU_RTOL)
    # the head-major contiguous layout gives the same numbers
    hm = [t.contiguous() for t in (q, k, v)]
    torch.testing.assert_close(fa.fused_attention(*hm, kb).float(), out.float(), rtol=0, atol=0)


# (N, the cluster split csrc/attention.cuh's rule picks at B=1, H=12)
SPLIT_CASES = [(40, 1), (681, 2), (361, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,split", SPLIT_CASES, ids=[f"N{n}-split{s}" for n, s in SPLIT_CASES])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_attention_is_deterministic(cuda, b, n, split):
    """Two calls of kernel #3 are bitwise equal at shapes where the rule
    keeps the keys in one block (split 1) and splits them over clusters of
    2 and 3 blocks (the partials summed in rank order), at B = 1, 4 and 8,
    and each matches the plain version."""
    q, k, v = _bert_qkv(n, cuda, b=b, seed=split)
    kb = _t(_key_bias(b, n, "bert", np.random.default_rng(n))).to(cuda)
    first = fa.fused_attention(q, k, v, kb)
    second = fa.fused_attention(q, k, v, kb)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first.float(), fa.fused_attention_plain(q, k, v, kb).float(),
                               atol=GPU_ATOL["attention"], rtol=GPU_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [48, 321, 361, 681])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_ln_mlp_matches_plain(cuda, b, n, x_dtype):
    """Kernel #7, both launches, at B = 1 and at the lockstep batches 4 and
    8 (B*N rows)."""
    c, f = 768, 3072
    x, g, be, w1, b1, w2, b2 = _mlp_case(n, c=c, f=f, b=b, seed=n)
    x = _t(x).to(cuda, x_dtype)
    g, be, b1, b2 = (_t(a).to(cuda) for a in (g, be, b1, b2))
    w1 = _t(w1.T).to(cuda, torch.bfloat16).contiguous()
    w2 = _t(w2.T).to(cuda, torch.bfloat16).contiguous()
    hidden = torch.empty((b * n, f), dtype=torch.bfloat16, device=cuda)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=cuda)
    build.reset_launch_counts()
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out)
    torch.cuda.synchronize()
    tag = "fp32x" if x_dtype == torch.float32 else "bf16x"
    assert build.instantiation_counts() == {f"ln_mlp[{tag}-bf16w]": 1}
    h3 = hidden.view(b, n, f)
    h_ref = lm.ln_fc1_gelu_plain(x, g, be, w1, b1)
    torch.testing.assert_close(h3.float(), h_ref.to(torch.bfloat16).float(),
                               atol=GPU_ATOL["hidden"], rtol=GPU_RTOL)
    torch.testing.assert_close(out.float(), lm.fc2_bias_plain(h3, w2, b2).float(),
                               atol=GPU_ATOL["ln_mlp"], rtol=GPU_RTOL)
    torch.testing.assert_close(out.float(),
                               lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2).float(),
                               atol=GPU_ATOL["ln_mlp"], rtol=GPU_RTOL)
    torch.testing.assert_close(lm.ln_mlp(x, g, be, w1, b1, w2, b2), out, rtol=0, atol=0)


def _cuda_mlp(n, cuda, x_dtype, c=768, b=1, seed=0):
    x, g, be, w1, b1, w2, b2 = _mlp_case(n, c=c, f=4 * c, b=b, seed=seed)
    return (_t(x).to(cuda, x_dtype), _t(g).to(cuda), _t(be).to(cuda),
            _t(w1.T).to(cuda, torch.bfloat16).contiguous(), _t(b1).to(cuda),
            _t(w2.T).to(cuda, torch.bfloat16).contiguous(), _t(b2).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c", [(1, 65, 768), (2, 321, 768), (1, 681, 768),
                                   (2, 361, 1024), (1, 65, 1024)])
def test_cuda_ln_mlp_stages_on_the_wgmma_core(cuda, b, n, c, x_dtype):
    """Each launch of #7 alone on the TMA + wgmma core: ln_fc1_gelu into the
    hidden tensor, and fc2_bias (K split over a cluster of four) on the
    plain version's hidden tensor, at ragged M (65 = 64 + 1, 321, 681), with
    B = 2 and at ViT-L's C=1024 (F=4096); fc2_bias gives the same output,
    bit for bit, on a second call."""
    x, g, be, w1, b1, w2, b2 = _cuda_mlp(n, cuda, x_dtype, c=c, b=b, seed=n + c)
    f = 4 * c
    hidden = torch.empty((b * n, f), dtype=torch.bfloat16, device=cuda)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=cuda)
    build.reset_launch_counts()
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="ln_fc1_gelu")
    torch.cuda.synchronize()
    h_ref = lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(torch.bfloat16)
    torch.testing.assert_close(hidden.view(b, n, f).float(), h_ref.float(),
                               atol=GPU_ATOL["hidden"], rtol=GPU_RTOL)
    hidden.copy_(h_ref.view(b * n, f))
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="fc2_bias")
    first = out.clone()
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out, stages="fc2_bias")
    torch.cuda.synchronize()
    tag = "fp32x" if x_dtype == torch.float32 else "bf16x"
    assert build.instantiation_counts() == {f"ln_mlp[{tag}-bf16w]": 3}
    torch.testing.assert_close(first.float(), lm.fc2_bias_plain(h_ref, w2, b2).float(),
                               atol=GPU_ATOL["ln_mlp"], rtol=GPU_RTOL)
    assert torch.equal(out, first)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_fc2_bias_is_deterministic(cuda, b):
    """Two fc2_bias launches on the same hidden tensor are bitwise equal at
    the main path's shape (the cluster's partials summed in rank order), at
    B = 1, 4 and 8."""
    x, g, be, w1, b1, w2, b2 = _cuda_mlp(361, cuda, torch.float32, b=b)
    hidden = torch.empty((b * 361, 3072), dtype=torch.bfloat16, device=cuda)
    outs = [torch.empty((b, 361, 768), dtype=torch.bfloat16, device=cuda) for _ in range(2)]
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, outs[0], stages="pair")
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, outs[1], stages="fc2_bias")
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_cuda_dispatch_follows_the_knobs(cuda, monkeypatch):
    """attention_core launches #3 only past UVLTRACK_PALLAS_MIN_N; ln_mlp_core
    launches #7 only under UVLTRACK_FUSED_MLP=1 and for bf16 weights."""
    monkeypatch.delenv("UVLTRACK_PALLAS_MIN_N", raising=False)
    monkeypatch.delenv("UVLTRACK_FUSED_MLP", raising=False)
    q, k, v = _bert_qkv(40, cuda)
    bias = torch.zeros((1, 1, 1, 40), device=cuda)
    x, g, be, w1, b1, w2, b2 = _mlp_case(321, c=768, f=3072)
    args = (_t(x).to(cuda, torch.bfloat16), _t(g).to(cuda), _t(be).to(cuda),
            _t(w1.T).to(cuda, torch.bfloat16).contiguous(), _t(b1).to(cuda),
            _t(w2.T).to(cuda, torch.bfloat16).contiguous(), _t(b2).to(cuda))
    build.reset_launch_counts()
    try:
        tattn.force_backend("cuda")
        tattn.attention_core(q, k, v, bias)
        tattn.ln_mlp_core(*args)
        assert build.launch_counts()["attention"] == build.launch_counts()["ln_mlp"] == 0
        monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "32")
        monkeypatch.setenv("UVLTRACK_FUSED_MLP", "1")
        tattn.attention_core(q, k, v, bias)
        tattn.ln_mlp_core(*args)
        tattn.ln_mlp_core(*args[:3], quant.quantize_weight(args[3]), args[4],
                          quant.quantize_weight(args[5]), args[6])  # int8: plain
        tattn.force_backend("plain")
        tattn.attention_core(q, k, v, bias)
        tattn.ln_mlp_core(*args)
    finally:
        tattn.force_backend(None)
    assert build.instantiation_counts() == {"attention[bf16]": 1, "ln_mlp[bf16x-bf16w]": 1}


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _bert_qkv(40, cuda)
    kb = torch.zeros((1, 40), device=cuda)
    with pytest.raises(ValueError):
        fa.fused_attention(q.float(), k.float(), v.float(), kb)  # fp32
    with pytest.raises(ValueError):
        fa.fused_attention(q[..., :32], k[..., :32], v[..., :32], kb)  # D = 32
    with pytest.raises(ValueError):
        fa.fused_attention(q, k.contiguous(), v, kb)  # strides differ
    x, g, be, w1, b1, w2, b2 = (_t(a).to(cuda) for a in _mlp_case(64, c=128, f=512))
    with pytest.raises(ValueError):
        lm.ln_mlp(x, g, be, w1.t().contiguous(), b1, w2.t().contiguous(), b2)  # fp32 W
    with pytest.raises(ValueError):
        lm.ln_mlp(x, g, be, w1.bfloat16(), b1, w2.bfloat16(), b2)  # (C, F) layout
