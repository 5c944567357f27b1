"""fp32 compute on the kernels (TPU.COMPUTE_DTYPE=float32) against the JAX
package: the fused projection (#4) and MLP (#7) with fp32 weights, the hi/lo
planes of an fp32 weight (ops/hilo.py, csrc/split_hilo.cu) and their cache.

- `ln_qkv_attn_proj_plain` with fp32 weights against `_xla_ln_qkv_attn_proj`
  and against `ln_qkv_attn_proj_trainable` in the Pallas interpreter (as
  tests/test_pallas_attention.py runs it); `ln_mlp_plain` against
  `_xla_ln_mlp`, all with fp32 weights, at 5e-5 abs / 5e-4 rel (fp32 sums
  in another order, the JAX package's own bound for its fp32 kernels).
- A tiny fp32-compute UVLTrack (tests/test_torch_port_model.py's pair)
  under UVLTRACK_FUSED_PROJ=1 and UVLTRACK_FUSED_MLP=1 with the kernel gates
  open on both sides: the port reaches `ln_qkv_attn_proj` / `ln_mlp` (their
  plain versions on CPU tensors), and forward_test agrees with the JAX
  forward at 1e-4 (tests/test_torch_port_model.py's bound).
- `split_hilo_plain`: hi + lo within 2^-17 |w| of w; the three-pass product
  (`hilo_dot_plain`) within 2^-16 |a| |w| (summed over k) of the fp32
  product. The cache: one split per weight, a refill in place after an
  in-place update (`_version`), an entry gone with its weight, a refusal
  under CUDA-graph capture, and the CPU path never filling it.
"""

import numpy as np
import pytest
import torch

from test_torch_port_ops import _ln_case, _t
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import build, hilo
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

ATOL, RTOL = 5e-5, 5e-4


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import attention as jattn
    from uvltrack_tpu.ops import pallas_attention as pa
    return jnp, jattn, pa


def _proj(c=64, seed=17):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32),  # flax (in, out)
            (rng.normal(size=(c,)) * 0.02).astype(np.float32))


def _mlp(n, c=64, f=256, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, n, c)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            (0.1 * rng.normal(size=c)).astype(np.float32),
            (rng.normal(size=(c, f)) / np.sqrt(c)).astype(np.float32),
            (0.02 * rng.normal(size=f)).astype(np.float32),
            (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32),
            (0.02 * rng.normal(size=c)).astype(np.float32))


# ------------------------------------------------ plain versions vs JAX
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 130])
def test_fused_proj_plain_fp32_matches_xla_and_the_interpreter(n, mask, monkeypatch):
    """Kernel #4's plain version with fp32 weights and stream ==
    _xla_ln_qkv_attn_proj (the JAX twin) and == ln_qkv_attn_proj_trainable
    with its kernel in the Pallas interpreter."""
    jnp, _, pa = _jax()
    x, g, be, w, wb, kb = _ln_case(n, b=2, mask=mask, seed=41)
    wp, bp = _proj()
    args = [jnp.asarray(a) for a in (x, g, be, w, wb, wp, bp, kb)]
    xla = pa._xla_ln_qkv_attn_proj(*args, heads=4)
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    kern = pa.ln_qkv_attn_proj_trainable(4, 1e-6, *args)
    out = lqp.ln_qkv_attn_proj_plain(_t(x), _t(g), _t(be), _t(w.T), _t(wb), _t(wp.T), _t(bp),
                                     _t(kb), heads=4)
    assert out.dtype == torch.float32
    for ref in (xla, kern):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [21, 130])
def test_ln_mlp_plain_fp32_matches_xla(n):
    """Kernel #7's plain version with fp32 weights == _xla_ln_mlp: the hidden
    tensor and the output stay fp32."""
    jnp, _, pa = _jax()
    x, g, be, w1, b1, w2, b2 = _mlp(n)
    ref = pa._xla_ln_mlp(*(jnp.asarray(a) for a in (x, g, be, w1, b1, w2, b2)))
    out = lm.ln_mlp_plain(_t(x), _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("knob", ["UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP"])
def test_fp32_forward_under_the_knobs_matches_jax(knob, monkeypatch):
    """The tiny fp32-compute UVLTrack's forward_test with the kernel gates
    open at 16 tokens and `knob` set, on both packages: the port enters its
    fused entry point in every block (plain versions on CPU tensors), and
    agrees with the JAX forward, whose Pallas kernels run in the
    interpreter."""
    import functools

    import jax

    from test_torch_port_model import _inputs, make_pair
    from uvltrack_tpu.models.uvltrack import UVLTrack as JUVLTrack

    jnp, jattn, pa = _jax()
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setattr(jattn, "_BACKEND", "pallas")
    monkeypatch.setattr(pa, "_on_tpu", lambda: True)
    monkeypatch.setattr(pa, "_FORCE_INTERPRET", True)
    for k in ("UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_PREFIX"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setenv(knob, "1")
    entered = []
    mod, name = (lqp, "ln_qkv_attn_proj") if knob.endswith("PROJ") else (lm, "ln_mlp")
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: entered.append(name) or orig(*a, **k))
    jm, v, tm = make_pair()
    tz, sx, ids, mask, _, _, flag = _inputs(0, seed=6)
    prompt = np.random.default_rng(7).normal(size=(2, 3, 32)).astype(np.float32)
    fn = jax.jit(functools.partial(jm.apply, method=JUVLTrack.forward_test))
    ref = fn(v, *(jnp.asarray(a) for a in (tz, sx, ids, mask, prompt, flag)))
    with torch.no_grad():
        out = tm.forward_test(*(_t(a) for a in (tz, sx, ids, mask, prompt, flag)))
    assert len(entered) == len(tm.backbone.vit.blocks)
    for key in ("cls_score_test", "bbox_map", "cont_score"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key], np.float32),
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- the planes
def test_split_hilo_plain_reconstructs_and_three_passes_hold_fp32():
    """hi + lo within 2^-17 |w| (split_bf16's bound, hi the nearest bf16);
    the three passes within 2^-16 sum_k |a||w| of the fp32 product (the
    dropped lo.lo term and the two splits' residues)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.normal(size=(96, 64)) * np.exp(rng.normal(size=(96, 64))))
                         .astype(np.float32))
    p = hilo.split_hilo_plain(w)
    assert p.shape == (2, 96, 64) and p.dtype == torch.bfloat16
    assert torch.equal(p[0], w.to(torch.bfloat16))
    err = (p[0].double() + p[1].double() - w.double()).abs()
    assert bool((err <= 2.0 ** -17 * w.double().abs()).all())
    a = torch.from_numpy(rng.normal(size=(33, 64)).astype(np.float32))
    got = hilo.hilo_dot_plain(a, p).double()
    want = a.double() @ w.double().t()
    assert bool(((got - want).abs() <= 2.0 ** -16 * (a.double().abs() @ w.double().abs().t()))
                .all())
    # CPU tensors take the plain version, into `out` when given
    out = torch.empty_like(p)
    assert hilo.split_hilo(w, out=out) is out and torch.equal(out, p)


@pytest.fixture
def spied(monkeypatch):
    """The split's launch recorded instead of run (meta tensors stand in
    for the card's), the cache empty before and after."""
    calls = []
    monkeypatch.setattr(hilo, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "launch", lambda kernel, inst, *a, **k: calls.append(
        (kernel, inst)))
    hilo.clear_cache()
    yield calls
    hilo.clear_cache()


def test_the_cache_splits_once_and_again_after_an_update(spied, monkeypatch):
    w = torch.empty((192, 64), device="meta")
    first = hilo.planes(w)
    assert first.shape == (2, 192, 64) and first.dtype == torch.bfloat16
    assert hilo.planes(w) is first and spied == [("split_hilo", "fp32w")]
    assert hilo.cache_bytes() == 4 * w.numel()
    w.mul_(2.0)  # an in-place update (an optimizer step) bumps _version
    assert hilo.planes(w) is first and len(spied) == 2  # split again, in place
    assert hilo.planes(w) is first and len(spied) == 2
    other = torch.empty((192, 64), device="meta")
    assert hilo.planes(other) is not first and len(spied) == 3
    del w
    assert hilo.cache_bytes() == 4 * other.numel()  # the entry went with its weight
    # no split is recorded into a CUDA graph: a fill under capture is refused
    fresh = torch.empty((64, 64), device="meta")
    monkeypatch.setattr(hilo, "_capturing", lambda t: True)
    with pytest.raises(ValueError, match="outside CUDA-graph capture"):
        hilo.planes(fresh)
    assert hilo.planes(other) is not None and len(spied) == 3  # a cached one is fine
    # a tensor made under inference_mode has no version counter: split every call
    monkeypatch.setattr(hilo, "_capturing", lambda t: False)
    with torch.inference_mode():
        frozen = torch.empty((64, 64), device="meta")
    hilo.planes(frozen), hilo.planes(frozen)
    assert len(spied) == 5 and hilo.cache_bytes() == 4 * other.numel()


def test_the_cpu_path_never_fills_the_cache(monkeypatch):
    """fp32 weights on CPU tensors, through every fp32-weight entry point on
    the kernel route: plain versions, no launch, an empty cache."""
    hilo.clear_cache()
    build.reset_launch_counts()
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "16")
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", "1")
    monkeypatch.setenv("UVLTRACK_FUSED_MLP", "1")
    x, g, be, w, wb, kb = (_t(a) for a in _ln_case(40, b=2, seed=5))
    wp, bp = (_t(a) for a in _proj())
    w, wp = w.t().contiguous(), wp.t().contiguous()  # Linear layout
    out = tattn.attention_block_core(x, g, be, w, wb, wp, bp, 4, kb[:, None, None, :],
                                     compute_dtype=torch.float32)
    want = lqp.ln_qkv_attn_proj_plain(x, g, be, w, wb, wp, bp, kb, heads=4)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    m = _mlp(40)
    args = (_t(m[0]), _t(m[1]), _t(m[2]), _t(m[3].T), _t(m[4]), _t(m[5].T), _t(m[6]))
    torch.testing.assert_close(tattn.ln_mlp_core(*args, compute_dtype=torch.float32),
                               lm.ln_mlp_plain(*args), rtol=0, atol=0)
    assert hilo._CACHE == {} and hilo.cache_bytes() == 0
    assert build.launch_counts() == dict.fromkeys(build.SOURCES, 0)
