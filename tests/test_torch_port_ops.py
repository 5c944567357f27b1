"""uvltrack_tpu_torch ops against the JAX package: the kernel's plain version
against the Pallas kernel run in interpret mode, the attention entry points
against their JAX counterparts, and (marker `gpu`, skipped without a card)
the CUDA kernels against their plain versions on the card.

Inputs come from numpy seeds and go through both frameworks; weights are
handed over in each framework's layout (flax (in, out), torch (out, in)).
CPU comparisons run in fp32: tolerance 5e-5 abs / 5e-4 rel, the tolerance of
the JAX package's own kernel tests (tests/test_pallas_attention.py).

The machine with the card has no JAX, so this module imports JAX inside the
CPU tests (`_jax()`), and the `gpu` tests run there with
`python -m pytest tests/test_torch_port_ops.py -m gpu --noconftest`.
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

ATOL, RTOL = 5e-5, 5e-4
REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax():
    """The oracle: the JAX package's attention ops, with jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import attention as jattn
    from uvltrack_tpu.ops import pallas_attention as pa
    return jnp, jattn, pa


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _ln_case(n, c=64, b=1, seed=7, mask="random"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    g = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    be = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)  # flax (in, out)
    wb = (rng.normal(size=(3 * c,)) * 0.02).astype(np.float32)
    if mask == "random":
        masked = rng.random((b, n)) < 0.3
        masked[:, 0] = False
    elif mask == "tail":  # flag-0 style: the last 40 (text) keys masked
        masked = np.zeros((b, n), bool)
        masked[:, -min(40, n - 1):] = True
    else:
        masked = np.zeros((b, n), bool)
    kb = np.where(masked, -1e10, 0.0).astype(np.float32)
    return x, g, be, w, wb, kb


@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 361])
def test_ln_qkv_attention_plain_matches_pallas_kernel(n, mask):
    """Kernel #1's plain version == _ln_qkv_attn_kernel in the Pallas
    interpreter (and its XLA twin) on the same inputs."""
    jnp, jattn, pa = _jax()
    x, g, be, w, wb, kb = _ln_case(n, mask=mask)
    ref = pa.fused_ln_qkv_attention(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be),
                                    jnp.asarray(w), jnp.asarray(wb), jnp.asarray(kb),
                                    heads=4, interpret=True)
    out = lqa.ln_qkv_attention_plain(_t(x), _t(g), _t(be), _t(w.T), _t(wb), _t(kb), heads=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    xla = pa._xla_ln_qkv_attention(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be),
                                   jnp.asarray(w), jnp.asarray(wb), jnp.asarray(kb), heads=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [48, 361])
def test_qkv_attention_plain_matches_pallas_qkv_kernel(n):
    """The attention half == _attn_kernel_qkv (kernel #2) in the interpreter."""
    jnp, jattn, pa = _jax()
    rng = np.random.default_rng(3)
    h, d = 2, 64
    qkv = rng.normal(size=(1, n, 3 * h * d)).astype(np.float32)
    masked = rng.random((1, n)) < 0.3
    masked[:, 0] = False
    kb = np.where(masked, -1e10, 0.0).astype(np.float32)
    ref = pa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(kb), heads=h, interpret=True)
    out = lqa.qkv_attention_plain(_t(qkv), _t(kb), heads=h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_ln_qkv_plain_matches_xla_ln_qkv():
    jnp, jattn, pa = _jax()
    x, g, be, w, wb, _ = _ln_case(40, seed=1)
    ref = pa._xla_ln_qkv(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be),
                         jnp.asarray(w), jnp.asarray(wb))
    out = lqa.ln_qkv_plain(_t(x), _t(g), _t(be), _t(w.T), _t(wb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_masked_keys_get_no_weight():
    """exp(clip(-1e10, -80)) = e^-80: perturbing masked values changes nothing."""
    rng = np.random.default_rng(5)
    h, d, n = 2, 16, 64
    qkv = rng.normal(size=(1, n, 3 * h * d)).astype(np.float32)
    masked = rng.random((1, n)) < 0.4
    masked[:, 0] = False
    kb = _t(np.where(masked, -1e10, 0.0))
    out = lqa.qkv_attention_plain(_t(qkv), kb, h)
    qkv2 = qkv.copy()
    qkv2[:, masked[0], 2 * h * d:] += 100.0
    out2 = lqa.qkv_attention_plain(_t(qkv2), kb, h)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-6)


def test_fast_variance_clamps_at_zero():
    """A large-mean near-constant row: mean(x^2) - mean^2 can go negative in
    fp32; the clamp keeps rsqrt finite, as in flax and the kernel."""
    x = torch.full((1, 2, 64), 3000.0)
    x[0, 1, 0] += 1e-3
    y = lqa.layer_norm_fast_var(x, torch.ones(64), torch.zeros(64), 1e-6)
    assert torch.isfinite(y).all()


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    build.reset_launch_counts()
    x, g, be, w, wb, kb = _ln_case(130, seed=2)
    args = (_t(x), _t(g), _t(be), _t(w.T), _t(wb))
    qkv = lqa.ln_qkv(*args)
    torch.testing.assert_close(qkv, lqa.ln_qkv_plain(*args), rtol=0, atol=0)
    out = lqa.qkv_attention(qkv, _t(kb), 4)
    torch.testing.assert_close(out, lqa.qkv_attention_plain(qkv, _t(kb), 4), rtol=0, atol=0)
    assert build.launch_counts() == dict.fromkeys(build.SOURCES, 0)


@pytest.mark.parametrize("n", [21, 130])
def test_attention_block_core_matches_jax(n):
    """x + proj(attn(qkv(LN x))) on the port's "cuda" backend (CPU tensors
    compose the plain math) == the JAX entry point."""
    jnp, jattn, pa = _jax()
    x, g, be, w, wb, kb = _ln_case(n, c=32, b=2, seed=4)
    rng = np.random.default_rng(8)
    wp = (rng.normal(size=(32, 32)) / 6).astype(np.float32)
    bp = (rng.normal(size=(32,)) * 0.1).astype(np.float32)
    jb = jnp.asarray(kb)[:, None, None, :]
    ref = jattn.attention_block_core(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be),
                                     jnp.asarray(w), jnp.asarray(wb), jnp.asarray(wp),
                                     jnp.asarray(bp), 4, jb)
    tattn.force_backend("cuda")
    try:
        out = tattn.attention_block_core(_t(x), _t(g), _t(be), _t(w.T), _t(wb), _t(wp.T),
                                         _t(bp), 4, _t(np.asarray(jb)))
    finally:
        tattn.force_backend(None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_ln_mlp_core_matches_jax():
    jnp, jattn, pa = _jax()
    rng = np.random.default_rng(11)
    c, f = 32, 128
    x = rng.normal(size=(2, 9, c)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    be = (0.1 * rng.normal(size=c)).astype(np.float32)
    w1 = (rng.normal(size=(c, f)) / 6).astype(np.float32)
    b1 = (0.1 * rng.normal(size=f)).astype(np.float32)
    w2 = (rng.normal(size=(f, c)) / 11).astype(np.float32)
    b2 = (0.1 * rng.normal(size=c)).astype(np.float32)
    ref = jattn.ln_mlp_core(*(jnp.asarray(a) for a in (x, g, be, w1, b1, w2, b2)))
    out = tattn.ln_mlp_core(_t(x), _t(g), _t(be), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_plain_attention_and_key_padding_bias_match_jax():
    jnp, jattn, pa = _jax()
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 4, 40, 8)).astype(np.float32) for _ in range(3))
    masked = rng.random((2, 40)) < 0.3
    jb = jattn.key_padding_bias(jnp.asarray(masked))
    tb = tattn.key_padding_bias(torch.from_numpy(masked))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    out = tattn.plain_attention(_t(q), _t(k), _t(v), tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_backend_switch_semantics():
    """set_backend yields to a force_backend pin, and clearing the pin goes
    back to set_backend's last choice; names map xla->plain, pallas->cuda;
    unknown names raise."""
    start = tattn.get_backend()
    try:
        tattn.set_backend("cuda")
        assert tattn.get_backend() == "cuda"
        tattn.force_backend("plain")
        tattn.set_backend("cuda")
        assert tattn.get_backend() == "plain"
        tattn.force_backend(None)
        assert tattn.get_backend() == "cuda"
        tattn.set_backend("plain")
        tattn.force_backend("cuda")
        assert tattn.get_backend() == "cuda"
        tattn.force_backend(None)
        assert tattn.get_backend() == "plain"
        with pytest.raises(ValueError):
            tattn.set_backend("pallas")
        with pytest.raises(ValueError):
            tattn.force_backend("xla")
    finally:
        tattn.force_backend(None)
        tattn.set_backend(start)


def test_cuda_backend_is_the_default_in_a_fresh_process():
    """A model built without build_model (modules made directly and moved to
    the card) takes the kernels: the backend starts as "cuda"."""
    out = subprocess.run(
        [sys.executable, "-c", "from uvltrack_tpu_torch.ops import attention; "
         "print(attention.get_backend())"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "cuda"


_IMPORT = re.compile(r"^\s*(import jax|from jax|import flax|from flax|import msgpack|"
                     r"from msgpack|import uvltrack_tpu\b(?!_torch)|from uvltrack_tpu\.|"
                     r"from uvltrack_tpu import)", re.M)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "uvltrack_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(p.relative_to(REPO / "uvltrack_tpu_torch")) for p in files[:-1]}
    assert {"ops/quant.py", "ops/ln_qkv_attn_proj.py", "ops/ln_qkv_attention.py",
            "track/batch.py", "track/pool.py", "eval/__init__.py", "eval/data.py",
            "eval/running.py", "eval/running_batched.py", "eval/visualize.py",
            "native/__init__.py", "utils/lmdb_utils.py", "utils/lmdb_native.py",
            "data/transforms.py", "data/processing_utils.py", "data/grounding_aug.py",
            "data/processing.py", "data/sampler.py", "data/builders.py", "data/loader.py",
            "data/datasets/base.py", "data/datasets/video_datasets.py",
            "data/datasets/image_datasets.py", "data/datasets/lmdb_datasets.py",
            "cli/train.py", "cli/prewarm.py", "tools/data_fixtures.py", "cli/profile.py",
            "cli/export.py", "cli/parity.py", "cli/demo.py", "cli/setup_env.py",
            "ops/library.py", "ops/prroi_pool.py", "registry.py", "utils/costs.py",
            "utils/msgpack_native.py"} <= names
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files for m in _IMPORT.finditer(p.read_text())]
    assert offenders == []


def test_kernel_sources_ship_with_the_package():
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\" int uvl_" in src and "cudaGetLastError" in src
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "build/" in (REPO / ".gitignore").read_text()


# ------------------------------------------------------------- on the card
# Run on a machine with a card: python -m pytest tests/test_torch_port_ops.py -m gpu
# bf16 tolerance of kernel vs plain: both round qkv, P and the output to bf16
# at the same points; sums are taken in another order, so one bf16 rounding
# step may differ: |diff| <= 2e-2 * |plain| + atol. The absolute term is
# about two bf16 steps at each output's scale: qkv (|qkv| about 1 to 8)
# takes 2e-2, the attention output (|out| about 0.1: the softmax spreads
# over a hundred keys and more) 6e-3, so a few wrongly masked keys cannot
# hide under it.
GPU_ATOL, GPU_RTOL = 2e-2, 2e-2
GPU_ATTN_ATOL = 6e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gpu_case(n, mask, x_dtype, dev, c=768, seed=0, b=1):
    x, g, be, w, wb, kb = _ln_case(n, c=c, b=b, seed=seed, mask=mask)
    return (_t(x).to(dev, x_dtype), _t(g).to(dev), _t(be).to(dev),
            _t(w.T).to(dev, torch.bfloat16).contiguous(), _t(wb).to(dev), _t(kb).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask", ["random", "tail", "open"])
@pytest.mark.parametrize("n", [48, 321, 361, 681])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_kernels_match_plain(cuda, b, n, mask, x_dtype):
    """ln_qkv and qkv_attention at B = 1 and at the lockstep batches 4 and 8
    (B*N rows through the GEMM core, a key bias a row)."""
    x, g, be, w, wb, kb = _gpu_case(n, mask, x_dtype, cuda, b=b)
    build.reset_launch_counts()
    qkv = lqa.ln_qkv(x, g, be, w, wb)
    out = lqa.qkv_attention(qkv, kb, 12)
    torch.cuda.synchronize()
    assert build.launch_counts() == dict(dict.fromkeys(build.SOURCES, 0), ln_qkv=1,
                                         qkv_attention=1)
    qkv_ref = lqa.ln_qkv_plain(x, g, be, w, wb)
    torch.testing.assert_close(qkv.float(), qkv_ref.float(), atol=GPU_ATOL, rtol=GPU_RTOL)
    # the attention kernel on the same qkv, then the composition (#1)
    on_kernel_qkv = lqa.qkv_attention_plain(qkv, kb, 12)
    torch.testing.assert_close(out.float(), on_kernel_qkv.float(),
                               atol=GPU_ATTN_ATOL, rtol=GPU_RTOL)
    ref = lqa.ln_qkv_attention_plain(x, g, be, w, wb, kb, 12)
    attn_tol = GPU_ATTN_ATOL + GPU_RTOL * on_kernel_qkv.double().abs()
    qkv_part = _qkv_rounding_bound(qkv, qkv_ref, kb, 12)
    gap = (out.double() - ref.double()).abs()
    i = int((gap - attn_tol - qkv_part).argmax())
    parts = {"gap": gap.flatten()[i], "attention kernel's part":
             (out.double() - on_kernel_qkv.double()).abs().flatten()[i],
             "qkv part": (on_kernel_qkv.double() - ref.double()).abs().flatten()[i],
             "attention tolerance": attn_tol.flatten()[i], "qkv bound": qkv_part.flatten()[i]}
    assert bool((gap <= attn_tol + qkv_part).all()), {k: float(v) for k, v in parts.items()}


def _qkv_rounding_bound(qkv_k, qkv_p, key_bias, heads):
    """A bound on |P(Q_k) - P(Q_p)| elementwise: what the plain attention P
    makes of the difference between two qkv, Q_k (ln_qkv's) and Q_p
    (ln_qkv_plain's), each held at GPU_ATOL/GPU_RTOL above.

    Per row i, head h: with p, p' the softmaxes of the clamped logits of
    Q_p and Q_k, and delta the largest logit change over the keys, p'_j /
    p_j lies in [exp(-2 delta), exp(2 delta)], so out' - out = sum_j p'_j
    (v'_j - v_j) + sum_j (p'_j - p_j) v_j is at most sum_j p'_j |dv_j| +
    (exp(2 delta) - 1) sum_j p_j |v_j|. P rounds e and its output to bf16
    (unit roundoff u = 2^-9): each side's weights move by at most 2u and
    its output by u |out|; 1e-6 covers the fp32 sums. Where few keys are
    open, one bf16 step of v (7.8e-3 at |v| = 1) reaches the output whole,
    which no fixed atol at the output's scale covers."""
    b, n, f = qkv_p.shape
    d, u = f // (3 * heads), 2.0 ** -9

    def parts(qkv):
        q, k, v = qkv.double().reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        s = (q @ k.transpose(-1, -2) * d ** -0.5 + key_bias.double()[:, None, None, :])
        return s.clamp(-lqa.CLAMP, lqa.CLAMP), v

    s_k, v_k = parts(qkv_k)
    s_p, v_p = parts(qkv_p)
    p_k, p_p = torch.softmax(s_k, -1), torch.softmax(s_p, -1)
    delta = (s_k - s_p).abs().amax(-1, keepdim=True)
    mass_k, mass_p = p_k @ v_k.abs(), p_p @ v_p.abs()
    bound = (p_k @ (v_k - v_p).abs() + torch.expm1(2 * delta) * mass_p
             + 2 * u * (mass_k + mass_p) + u * ((p_k @ v_k).abs() + (p_p @ v_p).abs()) + 1e-6)
    return bound.transpose(1, 2).reshape(b, n, heads * d)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,c", [(1, 65, 768), (2, 321, 768), (2, 361, 768),
                                   (1, 361, 1024), (2, 65, 1024), (1, 321, 192)])
def test_cuda_ln_qkv_on_the_wgmma_core_matches_plain(cuda, b, n, c, x_dtype):
    """The TMA + wgmma ln_qkv (csrc/gemm_sm90.cuh) at ragged M (65 = 64 + 1:
    one row in the last tile; 321, 361), M = B*N with B = 2, ViT-L's C=1024
    (128 KB of normalized rows in shared memory) and C=192 (F=576: a last
    column tile half past F), for bf16 and fp32 x."""
    x, g, be, w, wb, _ = _gpu_case(n, "open", x_dtype, cuda, c=c, seed=n + c, b=b)
    build.reset_launch_counts()
    qkv = lqa.ln_qkv(x, g, be, w, wb)
    torch.cuda.synchronize()
    tag = "fp32x" if x_dtype == torch.float32 else "bf16x"
    assert build.instantiation_counts() == {f"ln_qkv[{tag}-bf16w]": 1}
    assert qkv.shape == (b, n, 3 * c) and qkv.dtype == torch.bfloat16
    ref = lqa.ln_qkv_plain(x, g, be, w, wb)
    torch.testing.assert_close(qkv.float(), ref.float(), atol=GPU_ATOL, rtol=GPU_RTOL)
    # a second call (the weight's TMA descriptor from the cache) repeats it
    torch.testing.assert_close(lqa.ln_qkv(x, g, be, w, wb), qkv, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_per_batch_element(cuda):
    """B=3: rows of every batch element go through ln_qkv as one (B*N, C)
    matrix, and qkv_attention keeps each element's keys and key bias apart."""
    x, g, be, w, wb, kb = _gpu_case(200, "random", torch.bfloat16, cuda, b=3)
    out = lqa.ln_qkv_attention(x, g, be, w, wb, kb, 12)
    torch.cuda.synchronize()
    ref = lqa.ln_qkv_attention_plain(x, g, be, w, wb, kb, 12)
    torch.testing.assert_close(out.float(), ref.float(), atol=GPU_ATTN_ATOL, rtol=GPU_RTOL)
    one = lqa.ln_qkv_attention(x[1:2].contiguous(), g, be, w, wb, kb[1:2].contiguous(), 12)
    torch.testing.assert_close(out[1:2].float(), one.float(), atol=GPU_ATTN_ATOL,
                               rtol=GPU_RTOL)


@pytest.mark.gpu
def test_cuda_dispatch_launches_on_the_cuda_backend_only(cuda):
    x, g, be, w, wb, kb = _gpu_case(361, "tail", torch.bfloat16, cuda)
    bias = kb[:, None, None, :]
    build.reset_launch_counts()
    try:
        tattn.force_backend("plain")
        tattn.attention_ln_qkv_core(x, g, be, w, wb, 12, bias, torch.bfloat16)
        assert build.launch_counts()["ln_qkv"] == 0
        tattn.force_backend("cuda")
        tattn.attention_ln_qkv_core(x, g, be, w, wb, 12, bias, torch.bfloat16)
        tattn.attention_ln_qkv_core(x[:, :40], g, be, w, wb, 12, bias[..., :40],
                                    torch.bfloat16)  # N < 128: plain
    finally:
        tattn.force_backend(None)
    assert build.launch_counts() == dict(dict.fromkeys(build.SOURCES, 0), ln_qkv=1,
                                         qkv_attention=1)


@pytest.mark.gpu
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x, g, be, w, wb, kb = _gpu_case(64, "open", torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        lqa.ln_qkv(x, g, be, w.float(), wb)  # fp32 weight
    with pytest.raises(ValueError):
        lqa.ln_qkv(x, g, be, w.t(), wb)  # wrong shape / not contiguous
    qkv = lqa.ln_qkv(x, g, be, w, wb)
    with pytest.raises(ValueError):
        lqa.qkv_attention(qkv, kb.cpu(), 12)  # mixed devices
    with pytest.raises(ValueError):
        lqa.qkv_attention(qkv, kb, 24)  # head dim 32


# fp32 compute (the fp32 attention body, three bf16 hi/lo passes a product):
# |diff| <= 2e-4 + 2e-4 * |plain|, fp32 sums in another order (the passes
# keep 2^-17 of each operand), as tests/test_torch_port_quant.py
GPU_F32_TOL = 2e-4


def _qkv_attention_case(b, n, heads, mask, dtype, dev, seed=0):
    """qkv (B, N, 3*H*64) from a normal draw, in the body's type, and its
    (B, N) key bias: the masks of _ln_case (random, tail, open) or all: every
    key of batch element 0 at -1e10 (the row averages v), random on the
    rest."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3 * heads * 64)).astype(np.float32)
    masked = np.zeros((b, n), bool)
    if mask in ("random", "all"):
        masked = rng.random((b, n)) < 0.3
        masked[:, 0] = False
    elif mask == "tail":
        masked[:, -min(40, n - 1):] = True
    if mask == "all":
        masked[0] = True
    kb = np.where(masked, -1e10, 0.0).astype(np.float32)
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    return _t(qkv).to(dev, dt), _t(kb).to(dev)


def _attention_close(out, ref, dtype):
    if dtype == "fp32":
        torch.testing.assert_close(out, ref, atol=GPU_F32_TOL, rtol=GPU_F32_TOL)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=GPU_ATTN_ATOL, rtol=GPU_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mask", ["random", "tail", "open", "all"])
@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [40, 63, 64, 65, 128, 321, 361, 681])
def test_cuda_qkv_attention_bodies_match_plain(cuda, n, b, heads, mask, dtype):
    """Both wgmma attention bodies (csrc/attention.cuh) from the fused qkv
    layout at ragged N (one key and one query row past a 64-row tile at 65,
    one short at 63), B = 2, 4, 8 (the next element's rows must never enter
    a tile; the lockstep batches), C = 768 and UVLTrack-L's C = 1024, with an
    all-masked row."""
    qkv, kb = _qkv_attention_case(b, n, heads, mask, dtype, cuda, seed=n + heads + b)
    build.reset_launch_counts()
    out = lqa.qkv_attention(qkv, kb, heads)
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {f"qkv_attention[{dtype}]": 1}
    assert out.shape == (b, n, heads * 64) and out.dtype == qkv.dtype
    _attention_close(out, lqa.qkv_attention_plain(qkv, kb, heads), dtype)


# (N, the cluster split csrc/attention.cuh's rule picks at B=1, H=12 in
# both types)
SPLIT_CASES = [(128, 1), (681, 2), (361, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,split", SPLIT_CASES, ids=[f"N{n}-split{s}" for n, s in SPLIT_CASES])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_cuda_qkv_attention_is_deterministic(cuda, b, dtype, n, split):
    """Two calls of each body are bitwise equal at shapes where the rule
    keeps the keys in one block (split 1) and splits them over clusters of
    2 and 3 blocks (the partials summed in rank order; N=361 is the main
    path's joint blocks), at B = 1 and at the lockstep batches 4 and 8
    (where the rule sees B*H times the tiles), and each matches the plain
    version."""
    qkv, kb = _qkv_attention_case(b, n, 12, "tail", dtype, cuda, seed=split)
    first = lqa.qkv_attention(qkv, kb, 12)
    second = lqa.qkv_attention(qkv, kb, 12)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _attention_close(first, lqa.qkv_attention_plain(qkv, kb, 12), dtype)


# A fresh process (the backend at its default), a bf16 model of 4 blocks at
# C=128, 2 heads (head dim 64) and 128/256 px crops (N=321, then 329 with the
# text), made from the modules without build_model and moved with .cuda().
_FRESH_MODEL = """
import torch
from uvltrack_tpu_torch.models.bert import BertConfig
from uvltrack_tpu_torch.models.head import MABH
from uvltrack_tpu_torch.models.mufe import MUFE
from uvltrack_tpu_torch.models.uvltrack import UVLTrack, cast_inference_params, init_model
from uvltrack_tpu_torch.ops import build

dev = {dev!r}
bert = BertConfig(vocab_size=100, hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=256, max_position=16)
model = UVLTrack(
    MUFE(embed_dim=128, depth=4, num_heads=2, template_size=128, search_size=256,
         fusion_layers=(2, 3), cont_loss_layers=(1, 2, 3), bert=bert, dtype=torch.bfloat16),
    MABH(inplanes=128, channel=64, feat_sz=16, cls_tokenize=False, softmax_one=True,
         dtype=torch.bfloat16))
model = cast_inference_params(init_model(model, 0)).to(dev).eval()
g = torch.Generator().manual_seed(0)
template = torch.randn(1, 128, 128, 3, generator=g).to(dev)
search = torch.randn(1, 256, 256, 3, generator=g).to(dev)
ids = torch.randint(0, 100, (1, 8), generator=g, dtype=torch.int32).to(dev)
mask = torch.ones(1, 8, dtype=torch.int32).to(dev)
flag = torch.full((1,), 2, dtype=torch.int32).to(dev)
tmask = (torch.rand(1, 64, generator=g) > 0.5).to(dev)
cmask = (torch.rand(1, 256, generator=g) > 0.5).to(dev)
with torch.no_grad():
    prompt = model.forward_prompt_init(template, search, ids, mask, tmask, cmask, flag)
    out = model.forward_test(template, search, ids, mask, prompt, flag)
assert torch.isfinite(out["bbox_map"].float()).all()
print(build.launch_counts())
"""


@pytest.mark.gpu
def test_model_built_without_build_model_launches_the_kernels(cuda):
    """4 blocks x 2 backbone passes (forward_prompt_init, forward_test);
    BERT's 8-token layers stay plain."""
    out = subprocess.run([sys.executable, "-c", _FRESH_MODEL.format(dev="cuda")],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    counts = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert counts == dict(dict.fromkeys(build.SOURCES, 0), ln_qkv=8, qkv_attention=8)
