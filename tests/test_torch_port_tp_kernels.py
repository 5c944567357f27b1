"""The tensor-parallel shares of kernels #4 and #7 on the card: a rank's
fp32 share of the projection (ops/ln_qkv_attn_proj.py::proj_partial, the
large-M body of csrc/proj_residual.cu's uvl_dense) and of the MLP
(ops/ln_mlp.py::ln_mlp_partial, ln_mlp's `-fp32o` pair on the same body)
against their plain versions at a rank's widths (K = C/tp, F = 4C/tp for B
and L at tp 2, 4 and 8), at B*N rows that end inside a 128-row tile, and
bitwise on a second call; the new entry's refusals. Every test needs a card
(`-m gpu`); this module imports no JAX, as the card's machine has none.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

# the projection's share: fp32 sums of exact bf16 products in another order
# than the plain version's (chip_smoke.py's TP_PARTIAL rule); the MLP's
# share: the bf16 hidden tensor may round one step apart (ln_mlp's rule)
PROJ_ATOL, PROJ_RTOL = 2e-4, 2e-4
MLP_ATOL, MLP_RTOL, HIDDEN_ATOL = 6e-3, 2e-2, 2e-2
# (C, tp): B at tp 2 and 4, L at tp 2 and 8 (K = 128)
SHARES = [(768, 2), (768, 4), (1024, 2), (1024, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _share_case(c, tp, b, n, x_dtype, dev, seed=0):
    rng = np.random.default_rng(seed + c + tp + n)
    k, f = c // tp, 4 * c // tp

    def arr(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    b16 = torch.bfloat16
    return {"x": arr(rng.normal(size=(b, n, c)), x_dtype),
            "g": arr(1 + 0.1 * rng.normal(size=c)), "be": arr(0.1 * rng.normal(size=c)),
            "attn": arr(0.3 * rng.normal(size=(b, n, k)), b16),
            "wp": arr(rng.normal(size=(c, k)) / np.sqrt(k), b16),
            "w1": arr(rng.normal(size=(f, c)) / np.sqrt(c), b16),
            "b1": arr(0.02 * rng.normal(size=f)),
            "w2": arr(rng.normal(size=(c, f)) / np.sqrt(4 * c), b16)}


@pytest.mark.gpu
@pytest.mark.parametrize("c,tp", SHARES)
@pytest.mark.parametrize("b,n", [(2, 361), (3, 65)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_cuda_tp_shares_match_plain(cuda, c, tp, b, n, x_dtype):
    """Both shares against their plain versions (M = 722 and 195: the last
    128-row tile partly and, at 195, one warpgroup's rows wholly past M),
    each of #7's launches alone too, and both bitwise on a second call."""
    t = _share_case(c, tp, b, n, x_dtype, cuda)
    build.reset_launch_counts()
    part = lqp.proj_partial(t["attn"], t["wp"])
    again = lqp.proj_partial(t["attn"], t["wp"])
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {"proj_residual[bf16a-bf16w-fp32o]": 2}
    assert part.dtype == torch.float32 and part.shape == (b, n, c)
    torch.testing.assert_close(part, lqp.proj_partial_plain(t["attn"], t["wp"]),
                               atol=PROJ_ATOL, rtol=PROJ_RTOL)
    assert torch.equal(part, again)

    args = (t["x"], t["g"], t["be"], t["w1"], t["b1"], t["w2"])
    build.reset_launch_counts()
    mlp = lm.ln_mlp_partial(*args)
    mlp2 = lm.ln_mlp_partial(*args)
    torch.cuda.synchronize()
    xt = "bf16x" if x_dtype == torch.bfloat16 else "fp32x"
    assert build.instantiation_counts() == {f"ln_mlp[{xt}-bf16w-fp32o]": 2}
    torch.testing.assert_close(mlp, lm.ln_mlp_partial_plain(*args), atol=MLP_ATOL,
                               rtol=MLP_RTOL)
    assert torch.equal(mlp, mlp2)

    f = t["w1"].shape[0]
    hidden = torch.empty((b * n, f), dtype=torch.bfloat16, device=cuda)
    out = torch.empty((b, n, c), dtype=torch.float32, device=cuda)
    lm.launch_ln_mlp(*args[:5], t["w2"], None, hidden, out, stages="ln_fc1_gelu")
    h_ref = lm.ln_fc1_gelu_plain(*args[:5]).to(torch.bfloat16)
    torch.testing.assert_close(hidden.view(b, n, f).float(), h_ref.float(), atol=HIDDEN_ATOL,
                               rtol=MLP_RTOL)
    hidden.copy_(h_ref.view(b * n, f))
    lm.launch_ln_mlp(*args[:5], t["w2"], None, hidden, out, stages="fc2_bias")
    torch.testing.assert_close(out, lqp.proj_partial_plain(h_ref, t["w2"]), atol=PROJ_ATOL,
                               rtol=PROJ_RTOL)


@pytest.mark.gpu
def test_cuda_proj_partial_refuses_what_the_kernel_does_not_take(cuda):
    """K not a multiple of 64, a non-contiguous w_proj, mixed dtypes: each
    raises before a launch."""
    b16 = torch.bfloat16
    build.reset_launch_counts()
    for k in (96, 160):
        with pytest.raises(ValueError, match="multiple of 64"):
            lqp.proj_partial(torch.zeros(1, 64, k, device=cuda, dtype=b16),
                             torch.zeros(768, k, device=cuda, dtype=b16))
    with pytest.raises(ValueError, match="contiguous"):
        lqp.proj_partial(torch.zeros(1, 64, 384, device=cuda, dtype=b16),
                         torch.zeros(384, 768, device=cuda, dtype=b16).t())
    with pytest.raises(ValueError, match="both bf16"):
        lqp.proj_partial(torch.zeros(1, 64, 384, device=cuda),
                         torch.zeros(768, 384, device=cuda, dtype=b16))
    assert build.instantiation_counts() == {}


def test_gpu_tests_need_no_jax_at_import():
    """The card's machine has no JAX: this module imports none of it."""
    import os

    src = open(os.path.abspath(__file__)).read()
    assert "import " + "jax" not in src and "from uvltrack_tpu" + "." not in src
