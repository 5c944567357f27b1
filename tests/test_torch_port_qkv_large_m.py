"""`ln_qkv` at B*N rows: the wrapper's choice of body by the rows M
(ops/ln_qkv_attention.py::LARGE_M_ROWS; below it csrc/ln_qkv.cu's 64-row
entry uvl_ln_qkv, from it the large-M entry uvl_ln_qkv_large_m), recorded
from a stub of build.launch on meta tensors, which take the wrappers' card
branch with no card; the plain versions of the large-M entry's launches
(ln_rows_kernel's normalized rows, hi | lo halves for an fp32 x with an
int8 W, and the product on them) against ln_qkv_plain / ln_qkv_q8_plain;
and, on the card (`-m gpu`), every large-M instantiation against its plain
version, bitwise on a second call and beside the 64-row body. This module
imports no JAX, as the card's machine has none.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import quant

B16, F32 = torch.bfloat16, torch.float32


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launches(monkeypatch):
    """Each launch recorded as (kernel, instantiation, positional arguments,
    keywords), not run; every tensor the test's calls allocate as (shape,
    dtype) under "allocated"."""
    calls = []
    monkeypatch.setattr(lqa, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "launch",
                        lambda kernel, inst, *args, **kw: calls.append((kernel, inst, args, kw)))
    made = []
    real = torch.empty

    def empty(*a, **k):
        t = real(*a, **k)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    return {"calls": calls, "allocated": made}


def _args(b, n, c, f, x_dtype, int8):
    x = _meta((b, n, c), x_dtype)
    ln = [_meta((c,)), _meta((c,))]
    if int8:
        return (x, *ln, _meta((f, c), torch.int8), _meta((f,)), _meta((f,)))
    return (x, *ln, _meta((f, c), B16), _meta((f,)))


# (B, N, x dtype): B=1 on both streams (the tracking step), then the lockstep
# batches and B-TRAIN's 16 rows
ROUTES = [(b, n, dt) for b in (1, 2, 8, 16) for n, dt in ((321, B16), (361, F32))]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16w", "int8w"])
@pytest.mark.parametrize("b,n,x_dtype", ROUTES)
def test_ln_qkv_takes_its_body_by_the_rows(b, n, x_dtype, int8, launches):
    """Below LARGE_M_ROWS one launch of uvl_ln_qkv (body "64") into the
    (B, N, F) out it allocates; from it one launch of uvl_ln_qkv_large_m
    (body "lm"), the
    same instantiation tag, with the normalized rows' scratch ((M, C) bf16;
    (M, 2C) for an fp32 x with an int8 W) and, for an int8 W, its (F, C)
    bf16 conversion."""
    c, f = 768, 2304
    m = b * n
    args = _args(b, n, c, f, x_dtype, int8)
    launches["allocated"].clear()
    out = lqa.ln_qkv_q8(*args) if int8 else lqa.ln_qkv(*args)
    xt = "fp32x" if x_dtype == F32 else "bf16x"
    tag = f"{xt}-{'int8' if int8 else 'bf16'}w"
    assert [(k, i) for k, i, _, _ in launches["calls"]] == [("ln_qkv", tag)]
    _, _, (_, *pos), kw = launches["calls"][0]  # the argtypes, then the arguments
    assert kw.pop("stream_of") is args[0]
    out_dtype = x_dtype if int8 else B16
    assert out.shape == (b, n, f) and out.dtype == out_dtype
    large = m >= lqa.LARGE_M_ROWS
    assert large == (b > 1) and lqa.takes_large_m(m, torch.int8 if int8 else B16) == large
    if not large:
        assert kw == {"body": "64"} and len(pos) == 13
        assert pos[1] == int(x_dtype == F32) and pos[5] == int(int8)
        assert tuple(pos[9:]) == (m, c, f, 1e-6)
        assert launches["allocated"] == [((b, n, f), out_dtype)]
        return
    assert kw == {"entry": "uvl_ln_qkv_large_m", "body": "lm"}
    assert len(pos) == 15 and pos[1] == int(x_dtype == F32) and pos[5] == int(int8)
    assert tuple(pos[11:]) == (m, c, f, 1e-6)
    split = int8 and x_dtype == F32
    want = [((b, n, f), out_dtype), ((m, 2 * c if split else c), B16)]
    if int8:
        want.append(((f, c), B16))
    else:
        assert pos[9] is None  # no conversion scratch
    assert launches["allocated"] == want


@pytest.mark.parametrize("b,n,rows_from,entry", [(1, 361, 0, "uvl_ln_qkv_large_m"),
                                                 (8, 361, 1 << 62, None),
                                                 (2, 321, 643, None),
                                                 (2, 321, 642, "uvl_ln_qkv_large_m")])
def test_the_threshold_is_read_at_each_call(b, n, rows_from, entry, launches, monkeypatch):
    """LARGE_M_ROWS is read at each call: set to 0 or past every M it puts
    any rows on the large-M or the 64-row body (chip_smoke.py and
    tools/gemm_ab.py time both at one shape); M at it takes the large-M
    body, M one under it the 64-row body."""
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", rows_from)
    lqa.ln_qkv(*_args(b, n, 768, 2304, F32, False))
    assert launches["calls"][0][3].get("entry") == entry


def test_an_fp32_weight_never_takes_the_large_m_body(launches, monkeypatch):
    """fp32 compute (W as its hi/lo planes) runs ln_hilo_kernel at every M:
    its launch keeps uvl_ln_qkv (after the planes' split) at B-TRAIN's rows,
    whatever the threshold."""
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 0)
    assert not lqa.takes_large_m(16 * 361, F32)
    monkeypatch.setattr(lqa.hilo, "planes", lambda w: w)
    x = _meta((16, 361, 768))
    ln = [_meta((768,)), _meta((768,))]
    lqa.ln_qkv(x, *ln, _meta((2304, 768)), _meta((2304,)))
    assert [(k, i, kw.get("entry"), kw.get("body")) for k, i, _, kw in launches["calls"]] == [
        ("ln_qkv", "fp32x-fp32w", None, "")]


# ------------------------------------------------- the plain versions (CPU)
def _case(b, n, c, f, x_dtype, seed=0):
    rng = np.random.default_rng(seed + b + n + c)

    def arr(a, dt=F32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    w = arr(rng.normal(size=(f, c)) / np.sqrt(c), B16)
    return (arr(rng.normal(size=(b, n, c)), x_dtype), arr(1 + 0.1 * rng.normal(size=c)),
            arr(0.1 * rng.normal(size=c)), w, arr(0.02 * rng.normal(size=f)),
            quant.quantize_weight(w))


@pytest.mark.parametrize("b,n,c", [(1, 37, 64), (3, 50, 128), (2, 65, 256)])
def test_split_rows_hold_the_fp32_normalized_rows(b, n, c):
    """ln_rows_plain(split=True): hi = bf16(y) and lo = bf16(y - hi) of the
    fp32 normalized rows, so hi + lo is y within 2^-17 |y| (split_bf16's
    bound) -- in place of the one bf16 rounding of the unsplit rows, which
    equal hi."""
    x, g, be, *_ = _case(b, n, c, 3 * c, F32)
    y = lqa.layer_norm_fast_var(x, g, be, 1e-6).reshape(-1, c)
    rows = lqa.ln_rows_plain(x, g, be, split=True)
    assert rows.shape == (b * n, 2 * c) and rows.dtype == B16
    hi, lo = rows[:, :c].float(), rows[:, c:].float()
    torch.testing.assert_close(rows[:, :c], y.to(B16), rtol=0, atol=0)
    assert bool(((hi + lo - y).abs() <= 2.0 ** -17 * y.abs()).all())
    torch.testing.assert_close(lqa.ln_rows_plain(x, g, be), rows[:, :c], rtol=0, atol=0)


@pytest.mark.parametrize("b,n,c", [(1, 37, 64), (3, 50, 128), (2, 65, 256)])
def test_large_m_plain_on_split_rows_matches_ln_qkv_q8_plain_in_fp32(b, n, c):
    """An fp32 x with an int8 W: the large-M entry's plain launches (split
    rows, the payload converted to bf16, hi.W + lo.W, the scale, the bias)
    agree with ln_qkv_q8_plain, which keeps the normalized rows in fp32,
    within fp32 noise: the split loses at most 2^-17 of each row value."""
    f = 3 * c
    x, g, be, _, wb, wq = _case(b, n, c, f, F32)
    got = lqa.ln_qkv_large_m_plain(lqa.ln_rows_plain(x, g, be, split=True), wq.q.to(B16),
                                   wq.scale, wb, F32)
    want = lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb).reshape(b * n, f)
    assert got.dtype == want.dtype == F32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("x_dtype", [B16, F32])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16w", "int8w"])
def test_large_m_plain_on_bf16_rows_equals_the_plain_prefix(x_dtype, int8):
    """bf16 rows (a bf16 W at either x; an int8 W at a bf16 x): the large-M
    entry's plain launches equal ln_qkv_plain / ln_qkv_q8_plain bit for
    bit, the same rounding points in the same order."""
    if int8 and x_dtype == F32:
        pytest.skip("an fp32 x with an int8 W splits its rows (the test above)")
    b, n, c = 2, 65, 128
    x, g, be, w, wb, wq = _case(b, n, c, 3 * c, x_dtype)
    rows = lqa.ln_rows_plain(x, g, be)
    if int8:
        got = lqa.ln_qkv_large_m_plain(rows, wq.q.to(B16), wq.scale, wb, x_dtype)
        want = lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb)
    else:
        got = lqa.ln_qkv_large_m_plain(rows, w, None, wb, B16)
        want = lqa.ln_qkv_plain(x, g, be, w, wb)
    torch.testing.assert_close(got, want.reshape(b * n, -1), rtol=0, atol=0)


# ----------------------------------------------------------- on the card
# the KERNEL_* rule of chip_smoke.py for a bf16 out (ln_qkv's), its fp32 rule
# for the fp32 out of an fp32 x with an int8 W
BF16_ATOL, BF16_RTOL, F32_ATOL, F32_RTOL = 2e-2, 2e-2, 2e-4, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16w", "int8w"])
@pytest.mark.parametrize("x_dtype", [B16, F32])
@pytest.mark.parametrize("b,n,c,f", [(8, 361, 768, 2304), (8, 321, 1024, 3072),
                                     (16, 361, 768, 576), (3, 65, 768, 1152),
                                     (2, 321, 1024, 1536)])
def test_cuda_large_m_instantiations_match_plain(cuda, b, n, c, f, x_dtype, int8, monkeypatch):
    """Every large-M instantiation (`ln_qkv[*-lm]`) against its plain
    version at B's and L's widths and a rank's 3C/tp rows, M ending inside
    a 128-row tile (195 rows, put on the body by LARGE_M_ROWS), launched on the body
    (build.body_counts), bitwise on a second call, and beside the 64-row
    body (bitwise expected: K unsplit and in order, the same rounding
    points)."""
    x, g, be, w, wb, wq = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                           for t in _case(b, n, c, f, x_dtype))
    wq = quant.QuantizedTensor(wq.q.to(cuda), wq.scale.to(cuda))
    if int8:
        def kern():
            return lqa.ln_qkv_q8(x, g, be, wq.q, wq.scale, wb)
        want = lqa.ln_qkv_q8_plain(x, g, be, wq.q, wq.scale, wb)
    else:
        def kern():
            return lqa.ln_qkv(x, g, be, w, wb)
        want = lqa.ln_qkv_plain(x, g, be, w, wb)
    inst = f"ln_qkv[{'fp32' if x_dtype == F32 else 'bf16'}x-{'int8' if int8 else 'bf16'}w-lm]"
    before = build.body_counts().get(inst, 0)
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 0)
    got, again = kern(), kern()
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 1 << 62)
    small = kern()
    torch.cuda.synchronize()
    assert build.body_counts().get(inst, 0) == before + 2
    assert got.dtype == want.dtype and got.shape == want.shape
    fp32_out = int8 and x_dtype == F32
    atol, rtol = (F32_ATOL, F32_RTOL) if fp32_out else (BF16_ATOL, BF16_RTOL)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert torch.equal(got, again)
    assert torch.equal(got, small)


@pytest.mark.gpu
def test_cuda_large_m_entry_refuses_what_it_cannot_take(cuda):
    """C not a multiple of 64 (the k-tile) raises before any launch."""
    x = torch.zeros((4, 361, 96), device=cuda)
    ln = [torch.ones(96, device=cuda), torch.zeros(96, device=cuda)]
    w = torch.zeros((288, 96), dtype=B16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        lqa.ln_qkv(x, *ln, w, torch.zeros(288, device=cuda))


def test_gpu_tests_need_no_jax_at_import():
    """The card's machine has no JAX: this module imports none of it."""
    import os

    src = open(os.path.abspath(__file__)).read()
    assert "import " + "jax" not in src and "from uvltrack_tpu" + "." not in src
