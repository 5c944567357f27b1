"""`qkv_attention` at B·N rows: the wrapper's choice of body
(ops/ln_qkv_attention.py::takes_attn_batch: from ATTN_BATCH_PAIRS (b, h)
pairs where the split rule splits the keys, csrc/qkv_attention.cu's batch
entry uvl_qkv_attention_batch, else the split entry uvl_qkv_attention),
recorded from a stub of build.launch on meta
tensors, which take the wrapper's card branch with no card; the key ranges
in which both bodies sum a row's keys (attn_split, a mirror of
csrc/attention.cuh's choose_split) at every shape of the lockstep and
training paths; `build.body_delta` over a stubbed launch; the plain version
against the JAX package's `fused_attention_qkv` in the Pallas interpreter at
B=4 with a key bias a row; and, on the card (`-m gpu`), the batch body
bitwise the split body and a second call, and close to the plain version.

The CPU test against JAX imports it inside the test (`_jax()`): the card's
machine has none, and runs this module with `-m gpu --noconftest`.
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa

B16, F32 = torch.bfloat16, torch.float32
REPO = pathlib.Path(__file__).resolve().parent.parent


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launches(monkeypatch):
    """Each launch recorded as (kernel, instantiation, positional arguments,
    keywords), not run."""
    calls = []
    monkeypatch.setattr(lqa, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "launch",
                        lambda kernel, inst, *args, **kw: calls.append((kernel, inst, args, kw)))
    return calls


def _attend(b, n, heads, dtype=B16):
    return lqa.qkv_attention(_meta((b, n, 3 * heads * 64), dtype), _meta((b, n)), heads)


# (label, B, H, batch body in bf16?, in fp32?): the tracking step (B=1, B's
# 12 and L's 16 heads) and B=2-3, below the pairs' threshold or kept whole
# by the split rule; then the lockstep steps S4 and S8 of B and L, B-TRAIN's
# 16 rows and a tensor-parallel rank's H/tp heads at those rows: the batch
# body wherever the rule splits the keys (L-S8 and B-TRAIN in bf16 are kept
# whole: the same grid on either entry)
ROUTES = [("B_S1", 1, 12, False, False), ("L_S1", 1, 16, False, False),
          ("B_S2", 2, 12, False, False), ("B_S3", 3, 12, False, False),
          ("L_S2", 2, 16, False, False), ("B_S4", 4, 12, True, True),
          ("L_S3", 3, 16, True, True), ("B_S8", 8, 12, True, True),
          ("L_S8", 8, 16, False, False), ("B_TRAIN", 16, 12, False, True),
          ("B_tp2", 16, 6, True, True), ("B_tp4", 16, 3, True, True)]


@pytest.mark.parametrize("dtype", [B16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n", [321, 361])
@pytest.mark.parametrize("label,b,heads,batch16,batch32", ROUTES, ids=[r[0] for r in ROUTES])
def test_qkv_attention_takes_its_body_by_the_pairs(label, b, heads, batch16, batch32, n, dtype,
                                                   launches):
    """One launch a call, under the type's instantiation tag: the batch
    entry (body "lm") from ATTN_BATCH_PAIRS (b, h) pairs where the split
    rule splits the keys, else the split entry (body "64"), with the same
    arguments; (B, N, H*64) out in qkv's type."""
    out = _attend(b, n, heads, dtype)
    assert out.shape == (b, n, heads * 64) and out.dtype == dtype
    tag = "fp32" if dtype == F32 else "bf16"
    assert [(k, i) for k, i, _, _ in launches] == [("qkv_attention", tag)]
    _, _, (_, *pos), kw = launches[0]  # the argtypes, then the arguments
    assert kw.pop("stream_of").shape == (b, n, 3 * heads * 64)
    batch = batch32 if dtype == F32 else batch16
    assert lqa.takes_attn_batch(b, n, heads, dtype == F32) == batch
    assert batch == (b * heads >= lqa.ATTN_BATCH_PAIRS
                     and lqa.attn_split(b, n, heads, dtype == F32) > 1)
    assert kw == ({"entry": "uvl_qkv_attention_batch", "body": "lm"} if batch else
                  {"entry": "", "body": "64"})
    assert pos[1] == int(dtype == F32) and tuple(pos[4:]) == (b, n, heads, 64, 64 ** -0.5)


@pytest.mark.parametrize("b,heads,pairs,batch", [(1, 12, 0, True), (16, 12, 0, True),
                                                 (8, 12, 1 << 62, False), (4, 12, 48, True),
                                                 (4, 12, 49, False)])
def test_the_pairs_threshold_is_read_at_each_call(b, heads, pairs, batch, launches,
                                                  monkeypatch):
    """ATTN_BATCH_PAIRS is read at each call: 0 puts every shape on the batch
    body (B=1, and B-TRAIN, which the rule keeps whole), past every B*H keeps
    B-S8 on the split entry (chip_smoke.py and tools/gemm_ab.py --attn time
    both at one shape); B*H at it takes the batch body, one under it the
    split entry."""
    monkeypatch.setattr(lqa, "ATTN_BATCH_PAIRS", pairs)
    _attend(b, 361, heads)
    assert launches[0][3]["body"] == ("lm" if batch else "64")


def test_a_cpu_tensor_takes_the_plain_version(launches):
    """A CPU tensor never reaches a launch, at any pairs."""
    qkv = torch.randn((16, 65, 3 * 2 * 64))
    kb = torch.zeros((16, 65))
    torch.testing.assert_close(lqa.qkv_attention(qkv, kb, 2),
                               lqa.qkv_attention_plain(qkv, kb, 2), rtol=0, atol=0)
    assert launches == []


# ------------------------------------------------------ the key ranges
# (B, N, H, fp32, split): choose_split at every shape of the lockstep and
# training paths, both N -- B-S4 (288 blocks), B-S8 (576), a dp=2 rank's 8
# rows, B tp2 (576) and B tp4 (288) split the keys in 3; B=2, B=3,
# B-TRAIN's 16 x 12 heads and L-S8 (768) keep them whole; the fp32 joint
# blocks of B-S4-Q8 split in 3 -- and at B=1, the tracking step (3 at
# N=321/361, 2 at 681, 1 at BERT's 40 and at 128)
SPLITS = ([(b, n, h, False, s) for n in (321, 361) for b, h, s in
           ((4, 12, 3), (8, 12, 3), (16, 6, 3), (16, 3, 3), (2, 12, 1), (3, 12, 1),
            (16, 12, 1), (8, 16, 1), (1, 12, 3))]
          + [(4, 361, 12, True, 3), (1, 681, 12, False, 2), (1, 681, 12, True, 2),
             (1, 40, 12, False, 1), (1, 128, 12, False, 1), (1, 128, 12, True, 1)])


def _key_ranges(b, n, heads, fp32):
    """The contiguous ranges of 64-key tiles, [(first, end), ...], in which
    both attention bodies sum each row's keys (the split launch a cluster
    rank a range, the batch body one range after another in one block), each
    range from zero, the ranges then added in this order."""
    tiles, split = -(-n // 64), lqa.attn_split(b, n, heads, fp32)
    return [(r * tiles // split, (r + 1) * tiles // split) for r in range(split)]


@pytest.mark.parametrize("b,n,heads,fp32,split", SPLITS)
def test_key_ranges_mirror_choose_split(b, n, heads, fp32, split):
    """attn_split, the wrapper's mirror of choose_split, at each shape; its
    `split` contiguous ranges cover the N/64 key tiles in order, none
    empty."""
    tiles = -(-n // 64)
    assert lqa.attn_split(b, n, heads, fp32) == split
    ranges = _key_ranges(b, n, heads, fp32)
    assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a < e for a, e in ranges)
    assert all(e == ranges[i + 1][0] for i, (_, e) in enumerate(ranges[:-1]))


def test_the_mirror_reads_the_kernel_rules_constants():
    """The mirror's constants are choose_split's in csrc/attention.cuh: two
    blocks on each of 132 SMs a wave, a split's cost of 3 bf16 or 2 fp32
    tiles, at most 3 blocks a cluster, and the batch body's key ranges from
    the same rule."""
    src = (REPO / "uvltrack_tpu_torch" / "csrc" / "attention.cuh").read_text()
    assert "constexpr int slots = 2 * 132;" in src
    assert "constexpr int split_cost = sizeof(T) == 2 ? 3 : 2;" in src
    assert re.search(r"constexpr int MAX_SPLIT = 3;", src)
    # the split launch's split and the batch body's ranges
    assert src.count("choose_split<T>(tiles * H * B, tiles)") == 2


# ------------------------------------------------------- body_delta
@pytest.fixture
def stub_launch(monkeypatch):
    """build.launch itself, with both entry points replaced by a function
    that returns 0 and the stream calls by stand-ins: it counts as on the
    card."""
    monkeypatch.setattr(lqa, "check_cuda", lambda name, *t: None)
    for entry in ("uvl_qkv_attention", "uvl_qkv_attention_batch"):
        monkeypatch.setitem(build._FNS, entry, lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    saved = dict(build.BODIES), dict(build.LAUNCHES)
    yield
    build.BODIES.clear()
    build.BODIES.update(saved[0])
    build.LAUNCHES.clear()
    build.LAUNCHES.update(saved[1])


def test_body_delta_counts_the_blocks_launches_by_body(stub_launch):
    """The dict body_delta yields holds, once the block ends, each body's
    launches in the block: B-S8 twice on the batch body, B=1 once on the
    split entry, fp32 B-S4 once on its batch body; launches before and after
    the block are not in it, and they stay in the counts."""
    _attend(1, 361, 12)
    before = build.body_counts()
    with build.body_delta() as moved:
        _attend(8, 361, 12)
        _attend(8, 361, 12)
        _attend(1, 321, 12)
        _attend(4, 361, 12, F32)
        assert moved == {}  # filled when the block ends
    _attend(8, 321, 12)
    assert moved == {"qkv_attention[bf16-lm]": 2, "qkv_attention[bf16-64]": 1,
                     "qkv_attention[fp32-lm]": 1}
    after = build.body_counts()
    assert after["qkv_attention[bf16-lm]"] == before.get("qkv_attention[bf16-lm]", 0) + 3
    assert after["qkv_attention[bf16-64]"] == before["qkv_attention[bf16-64]"] + 1


def test_body_delta_set_aside_takes_the_blocks_launches_back(stub_launch):
    """set_aside=True: the block's launches are counted in its dict and
    then taken back out of the body counts, also when the block raises; the
    launches per instantiation (LAUNCHES) keep them."""
    _attend(8, 361, 12)
    before = build.body_counts()
    n_before = build.instantiation_counts()["qkv_attention[bf16]"]
    with pytest.raises(RuntimeError, match="inside"):
        with build.body_delta(set_aside=True) as moved:
            _attend(8, 321, 12)
            _attend(1, 321, 12)
            raise RuntimeError("inside")
    assert moved == {"qkv_attention[bf16-lm]": 1, "qkv_attention[bf16-64]": 1}
    assert build.body_counts() == before
    assert build.instantiation_counts()["qkv_attention[bf16]"] == n_before + 2


# ------------------------------------- the plain version against JAX (CPU)
# fp32, the JAX package's own kernel tolerance (tests/test_pallas_attention.py)
ATOL, RTOL = 5e-5, 5e-4


def _jax():
    """The oracle: the JAX package's Pallas kernels, with jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import pallas_attention as pa
    return jnp, pa


def _row_biases(b, n, rng):
    """(B, N) fp32 key bias, a kind a row: a flag-0 text mask (the last
    keys), an open row, an all-masked row (it averages v), random padding."""
    masked = np.zeros((b, n), bool)
    for r in range(b):
        kind = r % 4
        if kind == 0:
            masked[r, -min(40, n // 3):] = True
        elif kind == 2:
            masked[r] = True
        elif kind == 3:
            masked[r] = rng.random(n) < 0.3
            masked[r, 0] = False
    return np.where(masked, -1e10, 0.0).astype(np.float32)


@pytest.mark.parametrize("n", [48, 65, 130])
def test_qkv_attention_plain_matches_pallas_qkv_kernel_at_batch_4(n):
    """kernel #2's plain version == _attn_kernel_qkv (fused_attention_qkv,
    grid=(b,)) in the Pallas interpreter at B=4, each row its own key bias:
    the batch elements' keys and biases stay apart."""
    jnp, pa = _jax()
    rng = np.random.default_rng(n)
    b, h, d = 4, 2, 64
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    kb = _row_biases(b, n, rng)
    ref = np.asarray(pa.fused_attention_qkv(jnp.asarray(qkv), jnp.asarray(kb), heads=h,
                                            interpret=True))
    out = lqa.qkv_attention_plain(torch.from_numpy(qkv), torch.from_numpy(kb), heads=h)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    # the all-masked row averages v over every key
    v = qkv[2, :, 2 * h * d:]
    np.testing.assert_allclose(out.numpy()[2], np.broadcast_to(v.mean(0), (n, h * d)),
                               atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------- on the card
# chip_smoke.py's rules: bf16 KERNEL_ATOL['qkv_attention'] + KERNEL_RTOL,
# fp32 F32_ATOL + F32_RTOL (sums in another order than the plain version's)
BF16_ATOL, BF16_RTOL, F32_TOL = 6e-3, 2e-2, 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [B16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n", [63, 65, 321, 361])
@pytest.mark.parametrize("heads", [6, 12, 16])
@pytest.mark.parametrize("b", [2, 4, 8, 16])
def test_cuda_batch_body_is_the_split_body(cuda, b, heads, n, dtype, monkeypatch):
    """The batch body (forced at any shape) against the split entry forced on
    the same inputs, bitwise (the same key ranges, one to three, in the same
    order), and against a second call, bitwise; within the rule of the plain
    version. N=63 and 65: one key and one query row short of and past a
    tile; a key bias a row (text mask, open, all-masked, random)."""
    rng = np.random.default_rng(b * 1000 + heads * 10 + n)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * heads * 64)).astype(np.float32))
    qkv = qkv.to(cuda, dtype)
    kb = torch.from_numpy(_row_biases(b, n, rng)).to(cuda)
    tag = "fp32" if dtype == F32 else "bf16"
    monkeypatch.setattr(lqa, "ATTN_BATCH_PAIRS", 0)
    with build.body_delta() as moved:
        got, again = lqa.qkv_attention(qkv, kb, heads), lqa.qkv_attention(qkv, kb, heads)
        monkeypatch.setattr(lqa, "ATTN_BATCH_PAIRS", 1 << 62)
        split = lqa.qkv_attention(qkv, kb, heads)
    torch.cuda.synchronize()
    assert moved == {f"qkv_attention[{tag}-lm]": 2, f"qkv_attention[{tag}-64]": 1}
    assert torch.equal(got, split)
    assert torch.equal(got, again)
    want = lqa.qkv_attention_plain(qkv, kb, heads)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == F32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=BF16_RTOL)


def test_gpu_tests_need_no_jax_at_import():
    """The card's machine has no JAX: this module imports none of it at its
    top (the CPU test against JAX imports it inside `_jax`)."""
    src = pathlib.Path(__file__).read_text()
    head = src.split("\ndef ")[0]
    assert "import " + "jax" not in head and "from uvltrack_tpu" + "." not in head
