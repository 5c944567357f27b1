"""Kernel #7 (`ln_mlp`, bf16 weights) and `proj_residual` (#4's and #6's
epilogue, bf16 and int8 weights) at B*N rows: the wrappers' choice of body
by the rows M (ops/ln_qkv_attention.py::LARGE_M_ROWS for #7,
ops/ln_qkv_attn_proj.py::LARGE_M_ROWS for `proj_residual`; below them the
64-row entries uvl_ln_mlp / uvl_proj_residual, from them the large-M entries
uvl_ln_mlp_large_m / uvl_proj_residual_large_m), recorded from a stub of
build.launch on meta tensors, which take the wrappers' card branch with no
card; the plain versions of the large-M entries' launches against the port's
plain versions and the JAX package's functions (`_xla_ln_mlp`, the Pallas
kernels #4, #6 and #7 in interpret mode, `_xla_ln_qkv_attn_proj`) on the
same seeded numpy inputs; the port's BatchTracker at S=3 under both fused
knobs against the JAX BatchTracker under them; and, on the card (`-m gpu`),
every new instantiation against its plain version, bitwise on a second
call.

Tolerances: fp32 compute at 5e-5 abs / 5e-4 rel (tests/test_torch_port_quant.py's
rule), bf16 compute at two bf16 steps of the output's largest value; the
trackers at tests/test_torch_port_batch.py's bounds (boxes 1e-3 px, scores
and prompts 1e-4). The card's machine has no JAX: JAX is imported inside
the CPU tests only, and the `gpu` tests run there with
`python -m pytest tests/test_torch_port_mlp_proj_large_m.py -m gpu --noconftest`.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
from uvltrack_tpu_torch.ops import quant

B16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
ATOL, RTOL = 5e-5, 5e-4


def _jax():
    """The oracle: the JAX package's Pallas kernels, XLA twins and int8
    quantization (imported here: the card's machine has no JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    from uvltrack_tpu.ops import pallas_attention as pa
    from uvltrack_tpu.ops import quant as jquant
    return jnp, pa, jquant


def _close(out, ref, compute: str):
    """fp32: ATOL/RTOL; bf16: two bf16 steps at the output's largest value."""
    out = np.asarray(out.detach().float() if torch.is_tensor(out) else out, np.float32)
    ref = np.asarray(ref, np.float32)
    atol, rtol = ATOL, RTOL
    if compute == "bf16":
        atol, rtol = 2 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7), 0.0
    np.testing.assert_allclose(out, ref, atol=atol, rtol=rtol)


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launches(monkeypatch):
    """Each launch recorded as (kernel, instantiation, positional arguments,
    keywords), not run; every tensor torch.empty makes as (shape, dtype)
    under "allocated"."""
    calls = []
    for mod in (lm, lqp):
        monkeypatch.setattr(mod, "check_cuda", lambda name, *t: None)
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


def _one(launches):
    """The one launch: (kernel, instantiation, arguments after the argtypes,
    keywords without stream_of)."""
    assert len(launches["calls"]) == 1
    kernel, inst, (_, *pos), kw = launches["calls"][0]
    kw = dict(kw)
    kw.pop("stream_of")
    return kernel, inst, pos, kw


def _mlp_args(b, n, c, f, x_dtype, w_dtype=B16):
    return (_meta((b, n, c), x_dtype), _meta((c,)), _meta((c,)), _meta((f, c), w_dtype),
            _meta((f,)), _meta((c, f), w_dtype), _meta((c,)))


# (B, N, x dtype): B=1 on both streams (the tracking step), then the lockstep
# batches (B=2 and 3 on either side of proj_residual's threshold) and
# B-TRAIN's 16 rows
ROUTES = [(b, n, dt) for b in (1, 2, 3, 8, 16) for n, dt in ((321, B16), (361, F32))]


# ------------------------------------------------------------ the routing
@pytest.mark.parametrize("b,n,x_dtype", ROUTES)
def test_ln_mlp_takes_its_body_by_the_rows(b, n, x_dtype, launches):
    """bf16 weights: below LARGE_M_ROWS one launch of uvl_ln_mlp (body
    "64") into the hidden tensor and out it allocates; from it one launch of
    uvl_ln_mlp_large_m (body "lm") under the same tag, the kernel's bf16 out
    kind (0), and the normalized rows' (M, C) bf16 scratch."""
    c, f = 768, 3072
    m = b * n
    args = _mlp_args(b, n, c, f, x_dtype)
    launches["allocated"].clear()
    out = lm.ln_mlp(*args)
    kernel, inst, pos, kw = _one(launches)
    assert (kernel, inst) == ("ln_mlp", f"{'fp32' if x_dtype == F32 else 'bf16'}x-bf16w")
    assert out.shape == (b, n, c) and out.dtype == B16
    large = m >= lqa.LARGE_M_ROWS
    assert large == (b > 1) and lqa.takes_large_m(m, B16) == large
    want = [((m, f), B16), ((b, n, c), B16)]
    if not large:
        assert kw == {"body": "64"} and len(pos) == 16
        assert pos[1] == int(x_dtype == F32) and pos[8] == 0  # not fp32 weights
        assert tuple(pos[11:]) == (m, c, f, 1e-6, 3)
        assert launches["allocated"] == want
        return
    assert kw == {"entry": "uvl_ln_mlp_large_m", "body": "lm"} and len(pos) == 17
    assert pos[1] == int(x_dtype == F32) and pos[7] is not None  # b2
    assert tuple(pos[11:]) == (0, m, c, f, 1e-6, 3)
    assert launches["allocated"] == want + [((m, c), B16)]


@pytest.mark.parametrize("wt", ["bf16w", "int8w"])
@pytest.mark.parametrize("b,n,x_dtype", ROUTES)
def test_proj_residual_takes_its_body_by_the_rows(b, n, x_dtype, wt, launches):
    """#4 (bf16 A and W) and #6 (A in x's dtype, int8 W): below its own
    threshold, ln_qkv_attn_proj.LARGE_M_ROWS (896: B=1 and B=2 take the
    64-row body, #7 from B=2 the large-M one), one launch of
    uvl_proj_residual (body "64"), allocating
    nothing but its out; from it one launch of uvl_proj_residual_large_m
    (body "lm") under the same tag, with the int8 W's (C, K) bf16 conversion
    scratch and an fp32 A's (M, 2K) hi | lo scratch."""
    c = k = 768
    m = b * n
    int8 = wt == "int8w"
    a_dtype = x_dtype if int8 else B16
    w = _meta((c, k), I8 if int8 else B16)
    args = (_meta((b, n, c), x_dtype), _meta((b, n, k), a_dtype), w, _meta((c,)),
            _meta((c,)) if int8 else None)
    launches["allocated"].clear()
    out = lqp.proj_residual(*args)
    kernel, inst, pos, kw = _one(launches)
    xt, at = ("fp32" if t == F32 else "bf16" for t in (x_dtype, a_dtype))
    assert (kernel, inst) == ("proj_residual", f"{xt}x-{at}a-{wt[:4]}w")
    assert out.shape == (b, n, c) and out.dtype == x_dtype
    large = m >= lqp.LARGE_M_ROWS
    assert large == (b > 2) and lqa.takes_large_m(m, w.dtype, lqp.LARGE_M_ROWS) == large
    if not large:
        assert kw == {"body": "64"} and len(pos) == 12 and tuple(pos[9:]) == (m, k, c)
        assert launches["allocated"] == []
        return
    assert kw == {"entry": "uvl_proj_residual_large_m", "body": "lm"} and len(pos) == 14
    assert pos[1] == int(x_dtype == F32) and pos[3] == int(a_dtype == F32)
    assert pos[5] == int(int8) and tuple(pos[11:]) == (m, k, c)
    split = a_dtype == F32
    assert (pos[8] is None) != split and (pos[9] is None) != int8
    want = ([((m, 2 * k), B16)] if split else []) + ([((c, k), B16)] if int8 else [])
    assert launches["allocated"] == want


@pytest.mark.parametrize("b,n,rows_from,entry", [(1, 361, 0, "large_m"),
                                                 (8, 361, 1 << 62, None),
                                                 (2, 321, 643, None),
                                                 (2, 321, 642, "large_m")])
def test_the_threshold_and_tile_width_are_read_at_each_call(b, n, rows_from, entry, launches,
                                                            monkeypatch):
    """Each wrapper reads its LARGE_M_ROWS at each call (0 or past every M
    puts any rows on either body; M at it takes the large-M body, one row
    under it the 64-row body). No tile width is passed: the large-M entries
    take the body's own (csrc/gemm_sm90.cuh pick_bn), so their last
    arguments are the shapes."""
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", rows_from)
    monkeypatch.setattr(lqp, "LARGE_M_ROWS", rows_from)
    m = b * n
    lm.ln_mlp(*_mlp_args(b, n, 768, 3072, F32))
    x = _meta((b, n, 768))
    lqp.proj_residual(x, _meta((b, n, 768), B16), _meta((768, 768), B16), _meta((768,)))
    got = [(kw.get("entry"), tuple(args[-3:])) for _, _, args, kw in launches["calls"]]
    if entry:
        assert got == [("uvl_ln_mlp_large_m", (3072, 1e-6, 3)),
                       ("uvl_proj_residual_large_m", (m, 768, 768))]
    else:
        assert [e for e, _ in got] == [None, None]


def test_an_fp32_weight_never_takes_the_large_m_body(launches, monkeypatch):
    """fp32 compute (weights as their hi/lo planes) keeps the split bodies
    at every M, whatever the threshold: uvl_ln_mlp and uvl_proj_residual,
    counted under no body."""
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 0)
    monkeypatch.setattr(lqp, "LARGE_M_ROWS", 0)
    monkeypatch.setattr(lm.hilo, "planes", lambda w: w)
    monkeypatch.setattr(lqp.hilo, "planes", lambda w: w)
    assert not lqa.takes_large_m(16 * 361, F32)
    lm.ln_mlp(*_mlp_args(16, 361, 768, 3072, F32, F32))
    x = _meta((16, 361, 768))
    lqp.proj_residual(x, _meta((16, 361, 768)), _meta((768, 768)), _meta((768,)))
    assert [(k, i, kw.get("entry"), kw.get("body")) for k, i, _, kw in launches["calls"]] == [
        ("ln_mlp", "fp32x-fp32w", None, ""), ("proj_residual", "fp32x-fp32a-fp32w", None, "")]


def test_a_share_takes_the_large_m_entry_at_any_rows(launches):
    """A tensor-parallel rank's MLP share runs the same large-M entry with
    the fp32 out kind (1) at B=1 too, counted under no body."""
    args = _mlp_args(1, 321, 768, 1536, B16)
    lm.ln_mlp_partial(*args[:6])
    kernel, inst, pos, kw = _one(launches)
    assert (kernel, inst) == ("ln_mlp", "bf16x-bf16w-fp32o")
    assert kw == {"entry": "uvl_ln_mlp_large_m", "body": ""} and pos[7] is None
    assert tuple(pos[11:]) == (1, 321, 768, 1536, 1e-6, 3)


# ------------------------------------------------- the plain versions (CPU)
def _case(b, n, c, x_dtype, seed=0):
    """x, LN scale/bias, W1 (F, C), b1, W2 (C, F), b2, W_qkv (3C, C), b_qkv,
    Wp (C, C), b_proj as float32 numpy (Linear layout), F = 4C; a key mask."""
    rng = np.random.default_rng(seed + b + n + c)
    f = 4 * c
    arrs = dict(
        x=rng.normal(size=(b, n, c)), g=1 + 0.1 * rng.normal(size=c), be=0.1 * rng.normal(size=c),
        w1=rng.normal(size=(f, c)) / np.sqrt(c), b1=0.02 * rng.normal(size=f),
        w2=rng.normal(size=(c, f)) / np.sqrt(f), b2=0.02 * rng.normal(size=c),
        wq=rng.normal(size=(3 * c, c)) / np.sqrt(c), bq=0.02 * rng.normal(size=3 * c),
        wp=rng.normal(size=(c, c)) / np.sqrt(c), bp=0.02 * rng.normal(size=c))
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    masked = rng.random((b, n)) < 0.3
    masked[:, 0] = False
    arrs["kb"] = np.where(masked, -1e10, 0.0).astype(np.float32)
    # what the model feeds the kernels: bf16 weights
    for k in ("w1", "w2", "wq", "wp"):
        arrs[k] = np.asarray(torch.from_numpy(arrs[k]).to(B16).float())
    arrs["x"] = np.asarray(torch.from_numpy(arrs["x"]).to(x_dtype).float())
    return arrs


def _t(a, dtype=F32):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


B_N_C = (3, 50, 128)  # M = 150 rows: two 128-row tiles, the second ragged
HEADS = 2


@pytest.mark.parametrize("x_dtype", [B16, F32])
def test_mlp_large_m_plain_equals_the_plain_kernel(x_dtype):
    """The large-M entry's launches in plain form (ln_rows_plain's bf16
    rows, fc1 + GELU into the bf16 hidden tensor, fc2 + b2) equal
    ln_fc1_gelu_plain / ln_mlp_plain bit for bit: the same rounding points
    in the same order."""
    b, n, c = B_N_C
    a = _case(b, n, c, x_dtype)
    x, g, be = _t(a["x"], x_dtype), _t(a["g"]), _t(a["be"])
    w1, b1, w2, b2 = _t(a["w1"], B16), _t(a["b1"]), _t(a["w2"], B16), _t(a["b2"])
    h, out = lm.ln_mlp_large_m_plain(lqa.ln_rows_plain(x, g, be), w1, b1, w2, b2)
    torch.testing.assert_close(h, lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(B16).reshape(
        b * n, -1), rtol=0, atol=0)
    torch.testing.assert_close(out, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2).reshape(b * n, c),
                               rtol=0, atol=0)


@pytest.mark.parametrize("x_dtype", [B16, F32])
def test_mlp_large_m_plain_matches_jax(x_dtype):
    """The same chain against the JAX package's `_xla_ln_mlp` and kernel #7
    (`fused_ln_mlp`) in the Pallas interpreter: bf16 compute, two bf16
    steps."""
    jnp, pa, _ = _jax()
    b, n, c = B_N_C
    a = _case(b, n, c, x_dtype, seed=1)
    x = _t(a["x"], x_dtype)
    _, out = lm.ln_mlp_large_m_plain(lqa.ln_rows_plain(x, _t(a["g"]), _t(a["be"])),
                                     _t(a["w1"], B16), _t(a["b1"]), _t(a["w2"], B16), _t(a["b2"]))
    jx = jnp.asarray(a["x"]).astype(jnp.bfloat16 if x_dtype == B16 else jnp.float32)
    jargs = (jx, jnp.asarray(a["g"]), jnp.asarray(a["be"]),
             jnp.asarray(a["w1"].T).astype(jnp.bfloat16), jnp.asarray(a["b1"]),
             jnp.asarray(a["w2"].T).astype(jnp.bfloat16), jnp.asarray(a["b2"]))
    for ref in (pa._xla_ln_mlp(*jargs), pa.fused_ln_mlp(*jargs, interpret=True)):
        _close(out, np.asarray(ref.astype(jnp.float32)).reshape(b * n, c), "bf16")


@pytest.mark.parametrize("b,n,c", [(1, 37, 64), (3, 50, 128)])
def test_split_rows_hold_the_fp32_rows(b, n, c):
    """split_rows_plain: hi = bf16(a), lo = bf16(a - hi), so hi + lo is a
    within 2^-17 |a| (split_bf16's bound); the large-M residual product on
    them agrees with proj_residual_plain on the fp32 A within fp32 noise."""
    rng = np.random.default_rng(b + n + c)
    attn = _t(0.3 * rng.normal(size=(b, n, c)))
    rows = lqp.split_rows_plain(attn)
    assert rows.shape == (b * n, 2 * c) and rows.dtype == B16
    hi, lo, a = rows[:, :c].float(), rows[:, c:].float(), attn.reshape(-1, c)
    torch.testing.assert_close(rows[:, :c], a.to(B16), rtol=0, atol=0)
    assert bool(((hi + lo - a).abs() <= 2.0 ** -17 * a.abs()).all())
    x = _t(rng.normal(size=(b, n, c)))
    wq = quant.quantize_weight(_t(rng.normal(size=(c, c)) / np.sqrt(c)))
    bp = _t(0.02 * rng.normal(size=c))
    got = lqp.proj_residual_large_m_plain(x, rows, wq.q.to(B16), wq.scale, bp)
    want = lqp.proj_residual_plain(x, attn, quant.QuantizedTensor(wq.q, wq.scale, F32), bp)
    torch.testing.assert_close(got, want.reshape(b * n, c), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("inst", ["bf16x-bf16a-bf16w", "fp32x-bf16a-bf16w", "bf16x-bf16a-int8w",
                                  "fp32x-fp32a-int8w"])
def test_proj_large_m_plain_matches_jax(inst):
    """The residual kind in plain form on the port's attention output (bf16
    rows; an fp32 A with an int8 W as split hi | lo rows) against the JAX
    package's whole branch: kernel #4 (`fused_ln_qkv_attn_proj`) or #6
    (`fused_ln_qkv_attn_proj_q8`) in the Pallas interpreter, and #4's XLA
    twin `_xla_ln_qkv_attn_proj`. bf16 compute (#4; #6 at a bf16 x) at two
    bf16 steps, fp32 compute (#6 at an fp32 x) at 5e-5 / 5e-4."""
    jnp, pa, jquant = _jax()
    b, n, c = B_N_C
    xt, _, wt = inst.split("-")
    x_dtype = F32 if xt == "fp32x" else B16
    a = _case(b, n, c, x_dtype, seed=2)
    x, g, be, kb = _t(a["x"], x_dtype), _t(a["g"]), _t(a["be"]), _t(a["kb"])
    jx = jnp.asarray(a["x"]).astype(jnp.float32 if x_dtype == F32 else jnp.bfloat16)
    jg, jbe, jkb = jnp.asarray(a["g"]), jnp.asarray(a["be"]), jnp.asarray(a["kb"])
    if wt == "bf16w":
        wq, wp = _t(a["wq"], B16), _t(a["wp"], B16)
        attn = lqa.ln_qkv_attention_plain(x, g, be, wq, _t(a["bq"]), kb, HEADS)
        out = lqp.proj_residual_large_m_plain(x, attn.reshape(b * n, c), wp, None, _t(a["bp"]))
        jargs = (jx, jg, jbe, jnp.asarray(a["wq"].T).astype(jnp.bfloat16), jnp.asarray(a["bq"]),
                 jnp.asarray(a["wp"].T).astype(jnp.bfloat16), jnp.asarray(a["bp"]), jkb)
        refs = (pa.fused_ln_qkv_attn_proj(*jargs, heads=HEADS, interpret=True),
                pa._xla_ln_qkv_attn_proj(*jargs, heads=HEADS, clamp=True))
        compute = "bf16"
    else:
        tq, tp = quant.quantize_weight(_t(a["wq"])), quant.quantize_weight(_t(a["wp"]))
        attn = lqa.ln_qkv_attention_q8_plain(x, g, be, tq.q, tq.scale, _t(a["bq"]), kb, HEADS)
        rows = (lqp.split_rows_plain(attn) if x_dtype == F32 else attn.reshape(b * n, c))
        out = lqp.proj_residual_large_m_plain(x, rows, tp.q.to(B16), tp.scale, _t(a["bp"]))
        jq, jp = (jquant.quantize_weight(jnp.asarray(a[k].T)) for k in ("wq", "wp"))
        refs = (pa.fused_ln_qkv_attn_proj_q8(jx, jg, jbe, jq.q, jq.scale, jnp.asarray(a["bq"]),
                                             jp.q, jp.scale, jnp.asarray(a["bp"]), jkb,
                                             heads=HEADS, interpret=True),)
        compute = "fp32" if x_dtype == F32 else "bf16"
    assert out.dtype == x_dtype and out.shape == (b * n, c)
    for ref in refs:
        _close(out, np.asarray(ref.astype(jnp.float32)).reshape(b * n, c), compute)


# --------------------------------------- the lockstep tracker under the knobs
def test_batch_tracker_under_both_knobs_matches_jax(monkeypatch):
    """The port's BatchTracker at S=3 (BBOX, NLBBOX and NL streams) under
    UVLTRACK_FUSED_MLP=1 and UVLTRACK_FUSED_PROJ=1, its kernel gates open on
    CPU tensors (so every ViT block calls `ln_mlp` and `proj_residual`, which
    take their plain versions), against the JAX BatchTracker under the same
    knobs, each step from the JAX state (paired_ab's way): boxes within
    1e-3 px, scores and prompts within 1e-4."""
    from test_torch_port_batch import (BOX_TOL, SCORE_TOL, WORDS, _cfg, _frames,
                                       _init_from_jax)
    from test_torch_port_model import make_pair
    from test_torch_port_nl import share_jax_state
    from uvltrack_tpu.core.tokenizer import BertTokenizer as JTok
    from uvltrack_tpu.track.batch import BatchTracker as JBatchTracker
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.ops import attention as tattn
    from uvltrack_tpu_torch.track.batch import BatchTracker

    for knob in ("UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PROJ"):
        monkeypatch.setenv(knob, "1")
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "1")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    calls = {"ln_mlp": 0, "proj_residual": 0}
    for mod, name in ((lm, "ln_mlp"), (lqp, "proj_residual")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    jm, v, tm = make_pair(seed=3)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        vocab = f"{tmp}/vocab.txt"
        with open(vocab, "w") as fh:
            fh.write("\n".join(WORDS) + "\n")
        jbt = JBatchTracker(_cfg(), jm, v, 3, tokenizer=JTok(vocab))
        bt = BatchTracker(CfgNode(_cfg().to_dict()), tm, 3, tokenizer=BertTokenizer(vocab))
        tattn.force_backend("cuda")
        try:
            _init_from_jax(monkeypatch, jbt, bt)
            for t in range(4):
                frames = np.stack(_frames(101 + t, 3))
                share_jax_state(bt, jbt)
                before = dict(calls)
                ref, out = jbt.step(frames), bt.step(frames)
                np.testing.assert_allclose(out[:, :4], ref[:, :4], **BOX_TOL)
                np.testing.assert_allclose(out[:, 4], ref[:, 4], **SCORE_TOL)
                np.testing.assert_allclose(bt.state.prompt.numpy(),
                                           np.asarray(jbt.state.prompt), **SCORE_TOL)
                depth = len(bt.model.backbone.vit.blocks)
                assert {k: calls[k] - before[k] for k in calls} == dict.fromkeys(calls, depth)
        finally:
            tattn.force_backend(None)


# ----------------------------------------------------------- on the card
# chip_smoke.py's rules: KERNEL_ATOL (ln_fc1_gelu 2e-2, fc2_bias and ln_mlp
# 6e-3) + KERNEL_RTOL, Q8_KERNEL_ATOL's proj_residual (2e-2) and proj alone
# (2e-3) for a bf16 out, F32_* for the fp32 out of #6 at an fp32 x
KATOL = {"ln_fc1_gelu": 2e-2, "fc2_bias": 6e-3, "ln_mlp": 6e-3, "proj_residual": 2e-2,
         "proj": 2e-3}
KRTOL, F32_ATOL, F32_RTOL = 2e-2, 2e-4, 2e-4
# (B, N, C): B at S4 and S8, L at S8, B-TRAIN's 16 rows, and M = 195 rows
# (a ragged second 128-row tile; put on the body by LARGE_M_ROWS)
CARD_SHAPES = [(4, 321, 768), (8, 361, 768), (8, 321, 1024), (16, 361, 768), (3, 65, 768)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 0)
    monkeypatch.setattr(lqp, "LARGE_M_ROWS", 0)
    return torch.device("cuda")


def _within(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    assert bool((d <= atol + rtol * want.float().abs()).all()), float(d.max())


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [B16, F32])
@pytest.mark.parametrize("b,n,c", CARD_SHAPES)
def test_cuda_ln_mlp_large_m_matches_plain(cuda, b, n, c, x_dtype, monkeypatch):
    """`ln_mlp[*x-bf16w-lm]`: the hidden tensor against ln_fc1_gelu_plain,
    fc2 against fc2_bias_plain on that hidden tensor, the pair against
    ln_mlp_plain; launched on the large-M body (build.body_counts); the
    pair bitwise on a second call, and the hidden tensor and the output
    bitwise the 64-row launches' (the same GELU, fc2's K in the same four
    parts added in the same order)."""
    a = _case(b, n, c, x_dtype, seed=5)
    dev = cuda
    x, g, be = _t(a["x"], x_dtype).to(dev), _t(a["g"]).to(dev), _t(a["be"]).to(dev)
    w1, b1 = _t(a["w1"], B16).to(dev), _t(a["b1"]).to(dev)
    w2, b2 = _t(a["w2"], B16).to(dev), _t(a["b2"]).to(dev)
    m, f = b * n, 4 * c
    hidden = torch.empty((m, f), dtype=B16, device=dev)
    out, again = (torch.empty((b, n, c), dtype=B16, device=dev) for _ in range(2))
    inst = f"ln_mlp[{'fp32' if x_dtype == F32 else 'bf16'}x-bf16w-lm]"
    before = build.body_counts().get(inst, 0)
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, out)
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden, again)
    torch.cuda.synchronize()
    assert build.body_counts().get(inst, 0) == before + 2
    _within(hidden, lm.ln_fc1_gelu_plain(x, g, be, w1, b1).to(B16).view(m, f),
            KATOL["ln_fc1_gelu"], KRTOL)
    _within(out, lm.fc2_bias_plain(hidden.view(b, n, f), w2, b2), KATOL["fc2_bias"], KRTOL)
    _within(out, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2), KATOL["ln_mlp"], KRTOL)
    assert torch.equal(out, again)
    monkeypatch.setattr(lqa, "LARGE_M_ROWS", 1 << 62)
    hidden64, out64 = torch.empty_like(hidden), torch.empty_like(out)
    lm.launch_ln_mlp(x, g, be, w1, b1, w2, b2, hidden64, out64)
    torch.cuda.synchronize()
    assert torch.equal(hidden, hidden64) and torch.equal(out, out64)


@pytest.mark.gpu
@pytest.mark.parametrize("inst", ["bf16x-bf16a-bf16w", "fp32x-bf16a-bf16w", "bf16x-bf16a-int8w",
                                  "fp32x-fp32a-int8w"])
@pytest.mark.parametrize("b,n,c", CARD_SHAPES)
def test_cuda_proj_residual_large_m_matches_plain(cuda, b, n, c, inst, monkeypatch):
    """`proj_residual[*-lm]`: against proj_residual_plain with the residual
    and alone (on a zero stream, where out = x.dtype(A . Wp^T (* s) + b)
    exactly); launched on the large-M body; bitwise on a second call and
    bitwise the split-K 64-row body's (K in its three parts, added in its
    order)."""
    xt, at, wt = inst.split("-")
    x_dtype, a_dtype = (F32 if t.startswith("fp32") else B16 for t in (xt, at))
    a = _case(b, n, c, x_dtype, seed=6)
    dev = cuda
    x, bp = _t(a["x"], x_dtype).to(dev), _t(a["bp"]).to(dev)
    rng = np.random.default_rng(b + n + c)
    attn = _t(0.3 * rng.normal(size=(b, n, c)), a_dtype).to(dev)
    if wt == "int8w":
        wq = quant.quantize_weight(_t(a["wp"]).to(dev))
        w, s, wplain = wq.q, wq.scale, quant.QuantizedTensor(wq.q, wq.scale, a_dtype)
    else:
        w, s = _t(a["wp"], B16).to(dev), None
        wplain = w
    before = build.body_counts().get(f"proj_residual[{inst}-lm]", 0)
    got, again = (lqp.proj_residual(x, attn, w, bp, s) for _ in range(2))
    z = torch.zeros_like(x)
    alone = lqp.proj_residual(z, attn, w, bp, s)
    torch.cuda.synchronize()
    assert build.body_counts().get(f"proj_residual[{inst}-lm]", 0) == before + 3
    want, want_alone = (lqp.proj_residual_plain(t, attn, wplain, bp) for t in (x, z))
    assert got.dtype == x_dtype and got.shape == x.shape
    if x_dtype == F32 and wt == "int8w":
        _within(got, want, F32_ATOL, F32_RTOL)
        _within(alone, want_alone, F32_ATOL, F32_RTOL)
    else:
        _within(got, want, KATOL["proj_residual"], KRTOL)
        _within(alone, want_alone, KATOL["proj"], KRTOL)
    assert torch.equal(got, again)
    monkeypatch.setattr(lqp, "LARGE_M_ROWS", 1 << 62)
    assert torch.equal(got, lqp.proj_residual(x, attn, w, bp, s))
