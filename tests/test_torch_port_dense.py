"""The default path's weight products on the GEMM core
(ops/ln_qkv_attn_proj.py::dense_f32, `uvl_dense` of csrc/proj_residual.cu):
the projection of ops/attention.py::attn_proj_core and fc1 and fc2 of
ln_mlp_core's plain version, quant_dot's function, a . w^T in fp32.

On the CPU: the dispatch predicate (`dense_fallback`) on meta tensors, which
take the card branch when `lqp._on_card` is patched true, with build.launch
recorded, not run: the core only for bf16 operands that need no gradient,
with K a multiple of 64; quant_dot (and a count in build.FALLBACKS) for
fp32 and int8 weights, under autograd and for another K; quant_dot, bitwise,
for CPU tensors; the schedule by shape (`dense_parts`); a ViT block's three
products on the "cuda" backend and none on the plain one.

On the card (`python -m pytest tests/test_torch_port_dense.py -m gpu
--noconftest`): the core against dot_f32 at the four cells' shapes (fp32 sums
of exact products in two orders, |diff| at most 1e-5 of the sum of |a||w|),
bitwise on a second call; UVLTrack-B's captured step graph launching 36 of
them and handing none to the upcast; and its boxes over 20 frames at S=1
and S=8 against the upcast path's, within portbench's box_err limit.
"""

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import build
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp
from uvltrack_tpu_torch.ops import quant

B16, F32 = torch.bfloat16, torch.float32
TAG = ("dense", "bf16a-bf16w-fp32o")
H100_SMS = 132  # the card the schedule was timed on


def _meta(shape, dtype=B16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.fixture
def on_card(monkeypatch):
    """Meta tensors on the card branch of dense_f32; each launch recorded as
    (kernel, instantiation, positional arguments, keywords), not run."""
    calls = []
    monkeypatch.setattr(lqp, "_on_card", lambda t: True)
    monkeypatch.setattr(lqp, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(lqp, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(build, "launch", lambda k, i, *a, **kw: calls.append((k, i, a, kw)))
    return calls


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("m,k,n,parts", [(130, 128, 128, 1), (361, 768, 768, 1),
                                         (361, 768, 3072, 0), (321, 3072, 768, 3),
                                         (361, 4096, 1024, 2), (2888, 1024, 4096, 0)])
def test_card_bf16_takes_the_core(on_card, m, k, n, parts):
    """bf16 operands that need no gradient, K a multiple of 64: one launch of
    uvl_dense from proj_residual's library under its own tag, into the one
    fp32 tensor it allocates, at dense_parts' schedule."""
    before = build.fallback_counts()
    out = lqp.dense_f32(_meta((m, k)), _meta((n, k)))
    assert [c[:2] for c in on_card] == [TAG]
    _, _, args, kw = on_card[0]
    assert kw["entry"] == "uvl_dense" and kw["lib"] == "proj_residual"
    assert kw["body"] == ("64" if parts else "lm")
    assert args[0] == [build.PTR] * 3 + [build.INT] * 4 and args[4:] == (m, k, n, parts)
    assert out.shape == (m, n) and out.dtype == F32
    assert build.fallback_counts() == before


def test_rows_of_any_rank_go_to_the_core_as_one_matrix(on_card):
    """(B, N, K) activations: M = B*N rows, the output (B, N, N_out)."""
    out = lqp.dense_f32(_meta((2, 361, 768)), _meta((768, 768)))
    assert on_card[0][2][4:] == (722, 768, 768, 1) and out.shape == (2, 361, 768)


@pytest.mark.parametrize("why,a,w", [
    ("dtype", lambda: _meta((64, 128), F32), lambda: _meta((256, 128), F32)),
    ("dtype", lambda: _meta((64, 128)), lambda: _meta((256, 128), F32)),
    ("int8w", lambda: _meta((64, 128)),
     lambda: quant.QuantizedTensor(_meta((256, 128), torch.int8), _meta((256,), F32), B16)),
    ("grad", lambda: _meta((64, 128), grad=True), lambda: _meta((256, 128))),
    ("grad", lambda: _meta((64, 128)), lambda: _meta((256, 128), grad=True)),
    ("shape", lambda: _meta((64, 96)), lambda: _meta((256, 96))),
    ("shape", lambda: _meta((64, 128)), lambda: _meta((100, 128))),
    ("shape", lambda: _meta((0, 128)), lambda: _meta((256, 128))),
])
def test_card_falls_back_to_the_upcast(on_card, why, a, w):
    """fp32 or mixed operands, an int8 QuantizedTensor, a gradient needed, K
    not a multiple of 64 (or N of 8, or no rows): quant_dot, no launch, and
    one count of the reason in build.FALLBACKS."""
    a, w = a(), w()
    assert lqp.dense_fallback(a, w) == why
    before = build.FALLBACKS[f"dense[{why}]"]
    out = lqp.dense_f32(a, w)
    assert on_card == []
    assert build.FALLBACKS[f"dense[{why}]"] == before + 1
    assert out.dtype == F32 and out.shape == (a.shape[0], w.shape[0])


def test_no_grad_mode_lets_a_grad_weight_take_the_core(on_card):
    """A parameter that requires a gradient, under torch.no_grad (the
    tracker's forward): no gradient is needed, so the core takes it."""
    with torch.no_grad():
        lqp.dense_f32(_meta((64, 128)), _meta((256, 128), grad=True))
    assert [c[:2] for c in on_card] == [TAG]


@pytest.mark.parametrize("wdtype", [B16, F32, "int8"])
def test_cpu_tensors_take_quant_dot_bitwise(wdtype):
    """Off the card every weight takes quant_dot itself, bitwise, with no
    launch and no fallback counted."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(2, 5, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    if wdtype == "int8":
        a, w = a.to(B16), quant.quantize_weight(w).to(B16)
    else:
        a, w = a.to(wdtype), w.to(wdtype)
    before = build.fallback_counts()
    assert lqp.dense_fallback(a, w) == "cpu"
    assert torch.equal(lqp.dense_f32(a, w), quant.quant_dot(a, w))
    assert build.fallback_counts() == before


def test_schedule_by_shape(monkeypatch):
    """The cells' shapes take the schedule that ran fastest on the card (an
    H100's 132 SMs): the large-M body from LARGE_M_ROWS rows and for fc1
    (N = 4K); below it the projection unsplit, fc2 in 3 parts at C = 768 and
    in 2 at 1,024; at most 3 parts, and no more than 64-deep k-tiles; the
    threshold read at each call."""
    want = {(768, 768): 1, (768, 3072): 0, (3072, 768): 3,
            (1024, 1024): 1, (1024, 4096): 0, (4096, 1024): 2}
    for m in (321, 361):
        assert {kn: lqp.dense_parts(m, *kn, H100_SMS) for kn in want} == want
    for m in (2568, 2888):
        assert {lqp.dense_parts(m, *kn, H100_SMS) for kn in want} == {0}
    assert lqp.dense_parts(64, 64, 64, H100_SMS) == 1
    assert lqp.dense_parts(8, 8192, 64, H100_SMS) == 3
    monkeypatch.setattr(lqp, "LARGE_M_ROWS", 300)
    assert lqp.dense_parts(321, 768, 768, H100_SMS) == 0


def _block_args(c):
    vecs = [_meta((c,), F32) for _ in range(2)]
    return dict(ln=vecs, wq=_meta((3 * c, c)), bq=_meta((3 * c,), F32), wp=_meta((c, c)),
                bp=_meta((c,), F32), w1=_meta((4 * c, c)), b1=_meta((4 * c,), F32),
                w2=_meta((c, 4 * c)), b2=_meta((c,), F32))


@pytest.mark.parametrize("backend,want", [("cuda", 3), ("plain", 0)])
def test_a_blocks_default_path_runs_its_three_products_on_the_core(on_card, monkeypatch,
                                                                   backend, want):
    """The composed projection and ln_mlp_core's plain version on the "cuda"
    backend: the projection, fc1 and fc2 each one launch of the new tag at
    the block's shapes (K = C, C, 4C); on the plain backend none."""
    for knob in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(tattn, "_BACKEND", backend)
    c, p = 128, _block_args(128)
    x, attn = _meta((2, 65, c)), _meta((2, 65, c))
    with torch.no_grad():
        proj = tattn.attn_proj_core(attn, p["wp"], p["bp"], compute_dtype=B16)
        mlp = tattn.ln_mlp_core(x, *p["ln"], p["w1"], p["b1"], p["w2"], p["b2"],
                                compute_dtype=B16)
    assert proj.dtype == mlp.dtype == B16 and proj.shape == mlp.shape == x.shape
    assert [c_[:2] for c_ in on_card] == [TAG] * want
    if want:
        assert [c_[2][4:6] for c_ in on_card] == [(130, c), (130, c), (130, 4 * c)]


def test_a_blocks_products_under_autograd_stay_the_upcast(on_card, monkeypatch):
    """Training's forward (weights that need a gradient, grad mode on): no
    launch, three fallbacks, and gradients for every weight."""
    for knob in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    c = 128
    x, attn = _meta((2, 65, c)), _meta((2, 65, c))
    wp, w1, w2 = _meta((c, c), grad=True), _meta((4 * c, c), grad=True), _meta((c, 4 * c),
                                                                               grad=True)
    vecs = [_meta((c,), F32) for _ in range(2)]
    before = build.FALLBACKS["dense[grad]"]
    out = (tattn.attn_proj_core(attn, wp, _meta((c,), F32), compute_dtype=B16)
           + tattn.ln_mlp_core(x, *vecs, w1, _meta((4 * c,), F32), w2, _meta((c,), F32),
                               compute_dtype=B16))
    out.float().sum().backward()
    assert on_card == [] and build.FALLBACKS["dense[grad]"] == before + 3
    assert all(t.grad is not None for t in (wp, w1, w2))


def test_plain_functions_keep_the_upcast_by_default():
    """The plain versions the card's kernel checks read take quant_dot unless
    a caller passes its product."""
    import inspect

    from uvltrack_tpu_torch.ops import ln_mlp as lm

    for fn in (lm.ln_fc1_gelu_plain, lm.fc2_bias_plain, lm.ln_mlp_plain):
        assert inspect.signature(fn).parameters["dot"].default is quant.quant_dot
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 7, 64)).astype(np.float32)).to(B16)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32) / 8).to(B16)
          for s in ((256, 64), (64, 256))]
    g, be = torch.ones(64), torch.zeros(64)
    b1, b2 = torch.zeros(256), torch.zeros(64)
    assert torch.equal(tattn.ln_mlp_core(x, g, be, ws[0], b1, ws[1], b2),
                       lm.ln_mlp_plain(x, g, be, ws[0], b1, ws[1], b2))


# ------------------------------------------------------------- on the card
DOT_SHAPES = [(m, k, n) for c in (768, 1024) for m in (321, 361, 2568, 2888)
              for k, n in ((c, c), (c, 4 * c), (4 * c, c))]
DOT_RTOL = 1e-5  # of sum_k |a||w|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", DOT_SHAPES)
def test_cuda_dense_matches_dot_f32(cuda, m, k, n):
    """The core at the cells' shapes against the upcast product: within the
    fp32 summation-order bound, bitwise on a second call, two launches of
    the tag and no fallback."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda, B16)
    w = torch.from_numpy((rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)).to(cuda, B16)
    build.reset_launch_counts()
    before = build.fallback_counts()
    out, again = lqp.dense_f32(a, w), lqp.dense_f32(a, w)
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {"dense[bf16a-bf16w-fp32o]": 2}
    assert build.fallback_counts() == before
    ref = quant.dot_f32(a, w)
    bound = DOT_RTOL * (a.float().abs() @ w.float().abs().t())
    gap = float(((out - ref).abs() / bound).max())
    assert gap <= 1, f"|core - dot_f32| reaches {gap:.3f} of the bound"
    assert torch.equal(out, again)


@pytest.fixture(scope="module")
def card_model():
    """UVLTrack-B (baseline_base.yaml) on the card, seeded random weights,
    re-mines every 2 frames (the score gate opened)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    from pathlib import Path

    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models.uvltrack import build_model, prepare_inference_model

    repo = Path(__file__).resolve().parents[1]
    cfg = load_cfg(str(repo / "experiments/uvltrack/baseline_base.yaml"))
    cfg.TEST.THRESHOLD, cfg.TEST.UPDATE_INTERVAL, cfg.TEST.MODE = -1.0, 2, "BBOX"
    return cfg, prepare_inference_model(cfg, build_model(cfg, device="cuda", seed=0))


def _frames(seed, S):
    return np.random.default_rng(seed).integers(0, 255, size=(S, 480, 854, 3), dtype=np.uint8)


def _card_tracker(cfg, model, S):
    """A BatchTracker of S streams on its own JitTracker (graph step),
    initialized on seeded 480p frames."""
    from uvltrack_tpu_torch.track.batch import BatchTracker
    from uvltrack_tpu_torch.track.tracker import JitTracker

    rng = np.random.default_rng(S)
    boxes = np.concatenate([rng.uniform(100, 600, size=(S, 2)),
                            rng.uniform(60, 120, size=(S, 2))], 1).astype(np.float32)
    bt = BatchTracker(cfg, None, S, jit_tracker=JitTracker(cfg, model))
    bt.initialize(_frames(1, S), boxes)
    return bt


@pytest.mark.gpu
def test_cuda_step_graph_runs_every_product_on_the_core(card_model):
    """UVLTrack-B's step graph (S=8) records 36 launches of the tag (three a
    block, 12 blocks) and hands no product to the upcast."""
    cfg, model = card_model
    before = build.fallback_counts()
    bt = _card_tracker(cfg, model, 8)
    for t in range(2):
        bt.step(_frames(2 + t, 8))
    jt = bt.jt
    steps = [jt.captured_launches(key)["step"] for key in jt._sets]
    assert steps and all(s.get("dense[bf16a-bf16w-fp32o]") == 36 for s in steps)
    assert build.fallback_counts() == before


BOX_ERR = {1: 0.017, 8: 0.02}  # portbench's box_err limits, B-S1-bbox and B-S8-mixed
TIE = 0.05  # chip_smoke.py's AB_TIE: a flip between cells scoring within 5%


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8])
def test_cuda_boxes_match_the_upcast_path(card_model, S):
    """20 frames stepped on the core and on the upcast (dense_f32 replaced
    by quant_dot while the second tracker's graphs are captured and run),
    each frame from the core's state (a free-running pair drifts apart at
    the first near-flat random-weight map): every box within box_err's
    limit of the search crop's side (the box's side times the search
    factor), or both scores within TIE of each other (a near-tie flip of
    the argmax cell); at most a tenth of the rows flip."""
    cfg, model = card_model
    core, upcast = _card_tracker(cfg, model, S), _card_tracker(cfg, model, S)
    dense, flips = lqp.dense_f32, 0
    for t in range(20):
        state, frames = core.state, _frames(2 + t, S)
        side = float(cfg.TEST.SEARCH_FACTOR) * np.sqrt(
            (state.box[:, 2] * state.box[:, 3]).double().cpu().numpy())
        a = core.step(frames)
        upcast.state = state
        lqp.dense_f32 = quant.quant_dot
        try:
            b = upcast.step(frames)
        finally:
            lqp.dense_f32 = dense
        err = np.abs(a[:, :4] - b[:, :4]).max(1) / side
        tie = np.abs(a[:, 4] - b[:, 4]) <= TIE * np.maximum(a[:, 4], b[:, 4])
        assert np.all((err <= BOX_ERR[S]) | tie), (t, err, a[:, 4], b[:, 4])
        flips += int(np.sum(err > BOX_ERR[S]))
    assert flips <= 2 * S, f"{flips} near-tie flips in {20 * S} rows"
