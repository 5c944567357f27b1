"""The port's tool modules against the JAX package, and the fp32-weight mode
of the GEMM core.

- fp32 compute on the kernels: an fp32-compute model (TPU.COMPUTE_DTYPE=
  float32, fp32 weights in every block) reaches kernel #1 as
  `ln_qkv[fp32x-fp32w]` and `qkv_attention[fp32]`, and under
  UVLTRACK_FUSED_PROJ=1 / UVLTRACK_FUSED_MLP=1 the fused projection
  (`proj_residual[fp32x-fp32a-fp32w]`) and MLP (`ln_mlp[fp32x-fp32w]`, an
  fp32 result), each fp32 weight through its hi/lo planes (`split_hilo`,
  once per weight): on meta tensors (which take the wrappers' card branch
  without a card) with the device check and the launch spied on, directly
  and through the autograd Functions, whose backward runs.
- `utils/costs.py`: the tiny forward's FLOPs against the JAX
  `compiled_cost`, against `frame_cost`, and the same count with the kernel
  entries taken or not.
- `utils/msgpack_native.py` against `flax.serialization.msgpack_serialize`.
- `cli/test.py::build_tracker` on the JAX trainer's `ep0001.msgpack` and on
  the port's `ep0001.pt`, against the JAX `build_tracker`.
- `ops/prroi_pool.py`, `core/hann.py`, `registry.py` against the JAX package.
- Marker `gpu` (skipped without a card): the fp32-weight instantiations
  (`ln_qkv`, `proj_residual`, `ln_mlp`, and `split_hilo`) against their
  plain versions at B in {1, 8}, N in {321, 361}, C in {768, 1024}, three
  masks, two calls bitwise equal. Run on the card with
  `python -m pytest tests/test_torch_port_tools.py -m gpu --noconftest`
  (no JAX there: this module imports it inside the CPU tests).
"""

import numpy as np
import pytest
import torch

from test_torch_port_cli_test import env, root  # noqa: F401  (fixtures: OTB layout, tiny CLI)
from uvltrack_tpu_torch.ops import attention as tattn
from uvltrack_tpu_torch.ops import autograd as ag
from uvltrack_tpu_torch.ops import build, hilo
from uvltrack_tpu_torch.ops import ln_mlp as lm
from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

# fp32 compute, kernel against plain: fp32 sums in another order, and the
# three bf16 hi/lo passes keep 2^-17 of each operand (the lo.lo term, at
# most 2^-18 |y||w| a product, dropped): PERF.md section 2's fp32 rule
GPU_F32_TOL = 2e-4


# ------------------------------------------------- the fp32-weight fault
def _meta(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.fixture
def spied_launches(monkeypatch):
    """The kernel gates open for meta tensors; the device check passes and
    each launch is recorded as (kernel, instantiation) instead of run."""
    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    for k in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PREFIX",
              "UVLTRACK_PALLAS_MIN_N"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    for mod in (lqa, lqp, lm, hilo):
        monkeypatch.setattr(mod, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "launch", lambda kernel, inst, *a, **k: calls.append(
        (kernel, inst)))
    return calls


@pytest.mark.parametrize("grad", [False, True])
def test_fp32_weights_reach_the_ln_qkv_kernel(grad, spied_launches):
    """An fp32 w_qkv on the kernel route reaches `ln_qkv`'s launch as
    fp32x-fp32w with an fp32 qkv (after the split of its planes), then the
    fp32 attention body; under autograd through LnQkvAttention (no change of
    its own). PR 14's parent refused it: "ln_qkv: w_qkv must be bf16"."""
    c = 768
    x = _meta((1, 361, c), grad=grad)
    args = (_meta((c,)), _meta((c,)), _meta((3 * c, c), grad=grad), _meta((3 * c,)))
    out = tattn.attention_ln_qkv_core(x, *args, 12, None, compute_dtype=torch.float32)
    assert spied_launches == [("split_hilo", "fp32w"), ("ln_qkv", "fp32x-fp32w"),
                              ("qkv_attention", "fp32")]
    assert out.shape == (1, 361, c) and out.dtype == torch.float32
    assert out.requires_grad == grad
    assert lqa.ln_qkv(x.detach(), *[a.detach() for a in args]).dtype == torch.float32


@pytest.mark.parametrize("grad", [False, True])
def test_fp32_weights_reach_the_fused_projection_and_mlp(grad, spied_launches, monkeypatch):
    """#4 and #7 at fp32 compute: under UVLTRACK_FUSED_PROJ=1 the block's
    attention half launches ln_qkv[fp32x-fp32w], qkv_attention[fp32] and
    proj_residual[fp32x-fp32a-fp32w]; under UVLTRACK_FUSED_MLP=1 the MLP
    launches ln_mlp[fp32x-fp32w] with an fp32 result; each fp32 weight's
    planes split first. With grad, through LnQkvAttnProj and LnMlp (no
    change of their own), whose plain-recompute backward gives every input
    its gradient. The parent raised on both ("no fp32-weight
    instantiation", "w1, w2 must be bf16")."""
    c = 768
    x = _meta((1, 361, c), grad=grad)
    vec = [_meta((c,), grad=grad) for _ in range(2)]
    attn_w = [_meta((3 * c, c), grad=grad), _meta((3 * c,), grad=grad), _meta((c, c), grad=grad),
              _meta((c,), grad=grad)]
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", "1")
    out = tattn.attention_block_core(x, *vec, *attn_w, 12, None, compute_dtype=torch.float32)
    split = ("split_hilo", "fp32w")
    assert spied_launches == [split, ("ln_qkv", "fp32x-fp32w"), ("qkv_attention", "fp32"),
                              split, ("proj_residual", "fp32x-fp32a-fp32w")]
    assert out.shape == x.shape and out.dtype == torch.float32 and out.requires_grad == grad
    spied_launches.clear()
    monkeypatch.setenv("UVLTRACK_FUSED_MLP", "1")
    mlp_w = [_meta((4 * c, c), grad=grad), _meta((4 * c,), grad=grad),
             _meta((c, 4 * c), grad=grad), _meta((c,), grad=grad)]
    mlp = tattn.ln_mlp_core(x, *vec, *mlp_w, compute_dtype=torch.float32)
    assert spied_launches == [split, split, ("ln_mlp", "fp32x-fp32w")]
    assert mlp.shape == x.shape and mlp.dtype == torch.float32 and mlp.requires_grad == grad
    if grad:
        (out.sum() + mlp.sum()).backward()
        for t in (x, *vec, *attn_w, *mlp_w):
            assert t.grad is not None and t.grad.shape == t.shape
            assert t.grad.dtype == torch.float32


def test_fp32_weight_needs_an_fp32_stream(spied_launches):
    """ln_qkv[bf16x-fp32w] is not built (an fp32 model's stream is fp32 in
    every block): a bf16 x with an fp32 weight is refused."""
    c = 768
    with pytest.raises(ValueError, match="needs an fp32 x"):
        lqa.ln_qkv(_meta((1, 321, c), torch.bfloat16), _meta((c,)), _meta((c,)),
                   _meta((3 * c, c)), _meta((3 * c,)))
    assert spied_launches == []


# ------------------------------------------------------ utils/costs.py
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny model of tests/test_torch_port_cli_test.py in both packages
    from the same perturbed JAX variables: (jax cfg, jax model, variables,
    port cfg, port model on the CPU, yaml path)."""
    import jax

    from test_torch_port_cli_test import WORDS, _tiny_models, _yaml
    from test_torch_port_model import _np_tree, _perturb
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu.models import uvltrack as juv
    from uvltrack_tpu_torch.config import load_cfg
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state

    root = tmp_path_factory.mktemp("tiny")
    (root / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    (root / "tiny.yaml").write_text(_yaml(str(root / "vocab.txt")))
    mp = pytest.MonkeyPatch()
    _tiny_models(mp)
    try:
        jcfg = jload(str(root / "tiny.yaml"))
        jm = juv.build_model(jcfg)
        v = _perturb(_np_tree(juv.init_model(jm, jcfg, jax.random.PRNGKey(0))),
                     np.random.default_rng(21))
        cfg = load_cfg(str(root / "tiny.yaml"))
        model = tuv.build_model(cfg, device="cpu")
        load_reference_state(model, from_jax_variables(v["params"], v["batch_stats"]))
    finally:
        mp.undo()
    return jcfg, jm, v, cfg, tuv.prepare_inference_model(cfg, model), root


def test_cost_count_against_jax_and_frame_cost(tiny, monkeypatch):
    """The tiny forward_test counted as it runs (utils/costs.py) against the
    JAX compiled_cost of the same program: XLA also counts the elementwise
    ops (LayerNorm, softmax, GELU, residual adds), which the flop counter
    leaves out, so the port's count is at most XLA's and its products make
    99% of it. The cached step's forward is frame_cost plus the head's score
    of the 16 search cells against the 3 prompt tokens (2 x 16 x 3 x C
    FLOPs), which frame_cost leaves out; BERT's layers make the rest of
    forward_test. The same count whether the kernel entries are taken (on
    the CPU their plain versions run) or the plain backend runs."""
    import jax

    from uvltrack_tpu.models import uvltrack as juv
    from uvltrack_tpu.utils.costs import compiled_cost
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.track.tracker import frame_cost
    from uvltrack_tpu_torch.utils.costs import program_cost

    jcfg, jm, v, cfg, model, _ = tiny
    jc = compiled_cost(jax.jit(juv.forward_test_fn(jm)), v, *juv.example_test_inputs(jcfg, jm))
    args = tuv.example_test_inputs(cfg, model)
    fn = tuv.forward_test_fn(model)
    tattn.force_backend("plain")
    try:
        plain = program_cost(fn, *args)
    finally:
        tattn.force_backend(None)
    assert plain["flops"] <= jc["flops"] and plain["flops"] >= 0.99 * jc["flops"]
    assert plain["bytes"] > 0

    entered = []
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    monkeypatch.setenv("UVLTRACK_PALLAS_MIN_N", "8")
    for name in ("ln_qkv", "qkv_attention"):
        orig = getattr(lqa, name)
        monkeypatch.setattr(lqa, name, lambda *a, _o=orig, _n=name: entered.append(_n) or _o(*a))
    kernels = program_cost(fn, *args)
    assert entered.count("ln_qkv") == 2 and entered.count("qkv_attention") == 2
    assert kernels == plain

    c, cells = model.backbone.embed_dim, model.box_head.feat_sz ** 2
    txt = model.encode_text(args[2], args[3])
    cached = program_cost(model.forward_test_cached, args[0], args[1], txt, *args[3:])
    nt = args[2].shape[1]
    assert cached["flops"] == frame_cost(model, nt)["flops"] + 2 * cells * 3 * c
    assert plain["flops"] > cached["flops"]  # BERT runs in forward_test


def test_a_kernel_counts_as_its_plain_version():
    """Each unit's declared work against the flop counter's count of the
    plain version run alone (products only), and inputs read once / output
    written once (kernel #7 also its hidden tensor, written and read once);
    under a CostCount the unit counts that and nothing of what runs
    inside it."""
    from torch.utils.flop_counter import FlopCounterMode

    from uvltrack_tpu_torch.ops import fused_attention as fa
    from uvltrack_tpu_torch.utils.costs import CostCount

    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    b, n, c, h = 2, 40, 64, 2
    x, g, be, w, wb = t(b, n, c), t(c), t(c), t(3 * c, c), t(3 * c)
    kb = torch.zeros(b, n)
    w1, b1, w2, b2 = t(4 * c, c), t(4 * c), t(c, 4 * c), t(c)
    q = k = v = t(b, h, n, 32)
    hidden = 2 * b * n * 4 * c * 4  # kernel #7's fp32 hidden tensor, written and read
    cases = [(lqa.ln_qkv_plain, (x, g, be, w, wb), lqa.ln_qkv_work, 0),
             (lqa.qkv_attention_plain, (t(b, n, 3 * c), kb, h), lqa.qkv_attention_work, 0),
             (lqp.proj_residual_plain, (x, t(b, n, c), t(c, c), t(c)), lqp.proj_residual_work, 0),
             (lm.ln_mlp_plain, (x, g, be, w1, b1, w2, b2), lm.ln_mlp_work, hidden),
             (fa.fused_attention_plain, (q, k, v, kb), fa.attention_work, 0),
             (tattn.plain_attention, (q, k, v, kb[:, None, None, :]), fa.attention_work, 0),
             (tattn.weight_dot, (t(b, n, c), t(c, c)), tattn.weight_dot_work, 0)]
    for fn, a, work, extra in cases:
        with FlopCounterMode(display=False) as fc:
            out = fn(*a)
        flops, nbytes = work(*a)
        assert flops == fc.get_total_flops(), fn.__name__
        ins = sum(u.numel() * u.element_size() for u in a if torch.is_tensor(u))
        assert nbytes == ins + out.numel() * out.element_size() + extra, fn.__name__
        with CostCount() as cc:
            fn(*a)
        assert cc.totals() == {"flops": float(flops), "bytes": float(nbytes)}, fn.__name__


# ------------------------------------------------- utils/msgpack_native.py
def _trainer_like_tree(rng):
    """Every type the JAX trainer's checkpoints hold: nested dicts of fp32 /
    bf16 / int arrays, 0-d arrays, numpy scalars, Python ints, floats,
    strings, bools, None, lists, a complex and bytes."""
    import jax.numpy as jnp

    return {
        "state": {"params": {"block_0": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                                         "bias": np.zeros(6, np.float32)},
                             "emb": np.asarray(jnp.asarray(rng.normal(size=(3, 5)),
                                                           jnp.bfloat16))},
                  "opt_state": {"0": {"count": np.asarray(7, np.int32),
                                      "mu": rng.normal(size=(2, 2)).astype(np.float32)},
                                "1": {}},
                  "step": np.int64(12), "ids": np.arange(5, dtype=np.uint8),
                  "q8": rng.integers(-127, 128, size=(3, 4)).astype(np.int8),
                  "f64": np.float64(0.25), "big": rng.normal(size=(70,)).astype(np.float32)},
        "extra": {"loss": 1.5, "name": "run", "ok": True, "none": None, "hist": [1, -2, 3.5],
                  "neg": -40000, "huge": 2 ** 40, "z": complex(1, -2), "raw": b"\x00\x01"},
        "epoch": 1,
    }


def _assert_same_tree(got, want, path="", bf16_as=None):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}", bf16_as)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, f"{path}[{i}]", bf16_as)
    elif isinstance(want, np.ndarray):
        if want.dtype.name == "bfloat16" and bf16_as is not None:
            want = want.view(np.uint16) if bf16_as == "uint16" else want.astype(np.float32)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("chunk", [None, 64])
def test_msgpack_reader_matches_flax(chunk, monkeypatch):
    """msgpack_restore == flax.serialization.msgpack_restore of
    msgpack_serialize's bytes, leaf by leaf (type, dtype, value); chunk=64
    shrinks flax's MAX_CHUNK_SIZE so arrays above 64 bytes are written as
    __msgpack_chunked_array__ dicts. bf16: ml_dtypes' when installed (here);
    without it, the same bits as uint16; or widened to float32."""
    from flax import serialization

    from uvltrack_tpu_torch.utils import msgpack_native as mn

    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    tree = _trainer_like_tree(np.random.default_rng(0))
    data = serialization.msgpack_serialize(tree)
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    _assert_same_tree(mn.msgpack_restore(data), want)
    _assert_same_tree(mn.msgpack_restore(data, bf16="float32"), want, bf16_as="float32")
    monkeypatch.setattr(mn, "_bfloat16", lambda: None)
    _assert_same_tree(mn.msgpack_restore(data), want, bf16_as="uint16")
    with pytest.raises(ValueError, match="truncated"):
        mn.msgpack_restore(data[:-3])


def test_msgpack_reader_takes_every_msgpack_format():
    """Every width of int, str, bin, array and map that msgpack writes."""
    import msgpack

    from uvltrack_tpu_torch.utils import msgpack_native as mn

    obj = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
                    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
           "strs": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 65536],
           "bins": [b"", b"x" * 256, b"y" * 65536],
           "arrays": [list(range(15)), list(range(16)), list(range(65536))],
           "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
                    {str(i): i for i in range(65536)}],
           "floats": [0.5, -1e300], "f32": 0.0}
    data = msgpack.packb(obj, use_bin_type=True)
    data32 = msgpack.packb(1.25, use_single_float=True)
    assert mn.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert mn.unpackb(data32) == 1.25


# ---------------------------------------------- trainer checkpoints (cli/test.py)
@pytest.fixture(scope="module")
def trainer_ckpts(tiny, tmp_path_factory):
    """The tiny weights as the JAX trainer's ep0001.msgpack (its
    CheckpointManager.save of params, batch_stats and a step) and the
    port's ep0001.pt (its CheckpointManager.save of a TrainState), and as a
    reference .pth.tar."""
    from uvltrack_tpu.train.checkpoint import CheckpointManager as JManager
    from uvltrack_tpu_torch.models.convert import from_jax_variables
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state

    jcfg, jm, v, cfg, model, _ = tiny
    d = tmp_path_factory.mktemp("ckpt")
    msg = JManager(str(d / "jax")).save(1, {"params": v["params"],
                                             "batch_stats": v["batch_stats"],
                                             "step": np.int32(5)}, extra={"loss": 0.5})
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.convert import load_reference_state

    from test_torch_port_cli_test import _tiny_models

    mp = pytest.MonkeyPatch()
    _tiny_models(mp)
    try:
        train_model = tuv.build_model(cfg, device="cpu")
    finally:
        mp.undo()
    load_reference_state(train_model, from_jax_variables(v["params"], v["batch_stats"]))
    pt = CheckpointManager(str(d / "port")).save(
        1, create_train_state(train_model, build_optimizer(cfg, train_model)))
    ref = d / "UVLTrack_ep0001.pth.tar"
    torch.save({"net": from_jax_variables(v["params"], v["batch_stats"])}, ref)
    return {"msgpack": msg, "pt": pt, "pth": str(ref)}


def _frames_and_box(n=5):
    rng = np.random.default_rng(4)
    frames = []
    for t in range(n):
        img = rng.integers(0, 120, size=(72, 96, 3)).astype(np.uint8)
        img[24 + t:42 + t, 30 + 2 * t:50 + 2 * t] = (220, 40, 40)
        frames.append(img)
    return frames, [30.0, 24.0, 20.0, 18.0]


def _track(tracker, frames, box):
    tracker.initialize(frames[0], {"init_bbox": box})
    return np.asarray([tracker.track(f)["target_bbox"] for f in frames[1:]], np.float64)


@pytest.mark.parametrize("kind", ["msgpack", "pt"])
def test_build_tracker_reads_trainer_checkpoints(kind, tiny, trainer_ckpts, monkeypatch):
    """build_tracker on the JAX trainer's ep0001.msgpack and on the port's
    ep0001.pt: the boxes of the JAX build_tracker on the .msgpack (within 1
    px), and bitwise the port's own on the reference .pth.tar of the same
    weights."""
    from test_torch_port_cli_test import _tiny_models
    from uvltrack_tpu.cli import test as jtest
    from uvltrack_tpu.config import load_cfg as jload
    from uvltrack_tpu_torch.cli import test as ttest
    from uvltrack_tpu_torch.config import load_cfg

    _tiny_models(monkeypatch)
    yaml = str(tiny[5] / "tiny.yaml")
    frames, box = _frames_and_box()
    want = _track(jtest.build_tracker(jload(yaml), trainer_ckpts["msgpack"]), frames, box)
    got = _track(ttest.build_tracker(load_cfg(yaml), trainer_ckpts[kind], device="cpu"),
                 frames, box)
    ref = _track(ttest.build_tracker(load_cfg(yaml), trainer_ckpts["pth"], device="cpu"),
                 frames, box)
    np.testing.assert_allclose(got, want, atol=1.0, rtol=0)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["msgpack", "pt"])
def test_cli_test_runs_on_trainer_checkpoints(kind, trainer_ckpts, root, env, tmp_path,
                                              monkeypatch):
    """cli.test.main --device cpu with --test_checkpoint a trainer checkpoint
    (the OTB layout and tiny model of tests/test_torch_port_cli_test.py,
    whose .pth.tar holds the same weights): the saved boxes of every
    sequence bitwise those of the .pth.tar run."""
    import test_torch_port_cli_test as ct
    from uvltrack_tpu_torch.cli import test as ttest

    boxes = {}
    for label, ckpt in (("pth", str(root / "UVLTrack_ep0001.pth.tar")),
                        (kind, trainer_ckpts[kind])):
        out = ct._main(ttest, ["uvltrack", "tiny_cli", "--device", "cpu",
                               "--test_checkpoint", ckpt], tmp_path / label, monkeypatch)
        assert "AUC=" in out
        boxes[label] = {name: env[("port", name)].copy() for name in ct.SEQS}
    for name in ct.SEQS:
        np.testing.assert_array_equal(boxes[kind][name], boxes["pth"][name], err_msg=name)


def test_build_tracker_refuses_other_files(tiny, tmp_path, monkeypatch):
    from test_torch_port_cli_test import _tiny_models
    from uvltrack_tpu_torch.cli import test as ttest
    from uvltrack_tpu_torch.config import load_cfg

    _tiny_models(monkeypatch)
    cfg = load_cfg(str(tiny[5] / "tiny.yaml"))
    with pytest.raises(ValueError, match="unknown checkpoint type"):
        ttest.build_tracker(cfg, str(tmp_path / "weights.npz"), device="cpu")
    bad = tmp_path / "ep0001.pt"
    torch.save({"state": {"params": {}}, "epoch": 1}, bad)
    with pytest.raises(ValueError, match="not a trainer checkpoint of the port"):
        ttest.build_tracker(cfg, str(bad), device="cpu")


# ------------------------------------------------------ ops/prroi_pool.py
def _prroi_case(seed=2):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(2, 8, 9, 3)).astype(np.float32)
    rois = np.asarray([[0, 1.2, 1.5, 6.3, 6.1], [1, 0.3, 2.0, 8.7, 5.5],
                       [1, -1.0, -0.5, 3.0, 2.5], [0, 3.0, 3.0, 3.0, 5.0],
                       [1, 6.0, 5.0, 2.0, 1.0]], np.float32)  # zero-width, doubly inverted
    return feat, rois


def test_prroi_pool_and_both_gradients_match_jax():
    """Forward and the gradients of the features and of the RoI coordinates
    against the JAX function under jax.grad: fp32, 1e-5 (sums in another
    order). spatial_scale 0.5 scales the coordinates exactly: at a scale
    that rounds, XLA contracts x2 * s - x1 * s into an FMA and gives the
    zero-width RoI a width of one rounding error (and a garbage average)."""
    import jax
    import jax.numpy as jnp

    from uvltrack_tpu.ops import prroi_pool as jpr
    from uvltrack_tpu_torch.ops import prroi_pool as tpr

    feat, rois = _prroi_case()
    w = np.random.default_rng(3).normal(size=(5, 2, 3, 3)).astype(np.float32)

    def jloss(f, r):
        return (jpr.prroi_pool(f, r, 2, 3, 0.5) * w).sum()

    jout = jax.jit(lambda f, r: jpr.prroi_pool(f, r, 2, 3, 0.5))(feat, rois)
    jgf, jgr = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(feat), jnp.asarray(rois))
    f = torch.from_numpy(feat).requires_grad_(True)
    r = torch.from_numpy(rois).requires_grad_(True)
    out = tpr.prroi_pool(f, r, 2, 3, 0.5)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgf), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(r.grad[:, 1:].numpy(), np.asarray(jgr)[:, 1:], atol=1e-5,
                               rtol=1e-5)
    assert np.abs(r.grad[:, 1:].numpy()).sum() > 0


def test_prroi_pool_cases_of_the_jax_tests():
    """tests/test_prroi_pool.py's fixture-free cases on the port: the hat
    integral, average pooling on aligned RoIs, numeric integration, zero
    area and doubly inverted RoIs pooling to 0."""
    from uvltrack_tpu_torch.ops import prroi_pool as tpr

    got = tpr._hat_cumint(torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]))
    np.testing.assert_allclose(got.numpy(), [0.0, 0.0, 0.125, 0.5, 0.875, 1.0, 1.0])
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(1, 8, 8, 2)).astype(np.float32)
    out = tpr.prroi_pool(torch.from_numpy(feat), torch.tensor([[0, 1.0, 1.0, 5.0, 5.0]]), 2, 2)
    f = feat[0]
    for py in range(2):
        for px in range(2):
            cells = [(f[y, x] + f[y, x + 1] + f[y + 1, x] + f[y + 1, x + 1]) / 4
                     for y in (1 + 2 * py, 2 + 2 * py) for x in (1 + 2 * px, 2 + 2 * px)]
            np.testing.assert_allclose(out[0, py, px].numpy(), np.mean(cells, 0), atol=1e-5)
    feat = np.random.default_rng(1).normal(size=(6, 7, 1)).astype(np.float32)
    roi = np.array([0.7, 1.3, 5.2, 4.1], np.float32)
    out = tpr.prroi_pool_one(torch.from_numpy(feat), torch.from_numpy(roi), 2, 3).numpy()

    def bilinear(y, x):
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        wx, wy = x - x0, y - y0

        def px(yy, xx):
            return feat[yy, xx, 0] if 0 <= yy < 6 and 0 <= xx < 7 else 0.0

        return (px(y0, x0) * (1 - wx) * (1 - wy) + px(y0, x0 + 1) * wx * (1 - wy)
                + px(y0 + 1, x0) * (1 - wx) * wy + px(y0 + 1, x0 + 1) * wx * wy)

    bw, bh, n = (roi[2] - roi[0]) / 3, (roi[3] - roi[1]) / 2, 80
    for py in range(2):
        for px_ in range(3):
            ys = roi[1] + bh * (py + (np.arange(n) + 0.5) / n)
            xs = roi[0] + bw * (px_ + (np.arange(n) + 0.5) / n)
            want = np.mean([[bilinear(y, x) for x in xs] for y in ys])
            assert np.isclose(out[py, px_, 0], want, atol=2e-3), (py, px_)
    ones = torch.ones((1, 8, 8, 1))
    for roi in ([0, 3.0, 3.0, 3.0, 5.0], [0, 6.0, 5.0, 2.0, 1.0]):
        r = torch.tensor([roi], requires_grad=True)
        out = tpr.prroi_pool(ones, r, 2, 2)
        out.sum().backward()
        assert torch.all(out == 0) and torch.all(r.grad == 0)


# ------------------------------------------------- core/hann.py, registry.py
@pytest.mark.parametrize("centered", [True, False])
def test_hann_windows_match_jax(centered):
    """hann1d/hann2d against the JAX package at sizes 1-40: XLA's and
    PyTorch's fp32 cos differ in the last bit on some arguments, so within
    one fp32 step at 1 (2^-23)."""
    from uvltrack_tpu.core import hann as jh
    from uvltrack_tpu_torch.core import hann as th

    for sz in range(1, 41):
        want = np.asarray(jh.hann1d(sz, centered))
        got = th.hann1d(sz, centered).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=2.0 ** -23, rtol=0)
    np.testing.assert_allclose(th.hann2d(7, 9, centered).numpy(),
                               np.asarray(jh.hann2d(7, 9, centered)), atol=2.0 ** -23, rtol=0)


def test_registry_matches_jax():
    from uvltrack_tpu import registry as jreg
    from uvltrack_tpu_torch import registry as treg
    from uvltrack_tpu_torch.models import uvltrack as tuv

    names = ("MODELS", "BACKBONES", "HEADS", "ACTORS", "LOSSES", "DATASETS", "TRACKERS")
    for n in names:
        assert getattr(treg, n).name == getattr(jreg, n).name
    assert treg.MODELS["uvltrack"] is tuv.build_model
    with pytest.raises(KeyError, match="already registered"):
        treg.MODELS.register("uvltrack")(lambda cfg: None)
    with pytest.raises(KeyError, match="available"):
        treg.HEADS["missing"]
    reg = treg.Registry("x")
    reg.register("a")(len)
    assert "a" in reg and list(reg.keys()) == ["a"] and reg["a"] is len


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32_case(b, n, c, mask, dev, seed=0):
    """fp32 x, LN, W (Linear layout) and bias, and a (B, N) key bias: flag0
    masks the trailing 40 (text) keys, flag2 5-34 of them a row, open none."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    masked = np.zeros((b, n), bool)
    for r in range(b):
        if mask == "flag0":
            masked[r, -40:] = True
        elif mask == "flag2":
            masked[r, -int(rng.integers(5, 35)):] = True
    return (t(rng.normal(size=(b, n, c))), t(1 + 0.1 * rng.normal(size=c)),
            t(0.1 * rng.normal(size=c)), t(rng.normal(size=(3 * c, c)) / np.sqrt(c)),
            t(0.02 * rng.normal(size=3 * c)), t(np.where(masked, -1e10, 0.0)))


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["flag0", "flag2", "open"])
@pytest.mark.parametrize("c", [768, 1024])
@pytest.mark.parametrize("n", [321, 361])
@pytest.mark.parametrize("b", [1, 8])
def test_cuda_ln_qkv_fp32_weights_match_plain(cuda, b, n, c, mask):
    """ln_qkv[fp32x-fp32w] (three bf16 hi/lo passes on the wgmma core, W's
    planes split once by split_hilo) and the attention after it
    (qkv_attention[fp32]) against their plain fp32 versions; a second call
    bitwise equal, with no second split."""
    x, g, be, w, wb, kb = _f32_case(b, n, c, mask, cuda, seed=b + n + c)
    heads = c // 64
    build.reset_launch_counts()
    qkv = lqa.ln_qkv(x, g, be, w, wb)
    out = lqa.qkv_attention(qkv, kb, heads)
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {"split_hilo[fp32w]": 1, "ln_qkv[fp32x-fp32w]": 1,
                                            "qkv_attention[fp32]": 1}
    assert qkv.dtype == torch.float32 and qkv.shape == (b, n, 3 * c)
    torch.testing.assert_close(qkv, lqa.ln_qkv_plain(x, g, be, w, wb), atol=GPU_F32_TOL,
                               rtol=GPU_F32_TOL)
    torch.testing.assert_close(out, lqa.ln_qkv_attention_plain(x, g, be, w, wb, kb, heads),
                               atol=GPU_F32_TOL, rtol=GPU_F32_TOL)
    torch.testing.assert_close(lqa.ln_qkv(x, g, be, w, wb), qkv, rtol=0, atol=0)
    assert build.instantiation_counts()["split_hilo[fp32w]"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["flag0", "flag2", "open"])
@pytest.mark.parametrize("c", [768, 1024])
@pytest.mark.parametrize("n", [321, 361])
@pytest.mark.parametrize("b", [1, 8])
def test_cuda_fp32_fused_projection_and_mlp_match_plain(cuda, b, n, c, mask):
    """proj_residual[fp32x-fp32a-fp32w] alone and in kernel #4's composition,
    and ln_mlp[fp32x-fp32w] (an fp32 hidden tensor and output), against
    their plain fp32 versions; two calls bitwise equal; split_hilo's planes
    bitwise its plain version's."""
    x, g, be, w, wb, kb = _f32_case(b, n, c, mask, cuda, seed=b * n + c)
    rng = np.random.default_rng(b + n + c)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(cuda)  # noqa: E731
    wp, bp = t(rng.normal(size=(c, c)) / np.sqrt(c)), t(0.02 * rng.normal(size=c))
    w1, b1 = t(rng.normal(size=(4 * c, c)) / np.sqrt(c)), t(0.02 * rng.normal(size=4 * c))
    w2, b2 = t(rng.normal(size=(c, 4 * c)) / np.sqrt(4 * c)), t(0.02 * rng.normal(size=c))
    heads = c // 64
    attn = lqa.ln_qkv_attention(x, g, be, w, wb, kb, heads)
    build.reset_launch_counts()
    proj = lqp.proj_residual(x, attn, wp, bp)
    fused = lqp.ln_qkv_attn_proj(x, g, be, w, wb, wp, bp, kb, heads)
    mlp = lm.ln_mlp(x, g, be, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert build.instantiation_counts() == {
        "split_hilo[fp32w]": 3, "proj_residual[fp32x-fp32a-fp32w]": 2, "ln_mlp[fp32x-fp32w]": 1,
        "ln_qkv[fp32x-fp32w]": 1, "qkv_attention[fp32]": 1}
    assert proj.dtype == fused.dtype == mlp.dtype == torch.float32
    for got, want in ((proj, lqp.proj_residual_plain(x, attn, wp, bp)),
                      (fused, lqp.ln_qkv_attn_proj_plain(x, g, be, w, wb, wp, bp, kb, heads)),
                      (mlp, lm.ln_mlp_plain(x, g, be, w1, b1, w2, b2))):
        torch.testing.assert_close(got, want, atol=GPU_F32_TOL, rtol=GPU_F32_TOL)
    torch.testing.assert_close(lqp.proj_residual(x, attn, wp, bp), proj, rtol=0, atol=0)
    torch.testing.assert_close(lm.ln_mlp(x, g, be, w1, b1, w2, b2), mlp, rtol=0, atol=0)
    for weight in (w, wp, w1, w2):
        assert torch.equal(hilo.planes(weight), hilo.split_hilo_plain(weight))
