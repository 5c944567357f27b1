"""uvltrack_tpu_torch's parallel slice against the JAX package: the
data-parallel train step (parallel/, train/step.py, train/optim.py ZeRO-1,
train/trainer.py, cli/train.py --multihost) and the stream mesh
(track/batch.py BatchTracker(mesh=), track/pool.py StreamPool(mesh=),
cli/serve.py's lockstep mesh).

Training runs on the micro model of tests/test_train_stack.py (C=32, 2
blocks, 4 heads, a 1-layer BERT, 32/64 px crops, fp32) with the JAX
variables perturbed from a numpy seed and handed to the port through
from_jax_variables. The port's dp=2 runs are two processes over gloo on
127.0.0.1 (a free port), each under a communicate timeout of its own; they
import this module, which imports no JAX at its top. The JAX mesh step is
one SPMD program over the global batch, so the dp=2 step is held to JAX's
gradients of forward_and_loss on the global batch (n_search 1, whose
half-batch rotation pairs rows of different ranks, and 2; GRAD_ACCUM 1 and
2), with tests/test_torch_port_train.py's tolerances, and its AdamW update
to one step of JAX's jit_sharded_train_step on make_mesh(data=2) (two of
the conftest's eight virtual CPU devices). ZeRO-1 against the replicated
step: rtol 1e-3 / atol 1e-4 (tests/test_train_stack.py:371-379).

The stream mesh: two CPU replicas (make_mesh(devices=[cpu, cpu])) against
the unsharded port and JAX's mesh BatchTracker/StreamPool on two virtual
devices, at tests/test_batch_tracker.py's tolerance (rtol 1e-5, atol 1e-4).
"""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from uvltrack_tpu_torch.config import CfgNode
from uvltrack_tpu_torch.parallel.mesh import make_mesh, shard_batch, zero1_axis

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TOL = 1e-5
GRAD_FLOOR = 1e-6
Z1_RTOL, Z1_ATOL = 1e-3, 1e-4
MESH_TOL = dict(rtol=1e-5, atol=1e-4)
CHILD_TIMEOUT = 600  # seconds a dp=2 process may take (~40 s alone, ~170 s beside -n 6)
CASES = [(n, a) for n in (1, 2) for a in (1, 2)]  # (search frames, GRAD_ACCUM)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(code: str, n: int = 2, env=None, args=()) -> list:
    """n processes of `code` (this directory on sys.path), RANK 0..n-1 of a
    torchrun-style environment on a free port; returns their (rc, output),
    each under its own communicate timeout."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        penv = dict(os.environ, **(env or {}), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK="0", OMP_NUM_THREADS="2",
                    PYTHONPATH=os.pathsep.join([str(TESTS), str(REPO)]))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *args], cwd=str(REPO),
                                      env=penv, text=True, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


# ------------------------------------------------------- the dp=2 worker
def _cfg_of(d: Path, **tpu) -> CfgNode:
    cfg = CfgNode(json.loads((d / "cfg.json").read_text()))
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    return cfg


def _model(d: Path):
    from test_torch_port_train import _port_model
    from uvltrack_tpu_torch.models.convert import load_reference_state

    tm = _port_model()
    assert load_reference_state(tm, torch.load(d / "weights.pt")) == []
    return tm


def _batch(d: Path, n_search: int) -> dict:
    with np.load(d / f"batch_n{n_search}.npz") as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


class _Recorder:
    """An optimizer that records the (reduced) gradients and steps nothing."""

    def __init__(self, model):
        self.model = model

    def step(self, step):
        from uvltrack_tpu_torch.train.optim import global_norm

        self.grads = {n: p.grad.clone() for n, p in self.model.named_parameters()}
        return global_norm(list(self.grads.values()))


class _Paired:
    """The ZeRO-1 optimizer of the stepped model, and a replicated one
    stepping a second model from the same gradients."""

    def __init__(self, model, zero1, follow_model, follow):
        self.model, self.zero1, self.follow_model, self.follow = model, zero1, follow_model, follow

    def step(self, step):
        for a, b in zip(self.model.parameters(), self.follow_model.parameters()):
            b.grad = a.grad.clone()
        norm = self.zero1.step(step)
        self.follow.step(step)
        return norm


def _worker(d: str) -> None:
    """One rank of the dp=2 runs, its results in rank<R>.pt: every (search
    frames, GRAD_ACCUM) case's gradients, metrics and BN stats; two AdamW
    steps replicated and under ZeRO-1 (the ZeRO-1 state after step 1
    checkpointed by rank 0); a Trainer whose rank-1 loader raises once."""
    import torch.distributed as dist

    from uvltrack_tpu_torch.parallel.dp import DataParallel
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import TrainState, create_train_state, make_train_step

    torch.set_num_threads(2)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=2, rank=int(os.environ["RANK"]))
    rank = dist.get_rank()
    mesh = make_mesh(data=2)
    dp = DataParallel.of(mesh)
    out = {"data_index": mesh.data_index}
    for n_search, accum in CASES:
        cfg = _cfg_of(d, GRAD_ACCUM=accum)
        tm = _model(d)
        rec = _Recorder(tm)
        batch = shard_batch(mesh, _batch(d, n_search), accum)
        _, metrics = make_train_step(tm, rec, cfg, dp=dp)(TrainState(tm, rec), batch)
        out[f"n{n_search}_a{accum}"] = {
            "grads": rec.grads, "metrics": {k: float(v) for k, v in metrics.items()},
            "stats": {n: b.clone() for n, b in tm.named_buffers() if "running" in n}}

    # AdamW: replicated, then ZeRO-1 beside the replicated update of the same
    # gradients, two steps each from the same init
    cfg = _cfg_of(d)
    batch = shard_batch(mesh, _batch(d, 2))
    for name, zero1 in (("replicated", None), ("zero1", dp)):
        tm = _model(d)
        opt = build_optimizer(cfg, tm, 10, zero1=zero1)
        state = create_train_state(tm, opt)
        if zero1 is not None:
            follow = _model(d)
            state.optimizer = _Paired(tm, opt, follow, build_optimizer(cfg, follow, 10))
        step = make_train_step(tm, state.optimizer, cfg, dp=dp)
        runs, followed = [], []
        for i in range(2):
            state, m = step(state, batch)
            runs.append({n: p.detach().clone() for n, p in tm.named_parameters()})
            if zero1 is not None:
                followed.append({n: p.detach().clone() for n, p in follow.named_parameters()})
            if i == 0 and zero1 is not None:
                snap = TrainState(tm, opt, state.step).state_dict()  # every rank gathers
                if rank == 0:
                    torch.save(snap, d / "zero1_step1.pt")
        adamw = opt.adamw
        owned = [p for g in adamw.param_groups for p in g["params"]]
        shapes = {i: {k: tuple(v.shape) for k, v in adamw.state[p].items()
                      if k.startswith("exp_avg")} for i, p in enumerate(owned)}
        out[name] = {"params": runs, "followed": followed, "moment_shapes": shapes,
                     "moment_bytes": opt.moment_bytes(), "grad_norm": float(m["grad_norm"])}

    # the fail-safe: rank 1's loader raises at epoch 2's second batch, once
    from uvltrack_tpu_torch.train.trainer import Trainer

    class Loader:
        raised = False

        def __iter__(self):
            for i in range(3):
                if (rank == 1 and trainer.epoch == 2 and i == 1 and not Loader.raised):
                    Loader.raised = True
                    raise OSError("a read failed on rank 1")
                yield _batch(d, 2)

    tm = _model(d)
    state = create_train_state(tm, build_optimizer(cfg, tm, 3, zero1=dp))
    trainer = Trainer(cfg, make_train_step(tm, state.optimizer, cfg, dp=dp), state, Loader(),
                      checkpoint_dir=str(d / "trainer_ck"), log_path=str(d / "logs" / "run.log"),
                      to_device=lambda b: shard_batch(mesh, b), mesh=mesh)
    trainer.train(2)
    out["trainer"] = {"epoch": trainer.epoch, "step": trainer.state.step,
                      "params": {n: p.detach().clone() for n, p in tm.named_parameters()}}
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


WORKER = "import sys, test_torch_port_parallel as t; t._worker(sys.argv[1])"


# --------------------------------------------------- the JAX references
def _tree(x):
    return {k: _tree(v) for k, v in x.items()} if hasattr(x, "items") else np.asarray(x)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Starts the two dp=2 processes, computes the JAX references while
    they run, and returns both: per case JAX's gradients, metrics (with
    grad_norm) and BN stats of one step over the global batch (through
    optax.scale(1e6), tests/test_torch_port_train.py's GRAD_ACCUM reading),
    and the parameters after one AdamW step of jit_sharded_train_step on a
    2-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_port_model import _perturb
    from test_train_stack import micro_cfg, micro_model
    from uvltrack_tpu.data.synthetic import synthetic_batch
    from uvltrack_tpu.parallel.mesh import make_mesh as jmake_mesh
    from uvltrack_tpu.parallel.mesh import shard_batch as jshard_batch
    from uvltrack_tpu.train.optim import build_optimizer as jbuild_optimizer
    from uvltrack_tpu.train.step import (create_train_state, jit_sharded_train_step,
                                         make_train_step)
    from uvltrack_tpu_torch.models.convert import from_jax_variables

    d = tmp_path_factory.mktemp("dp")
    cfg, jm = micro_cfg(), micro_model()
    batches = {n: synthetic_batch(np.random.default_rng(n), 4, n_search=n, template_size=32,
                                  search_size=64, n_text=8, vocab=100) for n in (1, 2)}
    jb = {k: jnp.asarray(v) for k, v in batches[2].items()}
    v = jax.jit(lambda r: jm.init(
        r, jb["template_images"][0, :2], jb["search_images"][0, :2], jb["text"][0, :2],
        jb["text_mask"][0, :2], jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jb["flag"][:2], train=False))(jax.random.PRNGKey(0))
    v = _perturb(_tree(v), np.random.default_rng(0))
    torch.save(from_jax_variables(v["params"], v["batch_stats"]), d / "weights.pt")
    (d / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    for n, b in batches.items():
        np.savez(d / f"batch_n{n}.npz", **b)
    port = _free_port()
    env = dict(os.environ, MASTER_PORT=str(port), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(TESTS), str(REPO)]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(d)], cwd=str(REPO),
                              env=dict(env, RANK=str(r)), text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        refs = {}
        for n_search, accum in CASES:
            c = micro_cfg()
            c.TPU.GRAD_ACCUM = accum
            state = create_train_state({"params": v["params"],
                                        "batch_stats": v["batch_stats"]}, optax.scale(1e6))
            b = {k: jnp.asarray(x) for k, x in batches[n_search].items()}
            st, m = jax.jit(make_train_step(jm, optax.scale(1e6), c))(state, b)
            grads = jax.tree_util.tree_map(
                lambda a, p: (np.asarray(a, np.float64) - p) / 1e6, st.params, v["params"])
            refs[(n_search, accum)] = {
                "grads": from_jax_variables(_tree(grads), v["batch_stats"]),
                "metrics": {k: float(x) for k, x in m.items()},
                "stats": from_jax_variables(v["params"], _tree(st.batch_stats))}
        tx = jbuild_optimizer(cfg, v["params"], 10)
        mesh = jmake_mesh(data=2, model=1, devices=jax.devices()[:2])
        state = create_train_state({"params": v["params"], "batch_stats": v["batch_stats"]}, tx)
        step = jit_sharded_train_step(make_train_step(jm, tx, cfg), mesh, donate=False)
        st, _ = step(state, jshard_batch(mesh, jb))
        mesh_params = from_jax_variables(_tree(st.params), v["batch_stats"])
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    return dict(dir=d, refs=refs, mesh_params=mesh_params, ranks=ranks, cfg=cfg.to_dict())


def _grads_close(named, ref):
    for n, g in named.items():
        r = ref[n].float()
        bound = TOL * float(r.abs().max()) + GRAD_FLOOR
        err = float((g.float() - r).abs().max())
        assert err <= bound, (n, err, bound)


# ---------------------------------------------------------- dp=2 vs JAX
@pytest.mark.parametrize("n_search,accum", CASES)
def test_dp2_step_matches_jax_global_batch(dp_run, n_search, accum):
    """The dp=2 step's averaged gradients, grad_norm, global metrics and BN
    running stats against JAX's single step over the global batch (what
    the JAX mesh step computes by construction); both ranks hold the same."""
    import optax

    ref = dp_run["refs"][(n_search, accum)]
    r0, r1 = (r[f"n{n_search}_a{accum}"] for r in dp_run["ranks"])
    assert len(r0["grads"]) > 100 and set(r0["grads"]) <= set(ref["grads"])
    _grads_close(r0["grads"], ref["grads"])
    jnorm = float(optax.global_norm([np.asarray(ref["grads"][n], np.float64)
                                     for n in r0["grads"]]))
    np.testing.assert_allclose(r0["metrics"]["grad_norm"], jnorm, rtol=TOL, atol=TOL)
    for k, val in r0["metrics"].items():
        if k != "grad_norm":
            np.testing.assert_allclose(val, ref["metrics"][k], rtol=TOL, atol=TOL, err_msg=k)
    for n, b in r0["stats"].items():
        np.testing.assert_allclose(b.numpy(), ref["stats"][n].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=n)
    assert r0["metrics"] == r1["metrics"]
    for n in r0["grads"]:
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    for n in r0["stats"]:
        assert torch.equal(r0["stats"][n], r1["stats"][n]), n


def test_dp2_adamw_step_matches_the_jax_mesh_step(dp_run):
    """One AdamW step at dp=2 (replicated moments): the parameters of JAX's
    jit_sharded_train_step on make_mesh(data=2) over the same global batch,
    within 1e-6 (tests/test_torch_port_train.py's AdamW bound) plus what
    a gradient that rounds differently moves Adam's first step, whose
    update is about lr * g / |g|: rtol 1e-3 / atol 1e-4, the ZeRO-1 bound."""
    got = dp_run["ranks"][0]["replicated"]["params"][0]
    for n, p in got.items():
        np.testing.assert_allclose(p.numpy(), dp_run["mesh_params"][n].numpy(),
                                   rtol=Z1_RTOL, atol=Z1_ATOL, err_msg=n)
    moved = sum(int(not np.allclose(p.numpy(), dp_run["mesh_params"][n].numpy(), rtol=0,
                                    atol=1e-6)) for n, p in got.items())
    assert moved <= len(got) // 10, f"{moved} of {len(got)} parameters beyond 1e-6"


def test_zero1_matches_replicated_and_holds_half_the_moments(dp_run):
    """ZeRO-1 over 2 ranks: two steps' parameters within rtol 1e-3 / atol
    1e-4 of the replicated update of the same gradients (a second model
    beside it) and of the replicated run's; each rank holds at most half of
    every moment whose shape divides by 2 (all of it otherwise)."""
    for rank in dp_run["ranks"]:
        for a, b, c in zip(rank["zero1"]["params"], rank["zero1"]["followed"],
                           rank["replicated"]["params"]):
            for n in a:
                np.testing.assert_allclose(a[n].numpy(), b[n].numpy(), rtol=Z1_RTOL,
                                           atol=Z1_ATOL, err_msg=n)
                np.testing.assert_allclose(a[n].numpy(), c[n].numpy(), rtol=Z1_RTOL,
                                           atol=Z1_ATOL, err_msg=n)
        full = rank["replicated"]["moment_shapes"]
        part = rank["zero1"]["moment_shapes"]
        assert full.keys() == part.keys()
        split = 0
        for i, shapes in full.items():
            for k, shape in shapes.items():
                n_full, n_part = np.prod(shape), np.prod(part[i][k])
                if zero1_axis(shape, 2) is None:
                    assert n_part == n_full, (i, k)
                else:
                    assert 2 * n_part <= n_full, (i, k, shape, part[i][k])
                    split += 1
        assert split > 100
        assert 2 * rank["zero1"]["moment_bytes"] < 1.2 * rank["replicated"]["moment_bytes"]
    assert dp_run["ranks"][0]["zero1"]["grad_norm"] == dp_run["ranks"][1]["zero1"]["grad_norm"]


def test_zero1_checkpoint_holds_full_moments_and_resumes_at_dp1(dp_run):
    """The ZeRO-1 state after step 1, gathered by state_dict (a collective)
    and saved by rank 0, holds full-shape moments; loaded into a dp=1
    TrainState it takes the same step 2 on the global batch as the dp=2
    ZeRO-1 run."""
    from test_torch_port_train import _port_model
    from uvltrack_tpu_torch.models.convert import load_reference_state
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state, make_train_step

    d = dp_run["dir"]
    snap = torch.load(d / "zero1_step1.pt")
    tm = _port_model()
    load_reference_state(tm, torch.load(d / "weights.pt"))
    cfg = CfgNode(dp_run["cfg"])
    state = create_train_state(tm, build_optimizer(cfg, tm, 10))
    trained = [p for g in state.optimizer.adamw.param_groups for p in g["params"]]
    assert len(snap["optimizer"]["state"]) == len(trained)
    for i, st in snap["optimizer"]["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == trained[i].shape, i
    state.load_state_dict(snap)
    assert state.step == 1
    with np.load(d / "batch_n2.npz") as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    make_train_step(tm, state.optimizer, cfg)(state, batch)
    want = dp_run["ranks"][0]["zero1"]["params"][1]
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=Z1_RTOL,
                                   atol=Z1_ATOL, err_msg=n)


def test_trainer_fail_safe_when_one_rank_raises(dp_run):
    """Rank 1's loader raises once in epoch 2: both ranks abort the epoch,
    restart from the epoch-1 checkpoint and finish epoch 2 with equal
    parameters; rank 0 alone logged and wrote."""
    t0, t1 = (r["trainer"] for r in dp_run["ranks"])
    assert (t0["epoch"], t0["step"]) == (t1["epoch"], t1["step"]) == (2, 6)
    for n, p in t0["params"].items():
        assert torch.equal(p, t1["params"][n]), n
    log = (dp_run["dir"] / "logs" / "run.log").read_text()
    assert "epoch 2 crashed (retry 1)" in log and "a read failed on rank 1" not in log
    assert "restarted from epoch 1" in log and "[epoch 2/2]" in log
    assert sorted(os.listdir(dp_run["dir"] / "trainer_ck")) == ["ep0001.pt", "ep0002.pt"]


# ------------------------------------------------------ pure functions
def test_shard_batch_splits_the_global_batch_before_sharding():
    """With k microbatches, data index i keeps rows [j*B/k + i*B/(k n), ...)
    of each microbatch j: the JAX step's split-then-shard order; text
    (B, Nt) is cut on the batch axis, not the token axis."""
    from uvltrack_tpu_torch.parallel.mesh import Mesh
    from uvltrack_tpu_torch.train.step import _split_microbatches

    b = 8
    batch = {"search_images": np.arange(2 * b).reshape(2, b, 1, 1, 1),
             "text": np.arange(b * 3).reshape(b, 3), "flag": np.arange(b)}
    for k in (1, 2):
        rows = []
        for i in range(2):
            part = shard_batch(Mesh(2, 1, (torch.device("cpu"),), rank=i, world=2), batch, k)
            assert part["text"].shape == (b // 2, 3)
            micro = _split_microbatches({key: torch.from_numpy(x) for key, x in part.items()}, k)
            rows.append(micro["flag"].numpy())
            np.testing.assert_array_equal(part["search_images"][1, :, 0, 0, 0],
                                          part["flag"] + b)
            np.testing.assert_array_equal(part["text"][:, 0], part["flag"] * 3)
        for j in range(k):  # microbatch j of both ranks: the global microbatch j
            got = np.concatenate([r[j] for r in rows])
            np.testing.assert_array_equal(got, np.arange(j * b // k, (j + 1) * b // k))


def test_zero1_axis_is_the_jax_rule():
    """zero1_axis against zero1_moment_sharding on the shapes of
    tests/test_misc_helpers.py and on every parameter of the micro model:
    the same axis for the torch shape, and for its flax layout (the same
    parameter through from_jax_variables) the same choice of split or
    replicate and the same size of the split axis."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_train import _port_model
    from test_train_stack import micro_model
    from uvltrack_tpu.parallel.mesh import make_mesh as jmake_mesh
    from uvltrack_tpu.parallel.mesh import zero1_moment_sharding
    from uvltrack_tpu_torch.models.convert import from_jax_variables

    class A:
        def __init__(self, shape):
            self.shape, self.ndim = tuple(shape), len(shape)

    def jax_axis(mesh, shape):
        spec = zero1_moment_sharding(mesh, A(shape)).spec
        hits = [a for a, s in enumerate(spec) if s == "data"]
        return hits[0] if hits else None

    for n in (2, 8):
        mesh = jmake_mesh(data=n, model=1)
        for shape in ((96, 32), (4, 128), (3, 5), (), (768,), (2304, 768), (16, 3, 3, 8)):
            assert zero1_axis(shape, n) == jax_axis(mesh, shape), (shape, n)
    jm = micro_model()
    shapes = jax.eval_shape(lambda r: jm.init(
        r, jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), jnp.int32), jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jnp.zeros((2,), jnp.int32), train=False), jax.random.PRNGKey(0))
    # each flax leaf filled with its own index + 1, so the converted tensor names its leaf
    leaves, treedef = jax.tree_util.tree_flatten(shapes["params"])
    marked = treedef.unflatten([np.full(x.shape, i + 1, np.float32)
                                for i, x in enumerate(leaves)])
    stats = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   shapes["batch_stats"])
    named = from_jax_variables(marked, stats)
    mesh = jmake_mesh(data=2, model=1)
    checked = 0
    for name, p in _port_model().named_parameters():
        t = named[name]
        assert tuple(t.shape) == tuple(p.shape), name
        axis = zero1_axis(tuple(p.shape), 2)
        assert axis == jax_axis(mesh, tuple(p.shape)), name
        mark = torch.unique(t)
        if len(mark) != 1:  # not one flax leaf
            continue
        fs = tuple(leaves[int(mark[0]) - 1].shape)
        assert sorted(fs) == sorted(p.shape), (name, fs)  # a permutation of the axes
        faxis = jax_axis(mesh, fs)
        assert (faxis is None) == (axis is None), (name, fs)
        assert axis is None or fs[faxis] == p.shape[axis], (name, fs)
        checked += 1
    assert checked > 100


# ------------------------------------------------------ cli.train --multihost
def _cli_child(argv) -> None:
    """cli.train.main on the micro widths (test_torch_port_train._tiny_cli)
    as one rank of the torchrun environment the parent set."""
    from test_torch_port_train import _tiny_cli
    from uvltrack_tpu_torch.cli import train as ctrain

    torch.set_num_threads(2)
    trainer = ctrain.main(_tiny_cli(pytest.MonkeyPatch()) + argv)
    print(f"MH_DONE rank={os.environ['RANK']} step={trainer.state.step}", flush=True)


CLI_CHILD = "import sys, test_torch_port_parallel as t; t._cli_child(sys.argv[1:])"


def test_cli_train_multihost_two_processes_and_resume_at_dp1(tmp_path, monkeypatch):
    """cli.train --multihost --synthetic 2 in two gloo processes with
    TPU.MESH_DATA=2 and TPU.ZERO1=True (_smoke_cpu's GRAD_ACCUM=2, a global
    batch of 8): both exit 0, only rank 0 prints the epoch line and writes
    the log and the checkpoint, whose moments are full-shape and finite;
    then the single-process CLI resumes from it at dp=1 to epoch 2."""
    from test_torch_port_train import _tiny_cli
    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager
    from uvltrack_tpu_torch.train.optim import build_optimizer

    argv = ["--multihost", "--epochs", "1", "--save_dir", str(tmp_path),
            "--set", "TPU.MESH_DATA=2", "--set", "TPU.ZERO1=True"]
    outs = _spawn(CLI_CHILD, args=argv)
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, out[-4000:]
        assert f"MH_DONE rank={rank} step=2" in out
    assert "[epoch 1/1]" in outs[0][1] and "[epoch 1/1]" not in outs[1][1]
    ck = tmp_path / "checkpoints" / "train" / "uvltrack" / "_smoke_cpu"
    state, _, epoch = CheckpointManager(str(ck)).restore_raw()
    assert epoch == 1 and state["step"] == 2
    assert all(torch.isfinite(v).all() for v in state["model"].values() if v.is_floating_point())
    trainer1 = ctrain.main(_tiny_cli(monkeypatch) + ["--save_dir", str(tmp_path / "dp1"),
                                                     "--epochs", "1"])
    opt = build_optimizer(trainer1.cfg, trainer1.state.model, 2)
    trained = [p for g in opt.adamw.param_groups for p in g["params"]]
    moments = state["optimizer"]["state"]
    assert len(moments) == len(trained)
    for i, st in moments.items():
        assert st["exp_avg"].shape == trained[i].shape and torch.isfinite(st["exp_avg_sq"]).all()
    log = (tmp_path / "logs" / "uvltrack-_smoke_cpu.log").read_text()
    assert log.count("[epoch 1/1]") == 1
    t2 = ctrain.main(_tiny_cli(monkeypatch) + ["--save_dir", str(tmp_path), "--epochs", "2"])
    assert (t2.epoch, t2.state.step) == (2, 4)
    assert "resumed from epoch 1" in (tmp_path / "logs" / "uvltrack-_smoke_cpu.log").read_text()


# ------------------------------------------------------------ stream mesh
CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture(scope="module")
def tiny():
    """The tiny model of tests/test_torch_port_model.py: the JAX model, its
    variables, the port model on the same weights."""
    from test_torch_port_model import make_pair

    return make_pair(seed=3)


def _jcfg():
    from test_torch_port_batch import _cfg

    return _cfg()


def _frames(rng, n, h=80, w=100):
    return [rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8) for _ in range(n)]


def _jmesh():
    import jax

    from uvltrack_tpu.parallel.mesh import make_mesh as jmake_mesh

    return jmake_mesh(data=2, model=1, devices=jax.devices()[:2])


@pytest.mark.parametrize("S", [8, 5])
def test_batch_tracker_mesh_matches_unsharded_and_jax(tiny, S):
    """Two CPU replicas of S_pad/2 streams (S=5 pads to 6, a stream frozen):
    every step's boxes and scores against the unsharded port tracker and
    JAX's mesh BatchTracker (rtol 1e-5, atol 1e-4); step_many, the frame
    counters and step_many_cost's device stream count (S_pad)."""
    from uvltrack_tpu.track.batch import BatchTracker as JBatchTracker
    from uvltrack_tpu_torch.track.batch import BatchTracker

    jm, v, tm = tiny
    bt_m = BatchTracker(CfgNode(_jcfg().to_dict()), tm, S, mesh=make_mesh(devices=CPU2))
    bt_1 = BatchTracker(CfgNode(_jcfg().to_dict()), tm, S)
    jbt = JBatchTracker(_jcfg(), jm, v, S, mesh=_jmesh())
    assert bt_m.S_pad == jbt.S_pad == 2 * -(-S // 2) and [r.S for r in bt_m.replicas] == [
        bt_m.S_pad // 2] * 2
    rng = np.random.default_rng(3)
    frames = _frames(rng, S)
    boxes = np.tile([30.0, 20, 20, 24], (S, 1)).astype(np.float32)
    boxes[:, 0] += np.arange(S)
    for bt in (bt_m, bt_1, jbt):
        np.testing.assert_allclose(bt.initialize(frames, boxes), boxes)
    active = np.array([True] * (S - 1) + [S == 8])
    for bt in (bt_m, bt_1, jbt):
        bt.set_active(active)
    for _ in range(3):
        batch = np.stack(_frames(rng, S))
        out_m, out_1, out_j = bt_m.step(batch), bt_1.step(batch), jbt.step(batch)
        assert out_m.shape == (S, 5)
        np.testing.assert_allclose(out_m, out_1, **MESH_TOL)
        np.testing.assert_allclose(out_m, out_j, **MESH_TOL)
    block = np.stack([np.stack(_frames(rng, S)) for _ in range(2)])
    np.testing.assert_allclose(bt_m.step_many(block), bt_1.step_many(block), **MESH_TOL)
    np.testing.assert_array_equal(bt_m.state.frame_id, np.where(active, 5, 0))
    np.testing.assert_array_equal(bt_m.remines, bt_1.remines)
    cost = bt_m.step_many_cost(block)
    assert cost["streams"] == bt_m.S_pad
    assert cost["flops"] == bt_1.step_many_cost(block)["flops"] // S * bt_m.S_pad


def test_pool_mesh_matches_unsharded_and_jax(tiny):
    """tests/test_stream_pool.py's mesh scenario: capacity 5 over two CPU
    replicas (6 rows, the pad slot free and frozen); joins, a frozen round,
    a close and a slot reuse give the unsharded pool's and JAX's mesh
    pool's boxes."""
    from uvltrack_tpu.track.pool import StreamPool as JStreamPool
    from uvltrack_tpu_torch.track.pool import StreamPool

    jm, v, tm = tiny
    pm = StreamPool(CfgNode(_jcfg().to_dict()), tm, 5, mesh=make_mesh(devices=CPU2))
    p1 = StreamPool(CfgNode(_jcfg().to_dict()), tm, 5)
    pj = JStreamPool(_jcfg(), jm, v, capacity=5, mesh=_jmesh())
    assert pm.bt.S_pad == pj.bt.S_pad == 6
    rng = np.random.default_rng(ord("a"))
    f = {s: _frames(rng, 3) for s in "abc"}
    boxes = {"a": [30, 20, 20, 24], "b": [10, 10, 30, 30], "c": [40, 30, 25, 20]}
    pools = (pm, p1, pj)

    def check(outs, streams):
        for s in streams:
            for o in outs[1:]:
                np.testing.assert_allclose(outs[0][s]["bbox"], o[s]["bbox"], **MESH_TOL)
                np.testing.assert_allclose(outs[0][s]["score"], o[s]["score"], **MESH_TOL)

    for pool in pools:
        pool.open("a", f["a"][0], {"init_bbox": boxes["a"]})
        pool.open("b", f["b"][0], {"init_bbox": boxes["b"]})
    check([p.submit({"a": f["a"][1], "b": f["b"][1]}) for p in pools], "ab")
    outs = []
    for pool in pools:
        outs.append(pool.submit({"b": f["b"][2]}))
        pool.close("a")
        pool.open("c", f["c"][0], {"init_bbox": boxes["c"]})
    check(outs, "b")
    assert pm.slot_of == p1.slot_of == {"b": 1, "c": 0}
    check([p.submit({"c": f["c"][1], "b": f["b"][1]}) for p in pools], "bc")
    assert not pm.bt.replicas[1].state.active[-1]  # the pad slot never ran


def test_served_lockstep_mesh_matches_standalone(tiny):
    """cli/serve's --multichip path (make_server(lockstep=2, mesh=)): two
    streams over two CPU replicas, served concurrently, give a standalone
    port Tracker's and the JAX Tracker's boxes (rtol 1e-5, atol 1e-4):
    tests/test_serve.py's test_lockstep_mesh_matches_standalone."""
    from test_torch_port_serve import _npy_b64, _post, _start, _stop
    from uvltrack_tpu.track.tracker import Tracker as JTracker
    from uvltrack_tpu_torch.track.tracker import Tracker

    jm, v, tm = tiny
    proto = Tracker(CfgNode(_jcfg().to_dict()), tm)
    url, server = _start(proto, lockstep=2, batch_window=10.0, mesh=make_mesh(devices=CPU2))
    try:
        assert len(server.pool.bt.replicas) == 2
        rng = np.random.default_rng(11)
        first = _frames(rng, 1)[0]
        frames = {s: _frames(rng, 2) for s in "ab"}
        boxes0 = {"a": [30, 20, 20, 24], "b": [10, 10, 30, 30]}
        for s in "ab":
            _post(url, "/initialize", {"stream": s, "image": _npy_b64(first),
                                       "bbox": boxes0[s], "format": "npy"})
        results = {"a": [], "b": []}
        for i in range(2):
            errs = []

            def go(s, i=i):
                try:
                    results[s].append(_post(url, "/track", {
                        "stream": s, "image": _npy_b64(frames[s][i]), "format": "npy"}))
                except Exception as e:  # reported below
                    errs.append((s, e))

            ts = [threading.Thread(target=go, args=(s,)) for s in "ab"]
            [t.start() for t in ts]
            [t.join(timeout=120) for t in ts]
            assert not errs and not any(t.is_alive() for t in ts), errs
    finally:
        _stop(server)
    for s in "ab":
        t1, tj = Tracker(CfgNode(_jcfg().to_dict()), tm), JTracker(_jcfg(), jm, v)
        t1.initialize(first, {"init_bbox": list(boxes0[s])})
        tj.initialize(first, {"init_bbox": list(boxes0[s])})
        for got, f in zip(results[s], frames[s]):
            np.testing.assert_allclose(got["bbox"], t1.track(f)["target_bbox"], **MESH_TOL)
            np.testing.assert_allclose(got["bbox"], tj.track(f)["target_bbox"], **MESH_TOL)
