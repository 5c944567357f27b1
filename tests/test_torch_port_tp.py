"""uvltrack_tpu_torch's tensor parallelism (parallel/tp.py, the train step's
tp=, train/optim.py's global norm and state dicts under it) against the JAX
package's dp x tp step, and the reference-format checkpoint writer.

Training runs on the micro model of tests/test_train_stack.py (C=32, 2
blocks, 4 heads: 2 a rank at tp=2, a 1-layer BERT, 32/64 px crops, fp32),
its JAX variables perturbed from a numpy seed and handed to the port
through from_jax_variables. One process group of four gloo processes on
127.0.0.1 (a free port, each under a communicate timeout) runs dp=2 x tp=2
(_worker: every case in the one group); the parent computes the JAX
references meanwhile. The JAX mesh step is one SPMD program, so the
gathered gradients are held to JAX's gradients of one step over the global
batch (optax.scale(1e6), as tests/test_torch_port_parallel.py reads them),
at n_search 1 (the rotation crosses data ranks) and 2, and one AdamW step
to jit_sharded_train_step(replicate_out=False) on make_mesh(data=2,
model=2) with shard_params_tp (four of the conftest's eight virtual CPU
devices). Tolerances are tests/test_torch_port_parallel.py's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_parallel import (CHILD_TIMEOUT, GRAD_FLOOR, TOL, Z1_ATOL, Z1_RTOL, _batch,
                                      _cfg_of, _free_port, _grads_close, _model, _Paired, _tree)
from uvltrack_tpu_torch.parallel import tp as tpar
from uvltrack_tpu_torch.parallel.mesh import make_mesh, shard_batch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
WORLD = 4  # dp=2 x tp=2
MICRO_SPLIT = 25  # leaves JAX's tp_spec_for splits in the micro model (2 blocks, 1 BERT layer)


class _Recorder:
    """An optimizer that records the gradients (after the data all_reduce)
    and returns the tensor-parallel global norm; it steps nothing."""

    def __init__(self, model, tp):
        self.model, self.tp = model, tp
        self.split = tpar.split_params(model)

    def step(self, step):
        from uvltrack_tpu_torch.train.optim import global_norm

        self.grads = {n: p.grad.clone() for n, p in self.model.named_parameters()}
        return global_norm([g for n, g in self.grads.items() if n not in self.split],
                           [g for n, g in self.grads.items() if n in self.split], self.tp)


def _gathered(tp, named: dict, split: dict) -> dict:
    return {n: (tp.gather(n, t, split[n]) if n in split else t.clone()) for n, t in named.items()}


def _snapshot(mesh, model) -> dict:
    """The gathered state, copied (a state dict shares the parameters' storage)."""
    return {k: v.clone() for k, v in tpar.gather_params_tp(mesh, model).items()}


def _worker(d: str) -> None:
    """One rank of the dp=2 x tp=2 group, its results in rank<R>.pt: the
    gathered gradients, metrics and local replicated gradients at n_search
    1 and 2; two AdamW steps (the state after step 1 checkpointed by rank
    0); two ZeRO-1 steps beside the replicated update of the same
    gradients (its state after step 1 checkpointed too); a Trainer epoch
    writing ep0001.pt."""
    import torch.distributed as dist

    from uvltrack_tpu_torch.parallel.dp import DataParallel
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import TrainState, create_train_state, make_train_step
    from uvltrack_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=WORLD, rank=int(os.environ["RANK"]))
    rank = dist.get_rank()
    mesh = make_mesh(data=2, model=2)
    dp, tp = DataParallel.of(mesh), tpar.TensorParallel.of(mesh)
    out = {"data_index": mesh.data_index, "model_index": mesh.model_index,
           "param_names": [n for n, _ in _model(d).named_parameters()]}

    def sharded():
        return tpar.shard_params_tp(mesh, _model(d))

    cfg = _cfg_of(d)
    for n_search in (1, 2):
        tm = sharded()
        rec = _Recorder(tm, tp)
        batch = shard_batch(mesh, _batch(d, n_search))
        _, metrics = make_train_step(tm, rec, cfg, dp=dp, tp=tp)(TrainState(tm, rec, tp=tp),
                                                                 batch)
        out[f"n{n_search}"] = {
            "grads": _gathered(tp, rec.grads, rec.split),
            "replicated": {n: g for n, g in rec.grads.items() if n not in rec.split},
            "shapes": {n: tuple(g.shape) for n, g in rec.grads.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "stats": {n: b.clone() for n, b in tm.named_buffers() if "running" in n}}

    batch = shard_batch(mesh, _batch(d, 2))
    for name, zero1 in (("adamw", None), ("zero1", dp)):
        tm = sharded()
        opt = build_optimizer(cfg, tm, 10, zero1=zero1, tp=tp)
        state = create_train_state(tm, opt, tp)
        follow = None
        if zero1 is not None:
            follow = sharded()
            state.optimizer = _Paired(tm, opt, follow, build_optimizer(cfg, follow, 10, tp=tp))
        step = make_train_step(tm, state.optimizer, cfg, dp=dp, tp=tp)
        runs, followed, norms = [], [], []
        for i in range(2):
            state, m = step(state, batch)
            norms.append(float(m["grad_norm"]))
            runs.append(_snapshot(mesh, tm))
            if follow is not None:
                followed.append(_snapshot(mesh, follow))
            if i == 0:
                snap = TrainState(tm, opt, state.step, tp).state_dict()  # every rank gathers
                if rank == 0:
                    torch.save(snap, d / f"{name}_step1.pt")
        out[name] = {"params": runs, "followed": followed, "grad_norms": norms,
                     "moment_bytes": opt.moment_bytes()}

    class Loader:
        def __iter__(self):
            for _ in range(2):
                yield _batch(d, 2)

    tm = sharded()
    state = create_train_state(tm, build_optimizer(cfg, tm, 2, zero1=dp, tp=tp), tp)
    trainer = Trainer(cfg, make_train_step(tm, state.optimizer, cfg, dp=dp, tp=tp), state,
                      Loader(), checkpoint_dir=str(d / "trainer_ck"),
                      log_path=str(d / "logs" / "run.log"),
                      to_device=lambda b: shard_batch(mesh, b), mesh=mesh)
    trainer.train(1)
    out["trainer"] = _snapshot(mesh, tm)
    torch.save(out, d / f"rank{rank}.pt")
    dist.destroy_process_group()


WORKER = "import sys, test_torch_port_tp as t; t._worker(sys.argv[1])"


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Starts the four dp=2 x tp=2 processes, computes the JAX references
    while they run, and returns both: per n_search JAX's gradients, metrics
    and BN stats of one step over the global batch, and the parameters and
    grad_norm of one AdamW step of jit_sharded_train_step on a 2 x 2 mesh
    with JAX's shard_params_tp."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from test_torch_port_model import _perturb
    from test_train_stack import micro_cfg, micro_model
    from uvltrack_tpu.data.synthetic import synthetic_batch
    from uvltrack_tpu.parallel.mesh import make_mesh as jmake_mesh
    from uvltrack_tpu.parallel.mesh import shard_batch as jshard_batch
    from uvltrack_tpu.parallel.tp import shard_params_tp as jshard_params_tp
    from uvltrack_tpu.train.optim import build_optimizer as jbuild_optimizer
    from uvltrack_tpu.train.step import (create_train_state, jit_sharded_train_step,
                                         make_train_step)
    from uvltrack_tpu_torch.models.convert import from_jax_variables

    d = tmp_path_factory.mktemp("tp")
    cfg, jm = micro_cfg(), micro_model()
    batches = {n: synthetic_batch(np.random.default_rng(10 + n), 4, n_search=n,
                                  template_size=32, search_size=64, n_text=8, vocab=100)
               for n in (1, 2)}
    jb = {k: jnp.asarray(x) for k, x in batches[2].items()}
    v = jax.jit(lambda r: jm.init(
        r, jb["template_images"][0, :2], jb["search_images"][0, :2], jb["text"][0, :2],
        jb["text_mask"][0, :2], jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jb["flag"][:2], train=False))(jax.random.PRNGKey(0))
    v = _perturb(_tree(v), np.random.default_rng(1))
    torch.save(from_jax_variables(v["params"], v["batch_stats"]), d / "weights.pt")
    (d / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    for n, b in batches.items():
        np.savez(d / f"batch_n{n}.npz", **b)
    env = dict(os.environ, MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(TESTS), str(REPO)]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(d)], cwd=str(REPO),
                              env=dict(env, RANK=str(r)), text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        refs = {}
        for n_search in (1, 2):
            state = create_train_state({"params": v["params"],
                                        "batch_stats": v["batch_stats"]}, optax.scale(1e6))
            b = {k: jnp.asarray(x) for k, x in batches[n_search].items()}
            st, m = jax.jit(make_train_step(jm, optax.scale(1e6), cfg))(state, b)
            grads = jax.tree_util.tree_map(
                lambda a, p: (np.asarray(a, np.float64) - p) / 1e6, st.params, v["params"])
            refs[n_search] = {
                "grads": from_jax_variables(_tree(grads), v["batch_stats"]),
                "metrics": {k: float(x) for k, x in m.items()},
                "stats": from_jax_variables(v["params"], _tree(st.batch_stats))}
        tx = jbuild_optimizer(cfg, v["params"], 10)
        mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
        state = create_train_state({"params": v["params"], "batch_stats": v["batch_stats"]}, tx)
        params = jshard_params_tp(mesh, state.params)
        state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))._replace(
            params=params)
        step = jit_sharded_train_step(make_train_step(jm, tx, cfg), mesh, replicate_out=False,
                                      donate=False)
        st, m = step(state, jshard_batch(mesh, jb))
        mesh_step = {"params": from_jax_variables(_tree(st.params), v["batch_stats"]),
                     "grad_norm": float(m["grad_norm"])}
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    return dict(dir=d, refs=refs, mesh_step=mesh_step, ranks=ranks, cfg=cfg.to_dict())


# ------------------------------------------------- dp=2 x tp=2 vs JAX
@pytest.mark.parametrize("n_search", (1, 2))
def test_tp_gradients_match_jax_global_batch(tp_run, n_search):
    """(a) Each rank's gradients, gathered through the model group, against
    JAX's one step over the global batch; the metrics and BN running stats
    too; every rank holds the same gathered gradients; (c) grad_norm (the
    split leaves summed over the model group) against JAX's global norm."""
    import optax

    ref = tp_run["refs"][n_search]
    runs = [r[f"n{n_search}"] for r in tp_run["ranks"]]
    r0 = runs[0]
    assert set(r0["grads"]) <= set(ref["grads"]) and len(r0["grads"]) > 100
    for n, g in r0["grads"].items():
        assert tuple(g.shape) == tuple(ref["grads"][n].shape), n
    _grads_close(r0["grads"], ref["grads"])
    jnorm = float(optax.global_norm([np.asarray(ref["grads"][n], np.float64)
                                     for n in r0["grads"]]))
    for r in runs:
        np.testing.assert_allclose(r["metrics"]["grad_norm"], jnorm, rtol=TOL, atol=TOL)
    for k, val in r0["metrics"].items():
        if k != "grad_norm":
            np.testing.assert_allclose(val, ref["metrics"][k], rtol=TOL, atol=TOL, err_msg=k)
    for n, b in r0["stats"].items():
        np.testing.assert_allclose(b.numpy(), ref["stats"][n].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=n)
    for r in runs[1:]:
        for n in r0["grads"]:
            torch.testing.assert_close(r["grads"][n], r0["grads"][n], rtol=TOL, atol=GRAD_FLOOR,
                                       msg=n)
    # each rank held its slice: half of every split leaf
    split = [n for n, s in r0["shapes"].items() if s != tuple(r0["grads"][n].shape)]
    assert len(split) == MICRO_SPLIT
    for n in split:
        assert np.prod(r0["shapes"][n]) * 2 == r0["grads"][n].numel(), n


@pytest.mark.parametrize("n_search", (1, 2))
def test_replicated_gradients_equal_across_model_ranks(tp_run, n_search):
    """(d) Every replicated parameter's gradient (LN, embeddings, the head's
    towers and BN, logit_scale, the row-parallel biases) is the same on the
    two model ranks of each data index."""
    ranks = tp_run["ranks"]
    for a, b in ((0, 1), (2, 3)):
        assert (ranks[a]["data_index"], ranks[a]["model_index"]) == (a // 2, 0)
        assert (ranks[b]["data_index"], ranks[b]["model_index"]) == (b // 2, 1)
        ga, gb = (ranks[i][f"n{n_search}"]["replicated"] for i in (a, b))
        assert len(ga) > 80 and ga.keys() == gb.keys()
        assert "box_head.prompter.mlp.fc2.bias" in ga
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n


def test_tp_adamw_step_matches_the_jax_dp_tp_mesh_step(tp_run):
    """(b) One AdamW step at dp=2 x tp=2, the parameters gathered: JAX's
    jit_sharded_train_step(replicate_out=False) on make_mesh(data=2,
    model=2) with shard_params_tp, within the bound of
    test_dp2_adamw_step_matches_the_jax_mesh_step (rtol 1e-3 / atol 1e-4,
    at most a tenth of the parameters beyond 1e-6); (c) its grad_norm
    against the JAX mesh step's. Adam's first step moves an element by
    about lr * g / (|g| + 1e-8): where JAX's gradient of the same global
    batch is within test (a)'s gradient tolerance of zero, its sign is not
    pinned by (a), and the two updates may differ by up to 2 lr."""
    want = tp_run["mesh_step"]
    grads = tp_run["refs"][2]["grads"]  # the AdamW step's global batch
    lr = float(tp_run["cfg"]["TRAIN"]["LR"])
    for r in tp_run["ranks"]:
        got = r["adamw"]["params"][0]
        np.testing.assert_allclose(r["adamw"]["grad_norms"][0], want["grad_norm"], rtol=TOL,
                                   atol=TOL)
        checked = 0
        for n in r["param_names"]:
            p = got[n]
            w, g = want["params"][n].double(), grads[n].double()
            unpinned = g.abs() <= TOL * float(g.abs().max()) + GRAD_FLOOR
            bound = torch.where(unpinned, 2 * lr + Z1_ATOL, Z1_ATOL + Z1_RTOL * w.abs())
            excess = float(((p.double() - w).abs() - bound).max())
            assert excess <= 0, (n, excess, int(unpinned.sum()))
            checked += 1
        assert checked > 100
        moved = sum(int(not np.allclose(got[n].numpy(), want["params"][n].numpy(), rtol=0,
                                        atol=1e-6)) for n in r["param_names"])
        assert moved <= checked // 10, f"{moved} of {checked} parameters beyond 1e-6"


def test_zero1_under_tp_matches_the_replicated_update(tp_run):
    """(e) ZeRO-1 over the data axis of dp=2 x tp=2: two steps' gathered
    parameters against the replicated update of the same gradients (a
    second split model beside it), bitwise, within rtol 1e-3 / atol 1e-4 of
    the replicated run; each rank's moments at most ~half the replicated
    run's."""
    for r in tp_run["ranks"]:
        for a, b, c in zip(r["zero1"]["params"], r["zero1"]["followed"], r["adamw"]["params"]):
            for n in r["param_names"]:
                assert torch.equal(a[n], b[n]), n
                np.testing.assert_allclose(a[n].numpy(), c[n].numpy(), rtol=Z1_RTOL,
                                           atol=Z1_ATOL, err_msg=n)
        assert 2 * r["zero1"]["moment_bytes"] < 1.2 * r["adamw"]["moment_bytes"]
    norms = {r["zero1"]["grad_norms"][0] for r in tp_run["ranks"]}
    assert len(norms) == 1


@pytest.mark.parametrize("name", ("adamw", "zero1"))
def test_tp_checkpoint_resumes_at_tp1(tp_run, name):
    """(f) The dp=2 x tp=2 state after step 1 (replicated moments, and
    ZeRO-1), gathered by TrainState.state_dict (a collective) and saved by
    rank 0: whole tensors equal to the gathered parameters; loaded into a
    tp=1, dp=1 TrainState it takes the same step 2 on the global batch."""
    from test_torch_port_train import _port_model
    from uvltrack_tpu_torch.config import CfgNode
    from uvltrack_tpu_torch.models.convert import load_reference_state
    from uvltrack_tpu_torch.train.optim import build_optimizer
    from uvltrack_tpu_torch.train.step import create_train_state, make_train_step

    d = tp_run["dir"]
    snap = torch.load(d / f"{name}_step1.pt")
    step1 = tp_run["ranks"][0][name]["params"][0]
    for n, p in step1.items():
        assert torch.equal(snap["model"][n], p), n
    tm = _port_model()
    load_reference_state(tm, torch.load(d / "weights.pt"))
    cfg = CfgNode(tp_run["cfg"])
    state = create_train_state(tm, build_optimizer(cfg, tm, 10))
    trained = [p for g in state.optimizer.adamw.param_groups for p in g["params"]]
    for i, st in snap["optimizer"]["state"].items():
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == trained[i].shape, i
    state.load_state_dict(snap)
    assert state.step == 1
    make_train_step(tm, state.optimizer, cfg)(state, _batch(d, 2))
    want = tp_run["ranks"][0][name]["params"][1]
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=Z1_RTOL,
                                   atol=Z1_ATOL, err_msg=n)


def test_trainer_checkpoint_under_tp_holds_whole_tensors(tp_run):
    """The Trainer's ep0001.pt under dp=2 x tp=2 (ZeRO-1): written by rank 0
    alone, its model the gathered parameters bitwise, every moment whole."""
    from uvltrack_tpu_torch.train.checkpoint import CheckpointManager

    state, _, epoch = CheckpointManager(str(tp_run["dir"] / "trainer_ck")).restore_raw()
    assert epoch == 1 and state["step"] == 2
    want = tp_run["ranks"][0]["trainer"]
    for n, p in want.items():
        assert torch.equal(state["model"][n], p), n
    for r in tp_run["ranks"][1:]:
        for n, p in r["trainer"].items():
            assert torch.equal(p, want[n]), n
    shapes = {tuple(p.shape) for p in want.values()}
    for st in state["optimizer"]["state"].values():
        assert tuple(st["exp_avg"].shape) in shapes


# ------------------------------------------------------ no process group
def _jax_leaves_through_rules(jm_init, depth: int, n_bert: int):
    """Every parameter through uvltrack_rules: {port name: its torch shape}
    and {port name: torch dim} of the leaves JAX's tp_spec_for splits, from
    the variable shapes of a JAX model (no weights are made)."""
    import jax

    from uvltrack_tpu.parallel.tp import _path_str
    from uvltrack_tpu.parallel.tp import tp_spec_for as jtp_spec_for
    from uvltrack_tpu_torch.models.convert import _t_conv, _t_linear, state_key, uvltrack_rules

    shapes = jax.eval_shape(jm_init, jax.random.PRNGKey(0))["params"]
    leaves = {_path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    rules, _ = uvltrack_rules(depth, n_bert)
    assert len(rules) == len(leaves)
    port, split = {}, {}
    for src, dst, tf in rules:
        path = "/".join(dst)
        shape = tuple(leaves[path].shape)
        name = state_key(src)
        port[name] = (shape[::-1] if tf is _t_linear else
                      tuple(shape[i] for i in (3, 2, 0, 1)) if tf is _t_conv else shape)
        axes = [a for a, s in enumerate(tuple(jtp_spec_for(path, leaves[path]))) if s == "model"]
        if axes:
            split[name] = 1 - axes[0] if tf is _t_linear else axes[0]
    return port, split


@pytest.mark.parametrize("config", ("micro", "baseline_base", "baseline_large"))
def test_tp_spec_for_selects_jax_leaves(config):
    """tp_spec_for on the port's names against JAX's tp_spec_for on the flax
    paths, leaf for leaf through uvltrack_rules, at UVLTrack-B's and -L's
    widths and depths and on the micro model: the same leaves split (the
    head's prompter MLP included), column-parallel on torch dim 0 and
    row-parallel on dim 1."""
    import jax.numpy as jnp

    from test_train_stack import micro_model

    if config == "micro":
        jm = micro_model()
        init = (lambda r: jm.init(
            r, jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 64, 64, 3)),
            jnp.zeros((2, 8), jnp.int32), jnp.ones((2, 8), jnp.int32),
            jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool), jnp.zeros((2,), jnp.int32),
            train=False))
        depth, n_bert = 2, 1
    else:
        from uvltrack_tpu.config import load_cfg
        from uvltrack_tpu.models.uvltrack import build_model, init_model

        cfg = load_cfg(str(REPO / "experiments" / "uvltrack" / f"{config}.yaml"))
        jm = build_model(cfg)
        init = (lambda r: init_model(jm, cfg, r))
        depth = 12 if config == "baseline_base" else 24
        n_bert = min(cfg.MODEL.BACKBONE.FUSION_LAYER)
    port, want = _jax_leaves_through_rules(init, depth, n_bert)
    got = {n: d for n, shape in port.items() if (d := tpar.tp_spec_for(n, shape)) is not None}
    assert got == want
    assert len(got) == 6 * depth + 10 * n_bert + 3
    assert {k: got[k] for k in got if "prompter" in k} == {
        "box_head.prompter.mlp.fc1.weight": 0, "box_head.prompter.mlp.fc1.bias": 0,
        "box_head.prompter.mlp.fc2.weight": 1}


def test_split_params_of_the_port_model_are_the_micro_leaves():
    """On a built port model (the micro widths) split_params names the 25
    leaves JAX splits, none of the buffers; the row-parallel biases, norms,
    embeddings and the 4-D patch embedding stay replicated."""
    from test_torch_port_train import _port_model

    split = tpar.split_params(_port_model())
    assert len(split) == MICRO_SPLIT
    assert split["backbone.vit.blocks.1.attn.qkv.weight"] == 0
    assert split["backbone.vit.blocks.1.attn.proj.weight"] == 1
    assert split["backbone.bert.encoder.layer.0.attention.output.dense.weight"] == 1
    assert split["backbone.bert.encoder.layer.0.intermediate.dense.bias"] == 0
    for name in ("backbone.vit.blocks.0.attn.proj.bias", "backbone.vit.blocks.0.mlp.fc2.bias",
                 "backbone.vit.blocks.0.norm1.weight", "backbone.vit.patch_embed.proj.weight",
                 "backbone.bert.embeddings.word_embeddings.weight", "box_head.logit_scale",
                 "box_head.conv_cls.0.0.weight"):
        assert name not in split


@pytest.mark.parametrize("size", (2, 4))
def test_shard_then_merge_is_the_identity(size):
    """Every split leaf of the micro model, cut into `size` slices by
    shard_tensor and merged back by merge_tensor: bitwise the whole tensor."""
    from test_torch_port_train import _port_model

    tm = _port_model()
    params = dict(tm.named_parameters())
    for n, dim in tpar.split_params(tm).items():
        t = params[n].detach()
        parts = [tpar.shard_tensor(n, t, dim, size, i) for i in range(size)]
        assert all(p.shape[dim] * size == t.shape[dim] for p in parts), n
        assert torch.equal(tpar.merge_tensor(n, parts, dim), t), n


@pytest.mark.parametrize("size", (2, 4))
def test_qkv_rows_split_per_head(size):
    """Rank r's rows of a (3C, C) qkv weight are q, k and v of its heads
    r*H/tp .. (r+1)*H/tp - 1, in that order (Megatron's layout), and its
    bias the same rows; JAX's contiguous split is only a layout."""
    heads, hd = 4, 8
    c = heads * hd
    w = torch.arange(3 * c, dtype=torch.float32)[:, None].expand(3 * c, c).clone()
    for r in range(size):
        got = tpar.shard_tensor("backbone.vit.blocks.0.attn.qkv.weight", w, 0, size, r)[:, 0]
        bias = tpar.shard_tensor("backbone.vit.blocks.0.attn.qkv.bias", w[:, 0], 0, size, r)
        per = heads // size
        want = torch.cat([torch.arange(part * c + r * per * hd, part * c + (r + 1) * per * hd)
                          for part in range(3)]).float()
        assert torch.equal(got, want) and torch.equal(bias, want)


def test_shard_params_tp_refuses_what_it_cannot_split():
    """Heads that do not divide, a model split twice, int8 weights and a
    text_proj (BERT width != ViT width) are refused, naming the cause."""
    from test_torch_port_train import _port_model
    from uvltrack_tpu_torch.models.bert import BertConfig
    from uvltrack_tpu_torch.models.head import MABH
    from uvltrack_tpu_torch.models.mufe import MUFE
    from uvltrack_tpu_torch.models.uvltrack import UVLTrack
    from uvltrack_tpu_torch.ops.quant import quantize_vit_params

    with pytest.raises(ValueError, match="heads do not split 3"):
        tpar.shard_params_tp(tpar.TensorParallel(3, 0), _port_model())
    tm = tpar.shard_params_tp(tpar.TensorParallel(2, 1), _port_model())
    assert tm.backbone.vit.blocks[0].attn.num_heads == 2
    assert tm.backbone.bert.encoder.layer[0].heads == 2
    with pytest.raises(ValueError, match="already split"):
        tpar.shard_params_tp(tpar.TensorParallel(2, 1), tm)
    q = _port_model()
    quantize_vit_params(q, min_dim=1)
    with pytest.raises(ValueError, match="int8"):
        tpar.shard_params_tp(tpar.TensorParallel(2, 0), q)
    bert = BertConfig(vocab_size=100, hidden_size=64, num_layers=1, num_heads=4,
                      intermediate_size=64, max_position=16)
    wide = UVLTrack(MUFE(embed_dim=32, depth=2, num_heads=4, template_size=32, search_size=64,
                         fusion_layers=(1,), cont_loss_layers=(0, 1), txt_token_mode="cls",
                         bert=bert),
                    MABH(inplanes=32, channel=32, feat_sz=4, cls_tokenize=False,
                         softmax_one=True))
    assert tpar.tp_spec_for("backbone.text_proj.weight", (32, 64)) == 1
    with pytest.raises(ValueError, match="text_proj"):
        tpar.shard_params_tp(tpar.TensorParallel(2, 0), wide)


# ------------------------------------------------- the kernel route at H/tp
def _meta(shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.fixture
def spied_launches(monkeypatch):
    """The kernel gates open for meta tensors (which take the wrappers' card
    branch); each launch is recorded as (kernel, instantiation), not run."""
    from uvltrack_tpu_torch.ops import attention as tattn
    from uvltrack_tpu_torch.ops import build
    from uvltrack_tpu_torch.ops import ln_mlp as lm
    from uvltrack_tpu_torch.ops import ln_qkv_attention as lqa
    from uvltrack_tpu_torch.ops import ln_qkv_attn_proj as lqp

    monkeypatch.setattr(tattn, "_BACKEND", "cuda")
    monkeypatch.setattr(tattn, "_on_card", lambda t: True)
    for k in ("UVLTRACK_FUSED_PROJ", "UVLTRACK_FUSED_MLP", "UVLTRACK_FUSED_PREFIX",
              "UVLTRACK_PALLAS_MIN_N"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    for mod in (lqa, lqp, lm):
        monkeypatch.setattr(mod, "check_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "launch", lambda kernel, inst, *a, **k: calls.append(
        (kernel, inst)))
    return calls


@pytest.mark.parametrize("c,heads,tp", [(768, 12, 2), (768, 12, 4), (1024, 16, 2)])
def test_a_ranks_block_reaches_the_kernels_at_its_shapes(c, heads, tp, spied_launches,
                                                        monkeypatch):
    """A tensor-parallel rank's ViT block on the kernel route at B-TRAIN's
    shapes (under autograd): ln_qkv with its 3C/tp rows and qkv_attention at
    H/tp heads; under UVLTRACK_FUSED_PROJ=1 the projection's share on
    proj_residual's fp32-x instantiation (a zero fp32 stream, K = C/tp);
    under UVLTRACK_FUSED_MLP=1 ln_mlp with fc2's fp32 out (F = 4C/tp); every
    input gets its gradient. The parent's ln_qkv refused any W but (3C, C)."""
    from uvltrack_tpu_torch.ops import attention as tattn

    b16, f32 = torch.bfloat16, torch.float32
    x = _meta((16, 321, c), b16, grad=True)
    ln = [_meta((c,), grad=True) for _ in range(2)]
    wq, bq = _meta((3 * c // tp, c), b16, grad=True), _meta((3 * c // tp,), grad=True)
    wp = _meta((c, c // tp), b16, grad=True)
    bias = torch.zeros((16, 1, 1, 321), device="meta")
    monkeypatch.setenv("UVLTRACK_FUSED_PROJ", "1")
    attn = tattn.attention_ln_qkv_core(x, *ln, wq, bq, heads // tp, bias, compute_dtype=b16)
    part, rounding = tattn.attn_proj_partial_core(x, attn, wp, bias, b16)
    assert spied_launches == [("ln_qkv", "bf16x-bf16w"), ("qkv_attention", "bf16"),
                              ("proj_residual", "fp32x-bf16a-bf16w")]
    assert attn.shape == (16, 321, c // tp) and part.shape == x.shape
    assert part.dtype == f32 and rounding == b16
    spied_launches.clear()
    monkeypatch.setenv("UVLTRACK_FUSED_MLP", "1")
    w1, b1 = _meta((4 * c // tp, c), b16, grad=True), _meta((4 * c // tp,), grad=True)
    w2 = _meta((c, 4 * c // tp), b16, grad=True)
    mlp = tattn.ln_mlp_partial_core(x, *ln, w1, b1, w2, compute_dtype=b16)
    assert spied_launches == [("ln_mlp", "bf16x-bf16w-fp32o")]
    assert mlp.shape == x.shape and mlp.dtype == f32
    (part.sum() + mlp.sum()).backward()
    for t in (x, *ln, wq, bq, wp, w1, b1, w2):
        assert t.grad is not None and t.grad.shape == t.shape


# ------------------------------------------- the reference-format writer
def test_save_torch_checkpoint_writes_the_jax_file(tmp_path):
    """The port's save_torch_checkpoint from a model loaded through
    from_jax_variables writes what the JAX package's save_torch_checkpoint
    writes from the same variables: the same keys, values and dtypes, and
    'epoch'; the port's load_torch_file and cli/test.py's checkpoint_state
    read it back."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_model import _perturb
    from test_torch_port_train import _port_model
    from test_train_stack import micro_model
    from uvltrack_tpu.models.convert import save_torch_checkpoint as jsave
    from uvltrack_tpu_torch.cli.test import checkpoint_state
    from uvltrack_tpu_torch.models.convert import (from_jax_variables, load_reference_state,
                                                   load_torch_file, save_torch_checkpoint)

    jm = micro_model()
    v = jax.jit(lambda r: jm.init(
        r, jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), jnp.int32), jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jnp.zeros((2,), jnp.int32), train=False))(jax.random.PRNGKey(3))
    v = _perturb(_tree(v), np.random.default_rng(3))
    jsave(str(tmp_path / "jax.pth.tar"), v["params"], v["batch_stats"], epoch=7)
    tm = _port_model()
    assert load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"])) == []
    save_torch_checkpoint(str(tmp_path / "port.pth.tar"), tm, 7)
    want = torch.load(tmp_path / "jax.pth.tar", weights_only=False)
    got = torch.load(tmp_path / "port.pth.tar", weights_only=False)
    assert got.keys() == want.keys() == {"net", "epoch"} and got["epoch"] == want["epoch"] == 7
    assert got["net"].keys() == want["net"].keys()
    for k, t in want["net"].items():
        assert got["net"][k].dtype == t.dtype and torch.equal(got["net"][k], t), k
    # a state dict writes the same file; the readers take it back
    save_torch_checkpoint(str(tmp_path / "state.pth.tar"), tm.state_dict(), 7)
    again = torch.load(tmp_path / "state.pth.tar", weights_only=False)
    assert all(torch.equal(again["net"][k], t) for k, t in want["net"].items())
    loaded = load_torch_file(str(tmp_path / "port.pth.tar"))
    assert loaded.keys() == want["net"].keys()
    state = checkpoint_state(str(tmp_path / "port.pth.tar"))
    fresh = _port_model()
    assert load_reference_state(fresh, state) == []
    for n, p in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[n], p), n


def test_save_torch_checkpoint_upcasts_bf16_and_refuses_text_proj(tmp_path):
    """A bf16 model's file holds fp32 tensors (the JAX writer upcasts bf16
    trees), and a model with text_proj is refused, as the JAX writer
    refuses it."""
    from test_torch_port_train import _port_model
    from uvltrack_tpu_torch.models.convert import save_torch_checkpoint

    tm = _port_model()
    save_torch_checkpoint(str(tmp_path / "f32.pth.tar"), tm, 1)
    tm16 = _port_model().to(torch.bfloat16)
    tm16.load_state_dict(tm.state_dict())
    save_torch_checkpoint(str(tmp_path / "bf16.pth.tar"), tm16, 1)
    net = torch.load(tmp_path / "bf16.pth.tar", weights_only=False)["net"]
    assert all(t.dtype != torch.bfloat16 for t in net.values())
    with pytest.raises(ValueError, match="text_proj"):
        save_torch_checkpoint(str(tmp_path / "x.pth.tar"),
                              {**tm.state_dict(), "backbone.text_proj.weight": torch.zeros(1)}, 1)


def test_box_xyxy_to_xywh_matches_jax():
    """box_xyxy_to_xywh against the JAX package's (core/box_ops.py:20) on
    seeded boxes with leading dims, and the round trip with xywh_to_xyxy."""
    import jax.numpy as jnp

    from uvltrack_tpu.core import box_ops as jbox
    from uvltrack_tpu_torch.core import box_ops

    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, size=(3, 7, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(1, 50, size=(3, 7, 2))], -1).astype(np.float32)
    got = box_ops.box_xyxy_to_xywh(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbox.box_xyxy_to_xywh(jnp.asarray(boxes))))
    back = box_ops.box_xywh_to_xyxy(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, boxes, rtol=0, atol=1e-5)
