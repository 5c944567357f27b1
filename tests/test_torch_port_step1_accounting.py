"""chip_smoke.py's per-row cell accounting of the train step-1 gates (B-TRAIN,
B-TRAIN-REAL, P-DP2, P-TP2): cell_accounting on constructed maps (no
differing row; a near-tie flip reported with its margins, which passes; a far
flip, whose gate raises after its line is printed), the near-tie rule shared
with paired_ab's AbTally, the bounds the gates keep, and probe_maps under the
step's parallel contexts: a tiny UVLTrack (C=32, 2 blocks, 4 heads, a 1-layer
BERT, 32/64 px crops, fp32, seeded init) on the plain backend in two gloo
processes on 127.0.0.1, at tp=2 x dp=1 (both ranks' maps bitwise equal, their
cells tp=1's) and at dp=2 (the gathered rows dp=1's, at 1 and 2 search
frames). chip_smoke.py is imported by its path; no JAX.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
CHILD_TIMEOUT = 600  # seconds a gloo process may take (~15 s alone)
ROWS, CELLS = 6, 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


def _maps(seed: int = 0) -> np.ndarray:
    """(ROWS, CELLS) positive maps, each row's maximum at least 20% above its
    second value (no near-tie of their own)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.05, 0.5, size=(ROWS, CELLS)).astype(np.float32)
    m[np.arange(ROWS), rng.integers(0, CELLS, size=ROWS)] = 0.8
    return m


def _flip(m: np.ndarray, row: int, cell: int, rel: float) -> np.ndarray:
    """m with `cell` of `row` raised to (1 + rel) x the row's maximum: the
    argmax moves there, the old maximum falls rel / (1 + rel) below it."""
    out = m.copy()
    out[row, cell] = (1 + rel) * m[row].max()
    return out


def test_identical_maps_give_no_differing_rows(cs):
    m = _maps()
    boxes = np.random.default_rng(1).uniform(size=(ROWS, 4))
    acc = cs.cell_accounting(m, m.copy(), boxes, boxes.copy())
    assert acc["rows"] == ROWS and acc["rows_differing"] == 0 and acc["differing"] == []
    assert acc["cells_a"] == acc["cells_b"] == m.argmax(1).tolist()
    assert acc["all_near_ties"] and acc["box_diff_max_same_cell"] == 0.0


def test_near_tie_flip_is_reported_with_its_margins_and_passes(cs):
    """Row 2's second cell raised to within 1% of its maximum on side b: the
    row is reported with both cells and both margins, a near-tie; the case
    passes; the same-cell rows' box difference is reported apart."""
    a = _maps()
    row = 2
    old = int(a[row].argmax())
    new = (old + 3) % CELLS
    a[row, new] = 0.995 * a[row].max()  # side a: the other cell 0.5% under the max
    b = _flip(a, row, new, 0.004)  # side b: it overtakes by 0.4%
    boxes_a = np.zeros((ROWS, 4))
    boxes_b = boxes_a + 1e-3
    acc = cs.cell_accounting(a, b, boxes_a, boxes_b)
    assert acc["rows_differing"] == 1 and acc["all_near_ties"]
    (r,) = acc["differing"]
    assert (r["row"], r["cell_a"], r["cell_b"], r["near_tie"]) == (row, old, new, True)
    assert r["margin_a"] == pytest.approx(0.005, rel=1e-4)
    assert r["margin_b"] == pytest.approx(0.004 / 1.004, rel=1e-4)
    assert acc["box_diff_max_same_cell"] == pytest.approx(1e-3)
    case = cs.step1_case({"loss": 5.0, "grad_norm": 10.0}, {"loss": 5.001, "grad_norm": 10.1},
                         acc, 0.05, ("plain", "cuda"))
    assert case["gate_passes"]
    cs.step1_gate(case, "near-tie")  # no raise


def test_far_flip_raises_after_its_line_is_printed(cs, capsys):
    """A row whose cell moves to one 30% under the maximum: not a near-tie,
    so the gate fails on it alone (loss and grad_norm equal), and
    step1_line prints the line, with the row's accounting, before it raises."""
    a = _maps()
    row = 4
    new = (int(a[row].argmax()) + 5) % CELLS
    b = _flip(a, row, new, 0.3)
    acc = cs.cell_accounting(a, b)
    assert acc["rows_differing"] == 1 and not acc["all_near_ties"]
    assert acc["differing"][0]["margin_b"] == pytest.approx(0.3 / 1.3, rel=1e-4)
    same = {"loss": 5.0, "grad_norm": 10.0}
    case = cs.step1_case(same, same, acc, 0.05, ("tp1", "tp2"))
    assert not case["gate_passes"] and case["loss_rel"] == case["grad_norm_rel"] == 0.0
    with pytest.raises(AssertionError, match="not near-ties"):
        cs.step1_line({"phase": "parallel_tp", "step1": {"fused_proj": case}}, "tp=2 vs tp=1")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["parallel_tp"]
    got = lines[0]["step1"]["fused_proj"]
    assert not got["gate_passes"] and got["cells"]["differing"][0]["row"] == row


@pytest.mark.parametrize("rel", [0.0, 0.01, 0.049, 0.051, 0.3])
def test_near_tie_rule_is_paired_abs(cs, rel):
    """One rule for tracking and training: cell_accounting calls a flip a
    near-tie exactly where AbTally (paired_ab's tally) passes it, at margins
    either side of AB_TIE."""
    a = _maps(2)[:1]
    old = int(a[0].argmax())
    new = (old + 1) % CELLS
    a[0, new] = a[0, old] * (1 - rel)  # side a: the other pick rel under the max
    b = a.copy()
    b[0, old], b[0, new] = a[0, new], a[0, old]  # side b: the two swapped
    if rel == 0.0:
        b[0, new] *= 1.0001  # a strict maximum on side b
    acc = cs.cell_accounting(a, b)
    tally = cs.AbTally("test")
    try:
        tally.add([0, 0, 1, 1], a[0], [0, 0, 1, 1], b[0], 100)
        ab_passes = True
    except AssertionError:
        ab_passes = False
    assert acc["rows_differing"] == 1
    assert acc["all_near_ties"] == ab_passes == (rel <= cs.AB_TIE)


def test_the_gates_keep_their_bounds(cs):
    """The step-1 bounds stay what they were (no gate loosened), and a case
    fails on the loss or the grad_norm alone as before."""
    assert (cs.TRAIN_LOSS_REL, cs.TRAIN_NORM_REL, cs.TRAIN_PROBE_EPS, cs.AB_TIE) == (
        1e-2, 5e-2, 2.0 ** -12, 0.05)
    m = _maps()
    acc = cs.cell_accounting(m, m)
    base = {"loss": 5.0, "grad_norm": 10.0}
    assert cs.step1_case({"loss": 5.049, "grad_norm": 10.0}, base, acc, 0.05)["gate_passes"]
    assert not cs.step1_case({"loss": 5.051, "grad_norm": 10.0}, base, acc, 0.05)["gate_passes"]
    assert not cs.step1_case({"loss": 5.0, "grad_norm": 10.6}, base, acc, 0.05)["gate_passes"]
    assert cs.step1_case({"loss": 5.0, "grad_norm": 10.6}, base, acc, 0.08)["gate_passes"]


# ---------------------------------------------------------------- gloo
def _model():
    from uvltrack_tpu_torch.models.bert import BertConfig
    from uvltrack_tpu_torch.models.head import MABH
    from uvltrack_tpu_torch.models.mufe import MUFE
    from uvltrack_tpu_torch.models.uvltrack import UVLTrack, init_model

    bert = BertConfig(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4,
                      intermediate_size=64, max_position=16)
    model = UVLTrack(MUFE(embed_dim=32, depth=2, num_heads=4, template_size=32, search_size=64,
                          fusion_layers=(1,), cont_loss_layers=(0, 1), txt_token_mode="cls",
                          bert=bert),
                     MABH(inplanes=32, channel=32, feat_sz=4, cls_tokenize=False,
                          softmax_one=True))
    return init_model(model, seed=0)


def _batch(n_search: int) -> dict:
    from uvltrack_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(np.random.default_rng(n_search), 4, n_search=n_search, template_size=32,
                        search_size=64, n_text=8, vocab=100)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _worker(d: str) -> None:
    """One of two gloo ranks: the tp=2 probe (data=1, model=2, this rank's
    slices) and the dp=2 probes (data=2, this rank's rows, gathered) at 1
    and 2 search frames, into rank<R>.npz (chip_smoke.save_probes)."""
    import torch.distributed as dist

    from uvltrack_tpu_torch.parallel import tp as tpar
    from uvltrack_tpu_torch.parallel.dp import DataParallel
    from uvltrack_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=2, rank=int(os.environ["RANK"]))
    cs = _chip_smoke()
    mesh = make_mesh(data=1, model=2)
    model = tpar.shard_params_tp(mesh, _model())
    out = {"tp": cs.probe_maps(model, _batch(2), "plain", tp=tpar.TensorParallel.of(mesh))}
    mesh = make_mesh(data=2, model=1)
    for n in (1, 2):
        out[f"dp{n}"] = cs.probe_maps(_model(), shard_batch(mesh, _batch(n)), "plain",
                                      dp=DataParallel.of(mesh))
    cs.save_probes(Path(d) / f"rank{dist.get_rank()}.npz", out)
    dist.destroy_process_group()


WORKER = "import sys; from test_torch_port_step1_accounting import _worker; _worker(sys.argv[1])"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(cs, tmp_path_factory):
    """Both ranks' probes (chip_smoke.load_probes of rank<R>.npz), the two
    gloo processes run once."""
    d = tmp_path_factory.mktemp("step1_ranks")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(TESTS), str(REPO)]))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(d)], cwd=str(REPO),
                              env=dict(env, RANK=str(r)), text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [cs.load_probes(d / f"rank{r}.npz") for r in range(2)]


def test_tp2_ranks_probe_bitwise_and_on_tp1s_cells(cs, ranks):
    """tp=2 x dp=1: both ranks' maps and boxes bitwise equal (the model
    group reduces every row-parallel output to the same sums), every row on
    tp=1's cell, the maps within fp32 rounding of tp=1's."""
    want = cs.probe_maps(_model(), _batch(2), "plain")
    got = ranks[0]["tp"]
    for k in ("maps", "boxes"):
        assert np.array_equal(got[k], ranks[1]["tp"][k]), k
    assert got["maps"].shape == want["maps"].shape == (8, CELLS)
    acc = cs.accounting_of(want, got)
    assert acc["rows_differing"] == 0, acc
    np.testing.assert_allclose(got["maps"], want["maps"], rtol=1e-4, atol=1e-6)
    assert acc["box_diff_max_same_cell"] < 1e-4


@pytest.mark.parametrize("n_search", [1, 2])
def test_dp2_gathered_probe_is_dp1s(cs, ranks, n_search):
    """dp=2: rank 0's gathered rows are the global batch's in dp=1's order
    (at one search frame the rotation pairs rows of the two ranks), on
    dp=1's cells, within fp32 rounding (BN's sums over the ranks)."""
    want = cs.probe_maps(_model(), _batch(n_search), "plain")
    got = ranks[0][f"dp{n_search}"]
    for k in ("maps", "boxes"):
        assert np.array_equal(got[k], ranks[1][f"dp{n_search}"][k]), k
    assert got["maps"].shape == want["maps"].shape == (4 * n_search, CELLS)
    acc = cs.accounting_of(want, got)
    assert acc["rows_differing"] == 0, acc
    np.testing.assert_allclose(got["maps"], want["maps"], rtol=1e-4, atol=1e-6)
