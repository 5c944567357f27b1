"""The port's training on real-data batches: one batch that the port's
sampler drew from a LaSOT-layout tree (a tracking, a grounding and a
vision-language sample) through the port's forward_and_loss against the JAX
package's on the micro model of tests/test_train_stack.py, and
cli.train.main --device cpu without --synthetic on
uvltrack_tpu_torch/tools/data_fixtures.py's trees (train, validate on the
three families, resume; a loader worker's exception; no card).

Tolerances, fp32 on the CPU, those of tests/test_torch_port_train.py:
loss and metrics within 1e-5 absolute and relative; every parameter's
gradient within 1e-5 of that parameter's largest |gradient| plus 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_port_train import _close, _grads_close, _port_model, _tb  # noqa: E402


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from uvltrack_tpu.eval.environment import reset_env_cache as jreset
    from uvltrack_tpu_torch.eval.environment import reset_env_cache
    from uvltrack_tpu_torch.tools.data_fixtures import vocab_words, write_trees

    root = tmp_path_factory.mktemp("trees")
    env = write_trees(root, seed=1, frame_hw=(72, 96), image_hw=(60, 80), n_seq=3, n_frames=12)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + vocab_words()) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        jreset()
        reset_env_cache()
        yield {"root": root, "vocab": str(vocab)}
    jreset()
    reset_env_cache()


def _real_batch(trees):
    """A frame-major batch of 4 LaSOT samples, flags 0, 1, 2, 0, drawn by
    the port's sampler on the micro config (32/64 px crops, 8 tokens)."""
    from test_train_stack import micro_cfg

    from uvltrack_tpu_torch.core.tokenizer import BertTokenizer
    from uvltrack_tpu_torch.data.builders import names2datasets
    from uvltrack_tpu_torch.data.loader import collate_frame_major
    from uvltrack_tpu_torch.data.processing import TrackProcessing
    from uvltrack_tpu_torch.data.sampler import GroundingAndTrackingSampler

    cfg = micro_cfg()
    (lasot,) = names2datasets(["LASOT"])
    s = GroundingAndTrackingSampler([lasot], None, 8, 200, TrackProcessing(cfg, seed=4),
                                    num_search_frames=2, tokenizer=BertTokenizer(trees["vocab"]),
                                    max_query_len=8, seed=4)
    draw = {0: s.sample_track, 1: s._sample_grounding, 2: s.sample_vl}
    samples = []
    for flag in (0, 1, 2, 0):
        out = None
        while out is None:  # a rejected crop or letterbox is drawn again
            out = draw[flag](lasot)
        samples.append(out)
    return collate_frame_major(samples)


def test_real_batch_forward_and_loss_and_every_gradient_match_jax(trees):
    """The three tasks' real crops (the grounding sample's letterboxed
    search image, zeros template) through both train steps' loss and its
    gradients, from the same perturbed variables."""
    import jax
    import jax.numpy as jnp

    from test_torch_port_model import _perturb
    from test_torch_port_train import _tree
    from test_train_stack import micro_cfg, micro_model
    from uvltrack_tpu.train.actor import forward_and_loss as jfwd
    from uvltrack_tpu_torch.config.cfgnode import CfgNode
    from uvltrack_tpu_torch.models.convert import from_jax_variables, load_reference_state
    from uvltrack_tpu_torch.train.actor import forward_and_loss

    batch = _real_batch(trees)
    assert batch["flag"].tolist() == [0, 1, 2, 0]
    assert batch["search_images"].shape == (2, 4, 64, 64, 3)
    assert (batch["template_images"][:, 1] == 0).all()  # grounding: zeros template
    assert batch["text_mask"][:, 1].sum() > 0
    cfg, jm = micro_cfg(), micro_model()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda r: jm.init(
        r, jb["template_images"][0, :2], jb["search_images"][0, :2], jb["text"][0, :2],
        jb["text_mask"][0, :2], jnp.zeros((2, 4), bool), jnp.zeros((2, 16), bool),
        jb["flag"][:2], train=False))(jax.random.PRNGKey(0))
    v = _perturb(_tree(v), np.random.default_rng(1))

    def loss_fn(params, bs, b):
        return jfwd(jm, {"params": params, "batch_stats": bs}, b, cfg, train=True)

    (jloss, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], jb)

    tm = _port_model()
    assert load_reference_state(tm, from_jax_variables(v["params"], v["batch_stats"])) == []
    loss, metrics = forward_and_loss(tm, _tb(batch), CfgNode(cfg.to_dict()), train=True)
    _close(loss, float(jloss))
    assert set(metrics) == set(jmetrics)
    for k, m in metrics.items():
        _close(m, np.asarray(jmetrics[k]))
    loss.backward()
    ref = from_jax_variables(_tree(jgrads), v["batch_stats"])
    named = {n: p.grad for n, p in tm.named_parameters()}
    assert set(named) <= set(ref) and len(named) > 100
    _grads_close(named, ref)


def _cli_argv(monkeypatch, trees, save_dir):
    """cli.train on _smoke_cpu.yaml (32/64 px crops, TPU.GRAD_ACCUM=2, the
    config's seven training and four validation datasets) at the micro
    widths, on the trees: 2 steps of 4 samples an epoch, 1 batch of each
    validation family."""
    from uvltrack_tpu_torch.models import bert as tbert
    from uvltrack_tpu_torch.models import uvltrack as tuv
    from uvltrack_tpu_torch.models.vit import VIT_VARIANTS

    monkeypatch.setitem(VIT_VARIANTS, "base", dict(embed_dim=32, depth=2, num_heads=4))
    monkeypatch.setattr(tuv, "bert_config_from_type", lambda t: tbert.BertConfig(
        hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, max_position=16))
    sets = ["MODEL.HIDDEN_DIM=32", "MODEL.HEAD.HEAD_DIM=32", "MODEL.BACKBONE.FUSION_LAYER=[1]",
            "MODEL.BACKBONE.CONT_LOSS_LAYER=[0,1]", "MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN=8",
            f"MODEL.BACKBONE.LANGUAGE.VOCAB_PATH={trees['vocab']}", "TRAIN.PRINT_INTERVAL=1",
            "TRAIN.NUM_WORKER=2", "DATA.TRAIN.SAMPLE_PER_EPOCH=8",
            "DATA.VALTRACK.SAMPLE_PER_EPOCH=4", "DATA.VALVL.SAMPLE_PER_EPOCH=4"]
    argv = ["--config", "_smoke_cpu", "--device", "cpu", "--batch_size", "4",
            "--save_dir", str(save_dir)]
    for s in sets:
        argv += ["--set", s]
    return argv


def test_cli_train_on_real_data_validates_and_resumes(monkeypatch, trees, tmp_path):
    from uvltrack_tpu_torch.cli import train as ctrain

    argv = _cli_argv(monkeypatch, trees, tmp_path)
    t1 = ctrain.main(argv + ["--epochs", "1"])
    assert t1.state.step == 2 and len(t1.train_loader) == 2
    assert set(t1.val_loaders) == {"valtrack", "valground", "valvl"}
    t2 = ctrain.main(argv + ["--epochs", "2"])
    assert t2.epoch == 2 and t2.state.step == 4
    ck = tmp_path / "checkpoints" / "train" / "uvltrack" / "_smoke_cpu"
    assert sorted(os.listdir(ck)) == ["ep0001.pt", "ep0002.pt"]
    log = tmp_path / "logs" / "uvltrack-_smoke_cpu.log"
    text = log.read_text()
    assert "resumed from epoch 1" in text
    recs = [json.loads(x) for x in (log.parent / (log.name + ".jsonl")).read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1, 2]
    for r in recs:
        assert set(r["val"]) == {"valtrack", "valground", "valvl"}
        assert all(np.isfinite(x) for x in r["train"].values())
        assert all(np.isfinite(x) for v in r["val"].values() for x in v.values())
        assert "Acc@0.5" in r["val"]["valground"]


def test_cli_train_stops_on_a_loader_worker_exception(monkeypatch, trees, tmp_path):
    """A sample that raises is not skipped: the worker's exception reaches
    the training loop, the Trainer's fail-safe restarts the epoch, and the
    run stops with the exception once its retries are spent."""
    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.data.sampler import GroundingAndTrackingSampler

    def boom(self, index=None):
        raise RuntimeError("a sample failed to load")

    monkeypatch.setattr(GroundingAndTrackingSampler, "__call__", boom)
    argv = _cli_argv(monkeypatch, trees, tmp_path)
    with pytest.raises(RuntimeError, match="a sample failed to load"):
        ctrain.main(argv + ["--epochs", "1"])
    text = (tmp_path / "logs" / "uvltrack-_smoke_cpu.log").read_text()
    assert "epoch 1 crashed (retry 10)" in text
    assert not (tmp_path / "checkpoints" / "train" / "uvltrack" / "_smoke_cpu").exists() or \
        not os.listdir(tmp_path / "checkpoints" / "train" / "uvltrack" / "_smoke_cpu")


def test_cli_train_without_a_card_stops_before_any_loader(monkeypatch, trees, tmp_path):
    from uvltrack_tpu_torch.cli import train as ctrain
    from uvltrack_tpu_torch.data import loader

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would train")
    started = []
    monkeypatch.setattr(loader, "build_train_loader", lambda *a, **k: started.append(a))
    monkeypatch.setattr(loader, "build_val_loaders", lambda *a, **k: started.append(a))
    argv = _cli_argv(monkeypatch, trees, tmp_path)
    i = argv.index("--device")
    del argv[i:i + 2]  # the default device, cuda
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctrain.main(argv)
    assert started == []
