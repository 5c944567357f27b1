"""The batch of chip_smoke.py's B-TRAIN-REAL step-1 gate (its data group, part
(d)): uvltrack_tpu_torch/data/loader.py::first_batch draws the loader's
first batch in order by one thread worker, so one seed gives the same arrays
in every call (the config's TRAIN.NUM_WORKER threads spawn their generators
in the order they first draw, and gave another batch in each call); another
seed gives another batch, and the config is left as it was. On the fixture
trees of uvltrack_tpu_torch/tools/data_fixtures.py at 72x96 px with 32/64 px
crops; imports no JAX.
"""

import numpy as np
import pytest

FRAME_HW, IMAGE_HW = (72, 96), (60, 80)
BATCH = 4


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    """The default config on the fixture trees (the environment pointed at
    them), 32/64 px crops, 10 thread workers as the config has them."""
    from uvltrack_tpu_torch.config import default_cfg
    from uvltrack_tpu_torch.eval.environment import reset_env_cache
    from uvltrack_tpu_torch.tools.data_fixtures import vocab_words, write_trees

    root = tmp_path_factory.mktemp("trees")
    env = write_trees(root, seed=0, frame_hw=FRAME_HW, image_hw=IMAGE_HW, n_seq=3, n_frames=12)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + vocab_words()) + "\n")
    c = default_cfg()
    c.DATA.TEMPLATE.SIZE, c.DATA.SEARCH.SIZE = 32, 64
    c.DATA.SEARCH.NUMBER = 2
    c.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN = 8
    c.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH = str(vocab)
    c.TRAIN.NUM_WORKER = 10
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        reset_env_cache()
        yield c
    reset_env_cache()


def test_first_batch_is_the_same_for_one_seed_and_another_for_another(cfg):
    """Two draws from seed 0 equal array for array (flags included); seed 1
    gives other search images; the config keeps its 10 workers and epoch."""
    from uvltrack_tpu_torch.data.loader import first_batch

    epoch = int(cfg.DATA.TRAIN.SAMPLE_PER_EPOCH)
    a, b = first_batch(cfg, BATCH, seed=0), first_batch(cfg, BATCH, seed=0)
    assert sorted(a) == sorted(b) and a["flag"].shape == (BATCH,)
    assert a["search_images"].shape == (2, BATCH, 64, 64, 3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    other = first_batch(cfg, BATCH, seed=1)
    assert not np.array_equal(a["search_images"], other["search_images"])
    assert int(cfg.TRAIN.NUM_WORKER) == 10 and str(cfg.TPU.LOADER_WORKER_MODE) == "thread"
    assert int(cfg.DATA.TRAIN.SAMPLE_PER_EPOCH) == epoch


def test_first_batch_is_the_one_worker_loaders_first(cfg):
    """first_batch is the first batch build_train_loader yields at one
    thread worker: the loader's draw, not another sampler's."""
    from uvltrack_tpu_torch.data.loader import build_train_loader, first_batch

    one = cfg.clone()
    one.TRAIN.NUM_WORKER = 1
    one.DATA.TRAIN.SAMPLE_PER_EPOCH = 2 * BATCH
    want = next(iter(build_train_loader(one, BATCH, seed=3)))
    got = first_batch(cfg, BATCH, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
