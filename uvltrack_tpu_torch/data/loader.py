"""Prefetching loader producing frame-major numpy batches.

Replaces LTRLoader (lib/train/data/loader.py:124-194): the stack_dim=1
collate becomes an explicit frame-major np.stack on axis 1; dataloader
workers are a thread pool (cv2 decode releases the GIL) or, with
TPU.LOADER_WORKER_MODE=process, a process pool. Workers run numpy and cv2
only: the sampler holds no tensor and a process worker never touches
torch.cuda. The batches stay on the host; cli/train uploads them.

The port's own copy of uvltrack_tpu/data/loader.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from ..config import CfgNode


def collate_frame_major(samples: list) -> dict:
    """List of per-sample dicts -> frame-major batch (n, B, ...)."""
    batch = {}
    for key in ("template_images", "template_anno", "search_images",
                "search_anno", "search_cls", "text", "text_mask"):
        batch[key] = np.stack([s[key] for s in samples], axis=1)
    batch["flag"] = np.stack([s["flag"] for s in samples], axis=0)
    return batch


def _accepts_index(sampler) -> bool:
    """True if the sampler callable binds one positional argument.

    Decided once by signature inspection: a call-time except-TypeError
    fallback would also swallow TypeErrors raised *inside* the sampler,
    silently re-drawing without the index (double-advancing the RNG stream
    and dropping grounding_test's index->sequence mapping)."""
    import inspect

    try:
        inspect.signature(sampler).bind(0)
        return True
    except TypeError:
        return False


# ---- process-pool worker plumbing (loader.py:124-194 uses NUM_WORKER torch
# processes; this is the pool-based equivalent). The sampler travels to each
# worker once (initializer) and every worker reseeds itself with a distinct
# index so forked RNG state never produces duplicate streams.
_WORKER_SAMPLER = None
_WORKER_TAKES_INDEX = False


def _process_worker_init(sampler, counter, base):
    """base offsets the worker id by epoch*num_workers: a fresh pool is
    built every epoch and workers fork from a parent whose sampler RNG
    never advances (all draws happen in workers), so reseeding with a bare
    0..N-1 id would replay the identical sample stream every epoch."""
    global _WORKER_SAMPLER, _WORKER_TAKES_INDEX
    with counter.get_lock():
        wid = base + counter.value
        counter.value += 1
    if hasattr(sampler, "reseed"):
        sampler.reseed(wid)
    _WORKER_SAMPLER = sampler
    _WORKER_TAKES_INDEX = _accepts_index(sampler)


def _process_worker_draw(index=None):
    if _WORKER_TAKES_INDEX:
        return _WORKER_SAMPLER(index)
    return _WORKER_SAMPLER()


class SamplerLoader:
    """Iterates `steps` batches per epoch from a callable sampler.

    worker_mode "thread" (default): one ThreadPoolExecutor — zero-copy
    hand-off, fine when the per-sample work is dominated by GIL-releasing
    ops (cv2 decode/warp) or when one process drives one chip per host core.
    worker_mode "process": ProcessPoolExecutor — true parallelism for the
    numpy/Python-heavy parts of the pipeline (jitter, Gaussian labels,
    tokenize), at the cost of pickling each sample back (~1.6 MB at
    256px/n=2). Matches the reference's NUM_WORKER dataloader processes.
    """

    def __init__(self, sampler, batch_size: int, steps_per_epoch: int,
                 num_workers: int = 8, prefetch: int = 4,
                 worker_mode: str = "thread"):
        assert worker_mode in ("thread", "process"), worker_mode
        self.sampler = sampler
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._epoch = 0  # distinct process-worker reseeds per epoch

    def __len__(self):
        return self.steps_per_epoch

    def _make_pool(self):
        if self.worker_mode == "process":
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context(
                os.environ.get("UVLTRACK_LOADER_MP_CONTEXT", "fork"))
            counter = ctx.Value("i", 0)
            return ProcessPoolExecutor(
                self.num_workers, mp_context=ctx,
                initializer=_process_worker_init,
                initargs=(self.sampler, counter,
                          self._epoch * self.num_workers)), _process_worker_draw

        if _accepts_index(self.sampler):
            draw = self.sampler
        else:
            def draw(index=None):
                return self.sampler()

        return ThreadPoolExecutor(self.num_workers), draw

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                pool, draw = self._make_pool()
                with pool:
                    k = 0  # global draw index: grounding_test samplers map
                    # it to a sequence id so one epoch covers each sequence
                    for _ in range(self.steps_per_epoch):
                        if stop.is_set():
                            return
                        futures = []
                        for _ in range(self.batch_size):
                            futures.append(pool.submit(draw, k))
                            k += 1
                        samples = [f.result() for f in futures]
                        q.put(collate_frame_major(samples))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def build_train_loader(cfg: CfgNode, global_batch: int, seed: int = 42):
    from ..core.tokenizer import BertTokenizer
    from .builders import names2datasets
    from .processing import TrackProcessing
    from .sampler import GroundingAndTrackingSampler

    datasets = names2datasets(list(cfg.DATA.TRAIN.DATASETS_NAME))
    proc = TrackProcessing(cfg, seed=seed)
    tok = None
    if cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH and os.path.exists(
            cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH):
        tok = BertTokenizer(cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH)
    sampler = GroundingAndTrackingSampler(
        datasets, list(cfg.DATA.TRAIN.DATASETS_RATIO),
        int(cfg.DATA.TRAIN.SAMPLE_PER_EPOCH), int(cfg.DATA.MAX_SAMPLE_INTERVAL),
        proc, num_search_frames=int(cfg.DATA.SEARCH.NUMBER),
        mode=cfg.TRAIN.MODE, grounding_ratio=cfg.TRAIN.GROUNDING_RATIO,
        vl_ratio=cfg.TRAIN.VL_RATIO, tokenizer=tok,
        max_query_len=int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN),
        seed=seed)
    steps = int(cfg.DATA.TRAIN.SAMPLE_PER_EPOCH) // global_batch
    return SamplerLoader(sampler, global_batch, steps,
                         num_workers=int(cfg.TRAIN.NUM_WORKER),
                         worker_mode=str(getattr(cfg.TPU, "LOADER_WORKER_MODE",
                                                 "thread")))


def first_batch(cfg: CfgNode, global_batch: int, seed: int = 42) -> dict:
    """The first batch of build_train_loader(cfg, global_batch, seed) drawn
    in order by one thread worker: the same arrays for one seed in every
    call. The config's own loader, TRAIN.NUM_WORKER threads that each spawn
    their generators from the sampler's and the processing's seed in the
    order they first draw, gives a batch that varies from call to call. cfg
    is left as it was."""
    one = cfg.clone()
    one.TRAIN.NUM_WORKER = 1
    one.TPU.LOADER_WORKER_MODE = "thread"
    one.DATA.TRAIN.SAMPLE_PER_EPOCH = global_batch
    batches = iter(build_train_loader(one, global_batch, seed=seed))
    try:
        return next(batches)
    finally:
        batches.close()


def build_val_loaders(cfg: CfgNode, global_batch: int, seed: int = 7):
    """Three validation families: tracking / grounding / vl (base_functions.py:150-191)."""
    from ..core.tokenizer import BertTokenizer
    from .builders import names2datasets
    from .processing import TrackProcessing
    from .sampler import GroundingAndTrackingSampler

    out = {}
    tok = None
    if cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH and os.path.exists(
            cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH):
        tok = BertTokenizer(cfg.MODEL.BACKBONE.LANGUAGE.VOCAB_PATH)
    for name, mode, node in (
        ("valtrack", "tracking_test", cfg.DATA.VALTRACK),
        ("valground", "grounding_test", cfg.DATA.VAL),
        ("valvl", "vl_test", cfg.DATA.VALVL),
    ):
        try:
            datasets = names2datasets(list(node.DATASETS_NAME))
        except Exception:
            continue
        if not datasets:
            continue
        proc = TrackProcessing(cfg, seed=seed)
        ratios = list(node.DATASETS_RATIO) if "DATASETS_RATIO" in node else None
        spe = int(node.SAMPLE_PER_EPOCH) if "SAMPLE_PER_EPOCH" in node else 1000
        sampler = GroundingAndTrackingSampler(
            datasets, ratios, spe, int(cfg.DATA.MAX_SAMPLE_INTERVAL), proc,
            num_search_frames=int(cfg.DATA.SEARCH.NUMBER), mode=mode,
            tokenizer=tok,
            max_query_len=int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN),
            seed=seed)
        if mode == "grounding_test":
            # one val epoch scores every sequence: len(sampler) is the
            # dataset's sequence count and the loader's draw index maps to
            # sequence ids (reference DataLoader semantics); ceil so small
            # datasets still yield a batch (the remainder wraps)
            steps = -(-len(sampler) // global_batch)
        else:
            steps = spe // global_batch
        out[name] = SamplerLoader(sampler, global_batch, steps,
                                  num_workers=int(cfg.TRAIN.NUM_WORKER),
                                  worker_mode=str(getattr(
                                      cfg.TPU, "LOADER_WORKER_MODE", "thread")))
    return out
