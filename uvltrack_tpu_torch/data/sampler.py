"""Task-mixing training sampler.

Parity with GroundingAndTrackingSampler (lib/train/data/sampler.py:13-660):
per-index it rolls a task — tracking (flag 0) with prob 1-gr-vl, grounding
(flag 1) with prob gr, vision-language (flag 2) with prob vl — picks a
dataset that supports the task (capability flags), samples template+search
frames causally within MAX_SAMPLE_INTERVAL, processes crops, and BERT-
tokenizes the caption to MAX_QUERY_LEN ids (default caption
'object, thing or stuff' when the dataset has none, sampler.py:205-206).
Validation modes ('tracking_test'/'grounding_test'/'vl_test') pin the task.

The port's own copy of uvltrack_tpu/data/sampler.py (framework-free; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from .processing import TrackProcessing

DEFAULT_CAPTION = "object, thing or stuff"


class _ThreadLocalRng:
    """numpy Generators are not thread-safe; the loader samples from worker
    threads, so each thread gets its own stream spawned from one seed.

    Process-pool workers (loader worker_mode="process") fork with identical
    copies of this object; reseed(worker_id) gives each process a disjoint
    deterministic stream (and drops any generator the parent thread already
    materialized before the fork)."""

    def __init__(self, seed: Optional[int], key: Optional[int] = None):
        self._seed, self._key = seed, key
        entropy = seed if key is None else (
            np.random.SeedSequence(seed).entropy, key)
        self._seq = np.random.SeedSequence(entropy)
        self._local = threading.local()
        self._lock = threading.Lock()

    def get(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                child = self._seq.spawn(1)[0]
            rng = np.random.default_rng(child)
            self._local.rng = rng
        return rng

    def reseed(self, key: int) -> None:
        self.__init__(self._seed, key)

    # thread locks don't pickle (spawn/forkserver loader workers)
    def __getstate__(self):
        return {"seed": self._seed, "key": self._key}

    def __setstate__(self, s):
        self.__init__(s["seed"], s["key"])


class GroundingAndTrackingSampler:
    def __init__(self, datasets: List, p_datasets: Optional[List[float]],
                 samples_per_epoch: int, max_gap: int, processing: TrackProcessing,
                 num_search_frames: int = 2, num_template_frames: int = 1,
                 mode: str = "joint", grounding_ratio: Optional[float] = None,
                 vl_ratio: Optional[float] = None, tokenizer=None,
                 max_query_len: int = 40, seed: Optional[int] = None,
                 frame_sample_mode: str = "causal"):
        assert frame_sample_mode in ("causal", "trident", "trident_pro", "stark")
        self.frame_sample_mode = frame_sample_mode
        self.datasets = datasets
        p = np.asarray(p_datasets if p_datasets is not None
                       else [1.0] * len(datasets), np.float64)
        self.p_datasets = p / p.sum()
        self.samples_per_epoch = samples_per_epoch
        self.max_gap = max_gap
        self.processing = processing
        self.num_search = num_search_frames
        self.num_template = num_template_frames
        self.mode = mode
        self.grounding_ratio = grounding_ratio or 0.0
        self.vl_ratio = vl_ratio or 0.0
        self.tokenizer = tokenizer
        self.max_query_len = max_query_len
        self._rng = _ThreadLocalRng(seed)

    @property
    def rng(self) -> np.random.Generator:
        return self._rng.get()

    def reseed(self, key: int) -> None:
        """Give this (forked) copy a disjoint deterministic RNG stream —
        called by the loader's process-pool worker initializer."""
        self._rng.reseed(key)
        reseed_proc = getattr(self.processing, "reseed", None)
        if reseed_proc is not None:
            reseed_proc(key)

    def __len__(self):
        # grounding validation iterates the dataset's sequences once
        # (reference sampler.py:90-93)
        if self.mode == "grounding_test":
            return self.datasets[0].get_num_sequences()
        return self.samples_per_epoch

    # ---------------------------------------------------------------- tasks
    def _roll_task(self) -> int:
        if self.mode == "grounding" or self.mode == "grounding_test":
            return 1
        if self.mode == "tracking_test":
            return 0
        if self.mode == "vl_test":
            return 2
        p = self.rng.random()
        if p < 1.0 - self.grounding_ratio - self.vl_ratio:
            return 0
        if p < 1.0 - self.vl_ratio:
            return 1
        return 2

    def _pick_dataset(self, task: int):
        ok = []
        for d, p in zip(self.datasets, self.p_datasets):
            if task == 0 and d.is_tracking_sequence():
                ok.append((d, p))
            elif task == 1 and d.is_grounding_sequence():
                ok.append((d, p))
            elif task == 2 and d.is_vl_sequence():
                ok.append((d, p))
        if not ok:  # fall back to tracking-capable
            ok = [(d, p) for d, p in zip(self.datasets, self.p_datasets)
                  if d.is_tracking_sequence()]
        probs = np.asarray([p for _, p in ok])
        probs = probs / probs.sum()
        idx = self.rng.choice(len(ok), p=probs)
        return ok[idx][0]

    # ------------------------------------------------------------- sampling
    def _sample_visible_ids(self, visible: np.ndarray, num: int,
                            min_id: int = 0, max_id: Optional[int] = None,
                            allow_invisible: bool = False,
                            force_invisible: bool = False):
        """sampler.py:96-127 semantics incl. allow/force_invisible."""
        max_id = len(visible) if max_id is None else max_id
        min_id = max(0, min_id)
        max_id = min(len(visible), max_id)
        window = np.asarray(visible[min_id:max_id], bool)
        if force_invisible:
            ids = np.flatnonzero(~window) + min_id
        elif allow_invisible:
            ids = np.arange(min_id, max_id)
        else:
            ids = np.flatnonzero(window) + min_id
        if len(ids) == 0:
            return None
        return list(self.rng.choice(ids, size=num, replace=True))

    def _sample_seq(self, dataset):
        for _ in range(50):
            seq_id = int(self.rng.integers(0, dataset.get_num_sequences()))
            info = dataset.get_sequence_info(seq_id)
            visible = np.asarray(info["visible"], bool)
            enough = visible.sum() > 2 * (self.num_search + self.num_template)
            if enough or not dataset.is_video_sequence():
                if visible.sum() > 0:
                    return seq_id, info, visible
        return None

    def _gap_list(self):
        """trident/stark iterate max_gap as a list — one dynamic template per
        entry (sampler.py:580: `for max_gap in self.max_gap`). A scalar config
        is promoted to one entry per extra template."""
        if isinstance(self.max_gap, (list, tuple)):
            return list(self.max_gap)
        return [self.max_gap] * max(self.num_template - 1, 0)

    def _trident_frames(self, visible: np.ndarray, valid: Optional[np.ndarray]):
        """'trident'/'trident_pro'/'stark' sampling (sampler.py:572-621): one
        anchor template + one dynamic template near the search frame per
        max_gap entry. 'trident_pro' lets the dynamic templates be invisible
        frames (:586-588); 'stark' samples them from the valid (not
        necessarily visible) pool (:614-615)."""
        pool = valid if (self.frame_sample_mode == "stark" and valid is not None) else visible
        allow_invisible = self.frame_sample_mode == "trident_pro"
        for _ in range(50):
            t1 = self._sample_visible_ids(visible, 1)
            sid = self._sample_visible_ids(visible, 1)
            if t1 is None or sid is None:
                return None
            extras = []
            for gap in self._gap_list():
                if t1[0] >= sid[0]:
                    lo, hi = sid[0], sid[0] + gap
                else:
                    lo, hi = sid[0] - gap, sid[0]
                f_id = self._sample_visible_ids(pool, 1, lo, hi,
                                                allow_invisible=allow_invisible)
                extras.append(None if f_id is None else f_id[0])
            if None not in extras:
                return t1 + extras, sid * self.num_search
        return None

    def _causal_frames(self, visible: np.ndarray):
        """Template first, then search frames after it within a growing gap."""
        # list max_gap (trident configs) collapses to its widest entry here,
        # like _sample_grounding — causal mode has a single gap window
        base_gap = self.max_gap if not isinstance(self.max_gap, (list, tuple)) \
            else max(self.max_gap)
        gap = base_gap
        while True:
            base = self._sample_visible_ids(
                visible, 1, 0, len(visible) - self.num_search)
            if base is None:
                gap += 5
                if gap > 10 * base_gap:
                    return None
                continue
            tid = base[0]
            sids = self._sample_visible_ids(visible, self.num_search,
                                            tid + 1, tid + gap)
            if sids is None:
                gap += 5
                if gap > 10 * base_gap:
                    # fall back: reuse the template frame
                    return [tid], [tid] * self.num_search
                continue
            return [tid], sorted(sids)

    # ---------------------------------------------------------------- public
    def sample(self, index: Optional[int] = None) -> dict:
        """index: the loader's global draw counter — consumed only by
        grounding_test (sequence = index % n, reference DataLoader
        semantics); every other task draws randomly like the reference."""
        while True:
            task = self._roll_task()
            if self.mode == "grounding_test":
                # the reference pins grounding validation to datasets[0]
                # (sampler.py:504), matching __len__'s sequence count —
                # ratio-weighted picking would break the index->sequence map
                out = self._sample_grounding_test(self.datasets[0], index)
            elif task == 1:
                out = self._sample_grounding(self._pick_dataset(task))
            elif task == 2:
                out = self.sample_vl(self._pick_dataset(task))
            else:
                out = self.sample_track(self._pick_dataset(task))
            if out is not None:
                return out

    __call__ = sample

    def _tokenize(self, language: Optional[str]):
        """Tracking samples carry the tokenized caption too — the reference
        tokenizes for every task (sampler.py:205-216) and gates text by flag
        inside the model (cat_mask: t_mask = mask * (flag != 0))."""
        nt = self.max_query_len
        if language is None or self.tokenizer is None:
            return np.zeros((nt,), np.int32), np.zeros((nt,), np.int32)
        ids, mask = self.tokenizer.encode_query(language, nt)
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def sample_track(self, dataset=None) -> Optional[dict]:
        """Tracking task (flag 0), sampler.py:155-220."""
        return self._sample_pair(dataset or self._pick_dataset(0), flag=0)

    def sample_vl(self, dataset=None) -> Optional[dict]:
        """Vision-language task (flag 2), sampler.py:222-289 — same frame
        sampling as tracking but drawn from the VL-capable dataset pool."""
        return self._sample_pair(dataset or self._pick_dataset(2), flag=2)

    def _sample_pair(self, dataset, flag: int) -> Optional[dict]:
        picked = self._sample_seq(dataset)
        if picked is None:
            return None
        seq_id, info, visible = picked
        if dataset.is_video_sequence():
            if self.frame_sample_mode == "causal":
                fr = self._causal_frames(visible)
            else:
                fr = self._trident_frames(visible, np.asarray(info.get("valid"), bool)
                                          if info.get("valid") is not None else None)
            if fr is None:
                return None
            tids, sids = fr
        else:
            tids, sids = [0], [0] * self.num_search
        t_frames, t_anno, meta = dataset.get_frames(seq_id, tids, info)
        s_frames, s_anno, _ = dataset.get_frames(seq_id, sids, info)
        language = meta.get("language") or DEFAULT_CAPTION
        sample = self.processing.track_process(
            t_frames, t_anno["bbox"], s_frames, s_anno["bbox"], language)
        if sample is None:
            return None
        return self._finalize(sample, flag=flag)

    def _sample_grounding(self, dataset) -> Optional[dict]:
        """Grounding task (sampler.py:291-351): one grounding frame from the
        first ~30 frames of the sequence, plus num_search-1 later search
        frames (image datasets repeat the single image)."""
        picked = self._sample_seq(dataset)
        if picked is None:
            return None
        seq_id, info, visible = picked
        gap = self.max_gap if not isinstance(self.max_gap, (list, tuple)) \
            else max(self.max_gap)
        if dataset.is_video_sequence():
            max_n = min(30, len(visible))
            g_ids = self._sample_visible_ids(
                visible, 1, 0, max(max_n - self.num_search + 1, 1))
            if g_ids is None:
                return None
            s_ids = []
            if self.num_search > 1:
                grow = 0
                while True:
                    s_ids = self._sample_visible_ids(
                        visible, self.num_search - 1,
                        g_ids[0] + 1, g_ids[0] + gap + grow)
                    if s_ids is not None:
                        break
                    grow += 5
                    if grow > 10 * gap:
                        s_ids = [g_ids[0]] * (self.num_search - 1)
                        break
        else:
            g_ids = [0]
            s_ids = [0] * (self.num_search - 1)
        g_frames, g_anno, meta = dataset.get_frames(seq_id, g_ids, info)
        if s_ids:
            s_frames, s_anno, _ = dataset.get_frames(seq_id, s_ids, info)
        else:
            s_frames, s_anno = [], {"bbox": []}
        language = meta.get("language") or DEFAULT_CAPTION
        sample = self.processing.grounding_process(
            g_frames, g_anno["bbox"], s_frames, s_anno["bbox"],
            language, self.num_search)
        if sample is None:
            return None
        return self._finalize(sample, flag=1)

    def _sample_grounding_test(self, dataset,
                               index: Optional[int] = None) -> Optional[dict]:
        """Validation grounding sample (sampler.py:496-522): sequence
        `index`'s frame [0] through the plain letterbox — no augmentation,
        no extra search frames. The reference's sample_grounding_test(i)
        receives the DataLoader index, so one epoch scores every sequence
        exactly once; the loader passes the draw index through for the same
        semantics (a with-replacement fallback covers index-less callers)."""
        if index is not None:
            seq_id = int(index) % dataset.get_num_sequences()
        else:
            seq_id = int(self.rng.integers(0, dataset.get_num_sequences()))
        info = dataset.get_sequence_info(seq_id)
        frames, anno, meta = dataset.get_frames(seq_id, [0], info)
        language = meta.get("language") or DEFAULT_CAPTION
        sample = self.processing.grounding_process_test(
            frames, anno["bbox"], language, self.num_search)
        if sample is None:
            return None
        return self._finalize(sample, flag=1)

    def _finalize(self, sample: dict, flag: int) -> dict:
        ids, mask = self._tokenize(sample.pop("language"))
        n = sample["search_images"].shape[0]
        sample["text"] = np.tile(ids[None], (n, 1))
        sample["text_mask"] = np.tile(mask[None], (n, 1))
        sample["flag"] = np.int32(flag)
        return sample
