"""Synthetic training batches with the training-batch contract (port of
uvltrack_tpu/data/synthetic.py): frame-major numpy arrays as the reference
sampler's collate emits them (lib/train/data/sampler.py:210-216, LTRLoader
stack_dim=1): template_images (1,B,Ht,Wt,3), search_images (n,B,Hs,Ws,3),
normalized xywh annos, Gaussian cls maps, token ids, a flag per sample.

The draws and their order are the JAX package's, so one
numpy.random.default_rng seed gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from ..core.heatmap import generate_cls_label


def synthetic_batch(rng: np.random.Generator, batch_size: int, n_search: int = 2,
                    template_size: int = 128, search_size: int = 256,
                    n_text: int = 40, vocab: int = 30522,
                    gaussian_iou: float = 0.7, dynamic_cls: bool = True) -> dict:
    b, n = batch_size, n_search
    hc = search_size // 16

    def rand_box(batch):
        cx = rng.uniform(0.3, 0.7, size=batch)
        cy = rng.uniform(0.3, 0.7, size=batch)
        w = rng.uniform(0.1, 0.4, size=batch)
        h = rng.uniform(0.1, 0.4, size=batch)
        return np.stack([cx - w / 2, cy - h / 2, w, h], -1).astype(np.float32)

    search_anno = np.stack([rand_box(b) for _ in range(n)], 0)  # (n,B,4)
    cls = np.stack([generate_cls_label(search_anno[i], hc, gaussian_iou, dynamic_cls)
                    for i in range(n)], 0).astype(np.float32)
    return {
        "template_images": rng.normal(size=(1, b, template_size, template_size, 3)).astype(np.float32),
        "search_images": rng.normal(size=(n, b, search_size, search_size, 3)).astype(np.float32),
        "template_anno": rand_box(b)[None],  # (1,B,4)
        "search_anno": search_anno,
        "search_cls": cls,  # (n,B,hc,hc)
        "text": rng.integers(0, vocab, size=(n, b, n_text)).astype(np.int32),
        "text_mask": np.ones((n, b, n_text), np.int32),
        "flag": rng.integers(0, 3, size=(b,)).astype(np.int32),
    }


def synthetic_batch_from_cfg(rng: np.random.Generator, cfg, batch_size: int,
                             n_search: int | None = None) -> dict:
    """synthetic_batch with every shape and label knob read from the
    experiment config (the one cfg -> kwargs mapping, as in the JAX package)."""
    return synthetic_batch(
        rng, batch_size,
        n_search=int(cfg.DATA.SEARCH.NUMBER) if n_search is None else n_search,
        template_size=int(cfg.DATA.TEMPLATE.SIZE),
        search_size=int(cfg.DATA.SEARCH.SIZE),
        n_text=int(cfg.MODEL.BACKBONE.LANGUAGE.BERT.MAX_QUERY_LEN),
        gaussian_iou=float(cfg.TRAIN.GAUSSIAN_IOU),
        dynamic_cls=bool(cfg.TRAIN.DYNAMIC_CLS))
