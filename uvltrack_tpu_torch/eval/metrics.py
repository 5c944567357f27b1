"""Tracking metrics: IoU/center-error curves, AUC / Precision / NormPrecision
(a copy of uvltrack_tpu/eval/metrics.py: numpy only).

Numpy re-derivation of the reference analysis math
(lib/test/analysis/extract_results.py:16-99, plot_results.py:199-213),
including its robustness rules: zero-size predictions carried forward, first
frame forced to ground truth, per-dataset NaN handling, Precision = value of
the center-error curve at the 20px threshold, NormPrecision at 0.20.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

THRESH_OVERLAP = np.arange(0.0, 1.05, 0.05)  # 21 bins
THRESH_CENTER = np.arange(0, 51, dtype=np.float64)  # 51 bins
THRESH_CENTER_NORM = np.arange(0, 51, dtype=np.float64) / 100.0


def calc_err_center(pred_bb: np.ndarray, anno_bb: np.ndarray, normalized=False) -> np.ndarray:
    pred_center = pred_bb[:, :2] + 0.5 * (pred_bb[:, 2:] - 1.0)
    anno_center = anno_bb[:, :2] + 0.5 * (anno_bb[:, 2:] - 1.0)
    if normalized:
        pred_center = pred_center / anno_bb[:, 2:]
        anno_center = anno_center / anno_bb[:, 2:]
    return np.sqrt(((pred_center - anno_center) ** 2).sum(1))


def calc_iou_overlap(pred_bb: np.ndarray, anno_bb: np.ndarray) -> np.ndarray:
    tl = np.maximum(pred_bb[:, :2], anno_bb[:, :2])
    br = np.minimum(pred_bb[:, :2] + pred_bb[:, 2:] - 1.0,
                    anno_bb[:, :2] + anno_bb[:, 2:] - 1.0)
    sz = np.clip(br - tl + 1.0, 0, None)
    intersection = sz.prod(axis=1)
    union = pred_bb[:, 2:].prod(axis=1) + anno_bb[:, 2:].prod(axis=1) - intersection
    return intersection / union


def calc_seq_err_robust(pred_bb: np.ndarray, anno_bb: np.ndarray, dataset: str,
                        target_visible: Optional[np.ndarray] = None):
    pred_bb = np.array(pred_bb, np.float64, copy=True)
    anno_bb = np.asarray(anno_bb, np.float64)

    if np.isnan(pred_bb).any() or (pred_bb[:, 2:] < 0.0).any():
        raise ValueError("Invalid tracker results (NaN or negative size)")
    if np.isnan(anno_bb).any() and dataset not in ("uav", "itb"):
        raise ValueError("NaNs in annotation")

    # carry forward zero-size (failure) predictions
    if (pred_bb[:, 2:] == 0.0).any():
        for i in range(1, pred_bb.shape[0]):
            if (pred_bb[i, 2:] == 0.0).any() and not np.isnan(anno_bb[i]).any():
                pred_bb[i] = pred_bb[i - 1]

    if pred_bb.shape[0] != anno_bb.shape[0]:
        if pred_bb.shape[0] > anno_bb.shape[0]:
            pred_bb = pred_bb[: anno_bb.shape[0]]
        elif dataset == "lasot":
            raise ValueError("Mis-match in tracker prediction and GT lengths")
        else:
            pad = np.zeros((anno_bb.shape[0] - pred_bb.shape[0], 4))
            pred_bb = np.concatenate([pred_bb, pad], 0)

    pred_bb[0] = anno_bb[0]

    if target_visible is not None:
        tv = np.asarray(target_visible, bool)
        valid = ((anno_bb[:, 2:] > 0.0).sum(1) == 2) & tv
    else:
        valid = (anno_bb[:, 2:] > 0.0).sum(1) == 2

    with np.errstate(invalid="ignore", divide="ignore"):
        err_center = calc_err_center(pred_bb, anno_bb)
        err_center_norm = calc_err_center(pred_bb, anno_bb, normalized=True)
        err_overlap = calc_iou_overlap(pred_bb, anno_bb)

    err_center[~valid] = -1.0 if dataset == "uav" else np.inf
    err_center_norm[~valid] = -1.0
    err_overlap[~valid] = -1.0
    if dataset == "lasot" and target_visible is not None:
        err_center_norm[~np.asarray(target_visible, bool)] = np.inf
        err_center[~np.asarray(target_visible, bool)] = np.inf

    if np.isnan(err_overlap).any():
        raise ValueError("NaNs in calculated overlap")
    return err_overlap, err_center, err_center_norm, valid


def sequence_curves(pred_bb, anno_bb, dataset, target_visible=None,
                    exclude_invalid_frames=False):
    """Per-sequence success/precision curves (fractions in [0,1])."""
    err_overlap, err_center, err_center_norm, valid = calc_seq_err_robust(
        pred_bb, anno_bb, dataset, target_visible)
    seq_length = int(valid.sum()) if exclude_invalid_frames else anno_bb.shape[0]
    if seq_length <= 0:
        raise ValueError("Sequence length zero")
    succ = (err_overlap[:, None] > THRESH_OVERLAP[None]).sum(0) / seq_length
    prec = (err_center[:, None] <= THRESH_CENTER[None]).sum(0) / seq_length
    prec_norm = (err_center_norm[:, None] <= THRESH_CENTER_NORM[None]).sum(0) / seq_length
    avg_overlap = err_overlap[valid].mean() if valid.any() else 0.0
    return dict(success=succ, precision=prec, norm_precision=prec_norm,
                avg_overlap=avg_overlap)


def aggregate_scores(curves: List[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """Dataset-level AUC / OP50 / OP75 / Precision / NormPrecision (x100)."""
    succ = np.stack([c["success"] for c in curves]).mean(0) * 100.0
    prec = np.stack([c["precision"] for c in curves]).mean(0) * 100.0
    pnorm = np.stack([c["norm_precision"] for c in curves]).mean(0) * 100.0
    return {
        "AUC": float(succ.mean()),
        "OP50": float(succ[THRESH_OVERLAP == 0.50][0]),
        "OP75": float(succ[THRESH_OVERLAP == 0.75][0]),
        "Precision": float(prec[20]),
        "NormPrec": float(pnorm[20]),
    }


def evaluate_results_dir(results_dir: str, dataset, report: bool = True):
    """Score saved <seq>.txt results against a SequenceList's ground truth."""
    curves = []
    missing = []
    for seq in dataset:
        path = os.path.join(results_dir, f"{seq.name}.txt")
        if not os.path.isfile(path):
            missing.append(seq.name)
            continue
        # load_text tries ',', tab and space — reference result files may use
        # any of the three (lib/test/utils/load_text.py semantics)
        from .datasets import load_text
        pred = load_text(path)
        curves.append(sequence_curves(pred.reshape(-1, 4), seq.ground_truth_rect,
                                      seq.dataset, seq.target_visible))
    if not curves:
        raise FileNotFoundError(f"no results found in {results_dir}")
    scores = aggregate_scores(curves)
    scores["n_sequences"] = len(curves)
    scores["n_missing"] = len(missing)
    if report:
        print(f"{results_dir}: " + "  ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scores.items()))
    return scores


def extract_results(trackers: List[dict], dataset, skip_missing_seq: bool = False,
                    exclude_invalid_frames: bool = False) -> dict:
    """Per-sequence curve tensors for a list of tracker runs — the
    `eval_data` structure of lib/test/analysis/extract_results.py:100-180
    (same keys, plain lists, so a cache written here is format-compatible).

    Each tracker is {"name", "param", "run_id", "results_dir"[, "disp_name"]}
    with results_dir holding the report's <seq>.txt files directly.
    """
    from .datasets import load_text

    n_seq, n_trk = len(dataset), len(trackers)
    avg_overlap_all = np.zeros((n_seq, n_trk), np.float64)
    succ = np.zeros((n_seq, n_trk, len(THRESH_OVERLAP)), np.float32)
    prec = np.zeros((n_seq, n_trk, len(THRESH_CENTER)), np.float32)
    prec_norm = np.zeros((n_seq, n_trk, len(THRESH_CENTER_NORM)), np.float32)
    valid_sequence = np.ones(n_seq, np.uint8)

    for seq_id, seq in enumerate(dataset):
        anno_bb = np.asarray(seq.ground_truth_rect, np.float64)
        for trk_id, trk in enumerate(trackers):
            path = os.path.join(trk["results_dir"], f"{seq.name}.txt")
            if not os.path.isfile(path):
                if skip_missing_seq:
                    valid_sequence[seq_id] = 0
                    break
                raise FileNotFoundError(f"Result not found: {path}")
            pred_bb = load_text(path).reshape(-1, 4)
            err_overlap, err_center, err_center_norm, valid = \
                calc_seq_err_robust(pred_bb, anno_bb, seq.dataset,
                                    seq.target_visible)
            avg_overlap_all[seq_id, trk_id] = (
                err_overlap[valid].mean() if valid.any() else np.nan)
            seq_length = int(valid.sum()) if exclude_invalid_frames \
                else anno_bb.shape[0]
            if seq_length <= 0:
                raise ValueError("Seq length zero")
            succ[seq_id, trk_id] = (
                err_overlap[:, None] > THRESH_OVERLAP[None]).sum(0) / seq_length
            prec[seq_id, trk_id] = (
                err_center[:, None] <= THRESH_CENTER[None]).sum(0) / seq_length
            prec_norm[seq_id, trk_id] = (
                err_center_norm[:, None] <= THRESH_CENTER_NORM[None]
            ).sum(0) / seq_length

    tracker_names = [{"name": t["name"], "param": t["param"],
                      "run_id": t.get("run_id"),
                      "disp_name": t.get("disp_name")} for t in trackers]
    return {
        "sequences": [s.name for s in dataset],
        "trackers": tracker_names,
        "valid_sequence": valid_sequence.tolist(),
        "ave_success_rate_plot_overlap": succ.tolist(),
        "ave_success_rate_plot_center": prec.tolist(),
        "ave_success_rate_plot_center_norm": prec_norm.tolist(),
        "avg_overlap_all": avg_overlap_all.tolist(),
        "threshold_set_overlap": THRESH_OVERLAP.tolist(),
        "threshold_set_center": THRESH_CENTER.tolist(),
        "threshold_set_center_norm": THRESH_CENTER_NORM.tolist(),
    }


def check_and_load_precomputed_results(trackers: List[dict], dataset,
                                       plot_dir: str,
                                       force_evaluation: bool = False,
                                       **kwargs) -> dict:
    """eval_data.pkl cache per report (plot_results.py:170-197): load when
    present and still valid for (sequence names, tracker name/param/run_id),
    recompute otherwise, always rewrite. Saves re-scoring every sequence txt
    on each analyze call."""
    import pickle

    os.makedirs(plot_dir, exist_ok=True)
    cache = os.path.join(plot_dir, "eval_data.pkl")
    eval_data = None
    if os.path.isfile(cache) and not force_evaluation:
        with open(cache, "rb") as fh:
            eval_data = pickle.load(fh)
        same_seqs = eval_data.get("sequences") == [s.name for s in dataset]
        ids = [(t["name"], t["param"], t.get("run_id")) for t in trackers]
        saved = [(t["name"], t["param"], t.get("run_id"))
                 for t in eval_data.get("trackers", [])]
        if not (same_seqs and ids == saved):
            eval_data = None
        else:  # refresh display names only
            eval_data["trackers"] = [
                {"name": t["name"], "param": t["param"],
                 "run_id": t.get("run_id"), "disp_name": t.get("disp_name")}
                for t in trackers]
    if eval_data is None:
        eval_data = extract_results(trackers, dataset, **kwargs)
    with open(cache, "wb") as fh:
        pickle.dump(eval_data, fh)
    return eval_data


def merge_multiple_runs(eval_data: dict) -> dict:
    """Average the per-sequence curves across runs of the same
    (name, param) pair (plot_results.py:45-88): 5 run_ids of one parameter
    file report as one averaged tracker entry."""
    trackers = eval_data["trackers"]
    succ = np.asarray(eval_data["ave_success_rate_plot_overlap"])
    prec = np.asarray(eval_data["ave_success_rate_plot_center"])
    prec_norm = np.asarray(eval_data["ave_success_rate_plot_center_norm"])
    ao = np.asarray(eval_data["avg_overlap_all"])

    new_trackers, succ_m, prec_m, prec_norm_m, ao_m = [], [], [], [], []
    merged = np.zeros(len(trackers), bool)
    for i, base in enumerate(trackers):
        if merged[i]:
            continue
        new_trackers.append(base)
        match = np.array([t["name"] == base["name"] and
                          t["param"] == base["param"] for t in trackers])
        succ_m.append(succ[:, match, :].mean(1))
        prec_m.append(prec[:, match, :].mean(1))
        prec_norm_m.append(prec_norm[:, match, :].mean(1))
        ao_m.append(ao[:, match].mean(1))
        merged |= match
    out = dict(eval_data)
    out["trackers"] = new_trackers
    out["ave_success_rate_plot_overlap"] = np.stack(succ_m, 1).tolist()
    out["ave_success_rate_plot_center"] = np.stack(prec_m, 1).tolist()
    out["ave_success_rate_plot_center_norm"] = np.stack(prec_norm_m, 1).tolist()
    out["avg_overlap_all"] = np.stack(ao_m, 1).tolist()
    return out


def eval_data_scores(eval_data: dict) -> Dict[str, np.ndarray]:
    """Per-tracker AUC / OP50 / OP75 / Precision / NormPrec (x100) from an
    eval_data dict, over its valid sequences (plot_results.py:199-213
    get_auc_curve/get_prec_curve)."""
    valid = np.asarray(eval_data["valid_sequence"], bool)
    succ = np.asarray(eval_data["ave_success_rate_plot_overlap"])[valid]
    prec = np.asarray(eval_data["ave_success_rate_plot_center"])[valid]
    pnorm = np.asarray(eval_data["ave_success_rate_plot_center_norm"])[valid]
    succ_curve = succ.mean(0) * 100.0  # (n_trk, 21)
    prec_curve = prec.mean(0) * 100.0
    pnorm_curve = pnorm.mean(0) * 100.0
    return {
        "AUC": succ_curve.mean(-1),
        "OP50": succ_curve[:, THRESH_OVERLAP == 0.50][:, 0],
        "OP75": succ_curve[:, THRESH_OVERLAP == 0.75][:, 0],
        "Precision": prec_curve[:, 20],
        "NormPrec": pnorm_curve[:, 20],
    }


def generate_formatted_report(row_labels, scores: Dict[str, np.ndarray],
                              table_name: str = "") -> str:
    """Fixed-width table like plot_results.py:294-315 — one row per label,
    one column per score array."""
    name_width = max([len(d) for d in row_labels] + [len(table_name)]) + 5
    score_widths = [max(10, len(k) + 3) for k in scores]
    text = "\n{label: <{width}} |".format(label=table_name, width=name_width)
    for k, w in zip(scores, score_widths):
        text += " {s: <{width}} |".format(s=k, width=w)
    text += "\n"
    for i, label in enumerate(row_labels):
        text += "{label: <{width}} |".format(label=label, width=name_width)
        for (_, vals), w in zip(scores.items(), score_widths):
            text += " {score: <{width}} |".format(
                score="{:0.2f}".format(float(vals[i])), width=w)
        text += "\n"
    return text


def per_sequence_results(results_dirs: Dict[str, str], dataset,
                         filter_criteria: Optional[dict] = None,
                         report: bool = True) -> str:
    """Per-sequence average-overlap table across trackers
    (plot_results.py:442-505). filter_criteria: {'mode': 'ao_min'|'ao_max'|
    'delta_ao', 'threshold': float} selects sequences where at least one /
    every / tracker-spread of AO is below/above the threshold."""
    from .datasets import load_text

    names = list(results_dirs)
    seq_names, rows = [], []
    for seq in dataset:
        ao = []
        for name in names:
            path = os.path.join(results_dirs[name], f"{seq.name}.txt")
            if not os.path.isfile(path):
                break
            pred = load_text(path).reshape(-1, 4)
            ao.append(sequence_curves(pred, seq.ground_truth_rect, seq.dataset,
                                      seq.target_visible)["avg_overlap"] * 100.0)
        else:
            seq_names.append(seq.name)
            rows.append(ao)
    ao_all = np.asarray(rows).reshape(-1, len(names))
    keep = np.ones(len(seq_names), bool)
    if filter_criteria is not None:
        thr = float(filter_criteria["threshold"])
        mode = filter_criteria["mode"]
        if mode == "ao_min":
            keep = ao_all.min(axis=1) < thr
        elif mode == "ao_max":
            keep = ao_all.max(axis=1) < thr
        elif mode == "delta_ao":
            keep = (ao_all.max(axis=1) - ao_all.min(axis=1)) > thr
        else:
            raise ValueError(f"unknown filter mode {mode}")
    labels = [n for n, k in zip(seq_names, keep) if k]
    scores = {name: ao_all[keep][:, j] for j, name in enumerate(names)}
    text = generate_formatted_report(labels, scores, table_name="Sequence")
    if report:
        print(text)
    return text
