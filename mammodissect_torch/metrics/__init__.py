"""Evaluation metrics (a copy of `mammodissect/metrics/__init__.py`): the reference's
missing external `metrics` module (`pfbeta_binarized, pr_auc, compute_auprc, auroc,
compute_accuracy_np_array`, imported at `Classifiers/experiments.py:19` but never
vendored). Pure numpy; held to the JAX package's copy in tests/test_torch_train.py."""
from __future__ import annotations

import numpy as np

__all__ = [
    "auroc",
    "pr_auc",
    "compute_auprc",
    "pfbeta",
    "pfbeta_binarized",
    "compute_accuracy_np_array",
    "f1_macro",
    "precision_recall_curve",
    "optimal_roc_threshold",
]


def _as_1d(gt, pred):
    gt = np.asarray(gt, dtype=np.float64).ravel()
    pred = np.asarray(pred, dtype=np.float64).ravel()
    if gt.shape != pred.shape:
        raise ValueError(f"shape mismatch: gt {gt.shape} vs pred {pred.shape}")
    return gt, pred


def _tied_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties averaged (midrank), O(n log n)."""
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    n = len(x)
    ranks = np.empty(n, dtype=np.float64)
    # boundaries of tie groups in sorted order
    boundary = np.flatnonzero(np.r_[True, sx[1:] != sx[:-1], True])
    for lo, hi in zip(boundary[:-1], boundary[1:]):
        ranks[order[lo:hi]] = 0.5 * (lo + 1 + hi)  # average of ranks lo+1..hi
    return ranks


def auroc(gt, pred) -> float:
    """Area under the ROC curve via the Mann–Whitney U statistic (tie-aware).

    Matches sklearn.roc_auc_score; replaces the external `auroc` used at
    `Classifiers/experiments.py:81,255,370`."""
    gt, pred = _as_1d(gt, pred)
    pos = gt > 0.5
    n_pos = int(pos.sum())
    n_neg = len(gt) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _tied_ranks(pred)
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def precision_recall_curve(gt, pred):
    """(precision, recall, thresholds) with thresholds in INCREASING score order
    (sklearn's convention; precision/recall are aligned to it, with the (P=1, R=0)
    anchor appended last)."""
    gt, pred = _as_1d(gt, pred)
    order = np.argsort(-pred, kind="mergesort")
    gt_s = gt[order] > 0.5
    pred_s = pred[order]
    # collapse tied thresholds: keep last index of each distinct score
    distinct = np.flatnonzero(np.r_[pred_s[1:] != pred_s[:-1], True])
    tp = np.cumsum(gt_s)[distinct]
    fp = (distinct + 1) - tp
    n_pos = gt_s.sum()
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(n_pos, 1)
    # prepend the (P=1, R=0) anchor as sklearn does (appended at the front of rev order)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    thresholds = pred_s[distinct][::-1]
    return precision, recall, thresholds


def pr_auc(gt, pred) -> float:
    """PR-AUC via trapezoidal integration of the precision-recall curve
    (sklearn `auc(recall, precision)` semantics)."""
    precision, recall, _ = precision_recall_curve(gt, pred)
    # recall is decreasing in our ordering (reversed); integrate with sorted x
    r = recall[::-1]
    p = precision[::-1]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 fallback
    return float(trapezoid(p, r))


def compute_auprc(gt, pred) -> float:
    """Average precision (step-wise interpolation, sklearn average_precision_score)."""
    precision, recall, _ = precision_recall_curve(gt, pred)
    # arrays ordered by increasing threshold => recall decreasing along index
    # AP = sum (R_i - R_{i+1}) * P_i over the reversed (decreasing-recall) direction
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def pfbeta(gt, pred, beta: float = 1.0) -> float:
    """Probabilistic F-beta (RSNA breast-cancer challenge metric): precision/recall
    computed from raw probabilities rather than binarized predictions."""
    gt, pred = _as_1d(gt, pred)
    pred = np.clip(pred, 0.0, 1.0)
    pos = gt > 0.5
    ctp = pred[pos].sum()
    cfp = pred[~pos].sum()
    n_pos = int(pos.sum())
    if n_pos == 0:
        return 0.0
    c_precision = ctp / max(ctp + cfp, 1e-12)
    c_recall = ctp / n_pos
    if c_precision <= 0 or c_recall <= 0:
        return 0.0
    b2 = beta * beta
    return float((1 + b2) * c_precision * c_recall / (b2 * c_precision + c_recall))


def pfbeta_binarized(gt, pred) -> float:
    """Max probabilistic-F1 over binarization thresholds taken at the positive-class
    scores (the standard RSNA util this symbol refers to)."""
    gt, pred = _as_1d(gt, pred)
    thresholds = np.unique(pred[gt > 0.5])
    if thresholds.size == 0:
        return 0.0
    best = 0.0
    for th in thresholds:
        best = max(best, pfbeta(gt, (pred >= th).astype(np.float64), 1.0))
    return float(best)


def compute_accuracy_np_array(gt, pred) -> float:
    """Elementwise accuracy of already-binarized predictions
    (`Classifiers/experiments.py:85` calls it on thresholded cancer predictions)."""
    gt, pred = _as_1d(gt, pred)
    return float(np.mean(gt == pred))


def f1_macro(gt, pred, n_class: int | None = None) -> float:
    """Macro-averaged F1 over integer class labels (sklearn f1_score(average='macro'),
    used at `Classifiers/experiments.py:229-230` for density/birads)."""
    gt = np.asarray(gt).astype(np.int64).ravel()
    pred = np.asarray(pred).astype(np.int64).ravel()
    classes = np.unique(np.concatenate([gt, pred])) if n_class is None else np.arange(n_class)
    f1s = []
    for c in classes:
        tp = np.sum((pred == c) & (gt == c))
        fp = np.sum((pred == c) & (gt != c))
        fn = np.sum((pred != c) & (gt == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(f1s))


def optimal_roc_threshold(gt, pred) -> float:
    """Youden-J optimal ROC threshold (reference computes this for FP/FN dumps at
    `single_gpu_experiments.py:593-616`)."""
    gt, pred = _as_1d(gt, pred)
    order = np.argsort(-pred, kind="mergesort")
    gt_s = gt[order] > 0.5
    pred_s = pred[order]
    # evaluate Youden J only at DISTINCT thresholds: `pred >= th` cannot stop
    # inside a tie group, so mid-tie cumulative positions are unreachable
    # operating points and argmax over them can pick a threshold whose
    # achievable J is suboptimal
    distinct = np.flatnonzero(np.r_[pred_s[1:] != pred_s[:-1], True])
    tp = np.cumsum(gt_s)[distinct]
    fp = (distinct + 1) - tp
    n_pos = max(int(gt_s.sum()), 1)
    n_neg = max(len(gt_s) - int(gt_s.sum()), 1)
    j = tp / n_pos - fp / n_neg
    return float(pred_s[distinct][int(np.argmax(j))])
