"""Retrieval evaluation metrics (host-side, pure numpy).

The port's own copy of ``dirjax/utils/evaluation.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Implements the three AP conventions used by the reference toolbox
(``dirtorch/utils/evaluation.py``):

* :func:`average_precision_revisited` — the Revisited-Oxford/Paris
  trapezoidal convention (reference ``evaluation.py:46-82``, credited there
  to TF-DELF): integrates the precision/recall curve by averaging adjacent
  precision points per positive rank.
* :func:`average_precision_classic` — the finite-sum AP identical to
  ``sklearn.metrics.average_precision_score`` (reference ``evaluation.py:41-43``),
  reimplemented in numpy so the metric stack has no sklearn dependency.
* :func:`average_precision_quantized` — recall-checkpoint-quantized AP
  (reference ``evaluation.py:85-98``).

plus top-k accuracy (reference ``evaluation.py:8-38``) and the ground-truth
handling conventions of ``datasets/generic.py:196-224``: ground truth vectors
take values in {-1, 0, +1} where 0 marks *junk* images that are removed from
the ranking before AP is computed.

Everything here is deliberately host-side numpy: mAP evaluation is a
once-per-benchmark reduction over at most a few thousand queries; the
device-side work (descriptor extraction, score matrix, top-k) lives in
``dirjax.ops`` / ``dirjax.parallel``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "average_precision_revisited",
    "average_precision_classic",
    "average_precision_quantized",
    "positive_ranks_from_scores",
    "ap_from_gt_scores",
    "revisited_ap_modes",
    "accuracy_topk",
    "mean_excluding_invalid",
]


def average_precision_revisited(positive_ranks: np.ndarray) -> float:
    """AP per the Revisited Oxford/Paris convention.

    ``positive_ranks`` is a sorted, zero-indexed integer array giving the
    ranks of *all* expected positive images within the (junk-stripped)
    ranking. Empty input yields 0. Between consecutive positives the
    precision/recall curve is integrated with the trapezoid rule: for the
    i-th positive (0-based) found at rank r, the precision just left of it
    is ``i / r`` (defined as 1 when r == 0) and just right of it is
    ``(i + 1) / (r + 1)``.
    """
    positive_ranks = np.asarray(positive_ranks)
    n_pos = len(positive_ranks)
    if n_pos == 0:
        return 0.0
    i = np.arange(n_pos, dtype=np.float64)
    ranks = positive_ranks.astype(np.float64)
    # precision left of rank 0 is defined as 1 (one convention, one guard)
    left = np.where(ranks == 0, 1.0, i / np.maximum(ranks, 1.0))
    right = (i + 1.0) / (ranks + 1.0)
    return float(np.sum(left + right) / (2.0 * n_pos))


def average_precision_classic(labels: np.ndarray, scores: np.ndarray) -> float:
    """Finite-sum AP, numerically identical to sklearn's
    ``average_precision_score`` for binary labels.

    AP = sum_k (R_k - R_{k-1}) * P_k over descending-score ranks k, with
    ties handled as sklearn does (precision/recall evaluated per distinct
    threshold).
    """
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    sorted_scores = scores[order]
    sorted_labels = labels[order]
    # indices of the last occurrence of each distinct threshold value
    distinct = np.where(np.diff(sorted_scores))[0]
    threshold_idx = np.r_[distinct, sorted_labels.size - 1]
    tp = np.cumsum(sorted_labels)[threshold_idx].astype(np.float64)
    total = (threshold_idx + 1).astype(np.float64)
    precision = tp / total
    recall = tp / float(n_pos)
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def average_precision_quantized(labels, order, step: float = 0.01) -> float:
    """Recall-checkpoint AP: mean over checkpoints v of the best precision
    achieved at recall > v (reference ``evaluation.py:85-98``)."""
    labels = np.asarray(labels)
    order = np.asarray(order)
    checkpoints = np.arange(0, 1, step)
    n_rel = labels.sum()
    if n_rel == 0:
        return 0.0
    hits = np.cumsum(labels[order]).astype(np.float64)
    recall = hits / float(n_rel)
    precision = hits / np.arange(1, len(order) + 1, dtype=np.float64)
    precs = [
        (precision[recall > v].max() if np.any(recall > v) else 0.0)
        for v in checkpoints
    ]
    return float(np.mean(precs))


def positive_ranks_from_scores(gt: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Junk-aware rank extraction (reference ``generic.py:196-224``).

    ``gt`` takes values in {-1, 0, +1}; entries with gt == 0 (junk) are
    removed from the ranking entirely, then the remaining items are sorted
    by descending score (matching the reference's ``np.argsort(scores)[::-1]``
    tie order) and the 0-indexed ranks of positives returned.
    """
    gt = np.asarray(gt)
    scores = np.asarray(scores)
    assert gt.shape == scores.shape, f"scores should have shape {gt.shape}"
    assert -1 <= gt.min() and gt.max() <= 1, "bad ground-truth labels"
    keep = gt != 0
    gt_kept, scores_kept = gt[keep], scores[keep]
    # NB: match the reference's exact tie-breaking: argsort ascending (stable
    # default quicksort order is irrelevant for distinct scores) then reverse.
    gt_sorted = gt_kept[np.argsort(scores_kept)[::-1]]
    return np.where(gt_sorted == 1)[0]


def ap_from_gt_scores(gt: np.ndarray, scores: np.ndarray) -> float:
    """Revisited-convention AP from a {-1,0,1} GT vector and raw scores.

    Returns -1 when the query has no positives (the caller excludes such
    queries from the mean, reference ``test_dir.py:159``)."""
    ranks = positive_ranks_from_scores(gt, scores)
    if len(ranks) == 0:
        return -1.0
    return average_precision_revisited(ranks)


def revisited_ap_modes(gt_by_mode: dict, scores: np.ndarray) -> dict:
    """Evaluate the easy/medium/hard protocol given per-mode GT vectors."""
    return {mode: ap_from_gt_scores(gt, scores) for mode, gt in gt_by_mode.items()}


def accuracy_topk(scores: np.ndarray, target: np.ndarray, topk=(1,)) -> list:
    """precision@k over a batch: fraction of rows whose target label index
    appears in the top-k scored entries (reference ``evaluation.py:8-27``)."""
    scores = np.asarray(scores)
    target = np.asarray(target)
    pred = (-scores).argsort(axis=1)
    correct = pred == target[:, None]
    return [float(correct[:, :k].sum() / target.size) for k in topk]


def mean_excluding_invalid(values) -> float:
    """Mean over AP values, skipping queries marked invalid with -1."""
    vals = [float(v) for v in values if v >= 0]
    return float(np.mean(vals)) if vals else float("nan")
