"""Recall auto-tuning for approximate serving indexes (the port's copy of
``dirjax/tuning.py``, tuning the port's index classes).

One change from the original: the imports name :mod:`dirjax_torch.serving`.
An asymmetric :class:`~dirjax_torch.serving.BinaryIndex` on a mesh sweeps
``rerank_factor``, as dirjax's does; on one device it is measured once.

The reference toolbox ranks exactly (a dense fp32 matmul,
``dirtorch/utils/common.py:30-38``) so it has no recall knobs; dirjax's
compressed tiers do — :class:`~dirjax.serving.IVFPQIndex` trades recall
for scan fraction via ``nprobe`` and both PQ classes via ``rerank_factor``. Picking them by hand means guessing. This module
measures recall@k against an exact ground truth on a query sample and
returns the CHEAPEST knob setting that meets a target — the
faiss-autotune workflow, on the dirjax serving API.

Cost ordering is structural, not timed: ``nprobe`` multiplies the
scanned-cell count (the dominant ADC cost, PERF_NOTES.md IVF section) and
``rerank_factor`` multiplies the exact-rescore gather width, so the sweep
walks (nprobe, rerank_factor) in lexicographic cost order and stops at
the first configuration that reaches the target. Timing-based tuning
through a remote link would measure dispatch overhead, not kernels —
structural order is the honest proxy.

Expectations to bring to a tuning run (measured on real R101-GeM
descriptor spectra, both random-init flat and fine-tuned concentrated —
``recall_study.py`` / RECALL_r05.json / PERF_NOTES "Recall on realistic
descriptor spectra"): int8 is near-lossless on any spectrum; 32-64 B
PQ/OPQ codebooks are SPECTRUM-GATED — R@10 0.03-0.11 on the flat
worst case (no knob setting rescues them; ``tune`` then honestly
returns ``met=False`` with best-effort knobs) but 0.45-0.74 once the
variance concentrates (rank-for-99% ~100); ITQ-2048 asym holds R@10
0.64-0.92 across the same pair; PQ after a ``whitenv`` dim reduction
tunes to target against its own space's exact oracle on both spectra;
and IVF's m32/ks16 residual ADC stays under R@10 0.45 even trained —
its knob is scan fraction, not recall. A ``met=False`` result is a
signal to change TIER (or reduce dims first), not to re-run with a
wider grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["TuneResult", "exact_ground_truth", "recall_at_k", "tune"]


def recall_at_k(idxs, gt_idxs) -> float:
    """Mean |returned ∩ ground-truth| / k over queries. Both arrays are
    (nq, k) index matrices; -1 entries (padding) never match."""
    idxs = np.asarray(idxs)
    gt = np.asarray(gt_idxs)
    assert idxs.shape[0] == gt.shape[0], (idxs.shape, gt.shape)
    hits = sum(len(set(r[r >= 0].tolist()) & set(g[g >= 0].tolist()))
               for r, g in zip(idxs, gt))
    # denominator: VALID ground-truth entries — -1 padding (corpus
    # smaller than k) must not make a perfect index read as recall < 1
    denom = int((gt >= 0).sum())
    return hits / float(denom) if denom else 1.0


def exact_ground_truth(queries, descriptors, k: int,
                       chunk: int = 65536) -> np.ndarray:
    """Exact top-k indices by blocked host matmul (the oracle the tuned
    index is graded against). Host-side on purpose: the tuner runs where
    the raw descriptors live, which for compressed tiers is usually a
    file, not HBM."""
    q = np.asarray(queries, np.float32)
    db = np.asarray(descriptors, np.float32)
    best_v = np.full((len(q), k), -np.inf, np.float32)
    best_i = np.full((len(q), k), -1, np.int64)
    for lo in range(0, len(db), chunk):
        s = q @ db[lo:lo + chunk].T
        cand_v = np.concatenate([best_v, s], axis=1)
        cand_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(lo, lo + s.shape[1]),
                                     s.shape)], axis=1)
        sel = np.argsort(-cand_v, axis=1, kind="stable")[:, :k]
        best_v = np.take_along_axis(cand_v, sel, axis=1)
        best_i = np.take_along_axis(cand_i, sel, axis=1)
    return best_i


@dataclass
class TuneResult:
    """Outcome of a :func:`tune` sweep."""
    params: dict                  #: cheapest knobs meeting the target
    recall: float                 #: recall@k measured at ``params``
    target: float
    met: bool                     #: False -> best-effort (max knobs)
    trials: list = field(default_factory=list)  #: [(params, recall), ...]

    def apply(self, index) -> None:
        """Write the tuned knobs onto the index (``nprobe`` becomes the
        index default; ``rerank_factor`` is per-call — pass
        ``self.params`` to ``search``)."""
        if "nprobe" in self.params:
            index.nprobe = self.params["nprobe"]


def _nprobe_ladder(nlist: int) -> list:
    out, p = [], 1
    while p < nlist:
        out.append(p)
        p *= 2
    out.append(nlist)
    return out


def tune(index, queries, ground_truth=None, *, k: int = 10,
         target: float = 0.95, descriptors=None,
         nprobes: Optional[Sequence[int]] = None,
         rerank_factors: Sequence[int] = (1, 2, 4, 8, 16)) -> TuneResult:
    """Find the cheapest knob setting with recall@k >= ``target``.

    ``ground_truth`` is an (nq, k) exact-neighbor index matrix; pass
    ``descriptors=`` (the raw build-time matrix) to have it computed via
    :func:`exact_ground_truth`. Knobs swept per index class:

    * ``IVFPQIndex`` — ``nprobe`` (powers of two up to the virtual-cell
      count, where probing becomes exhaustive), and
      ``rerank_factor`` when the index keeps int8 rerank rows;
    * ``PQIndex`` — ``rerank_factor`` (rerank indexes; plain ADC has no
      knob and just gets measured);
    * ``BinaryIndex`` — ``rerank_factor`` on MESH indexes only (the
      per-shard asymmetric-rescore shortlist width); single-chip
      searches are exact under their score (symmetric integers, or the
      r5 exact-asym ranking) and just get measured;
    * ``RetrievalIndex`` — exact already: measured once, no sweep.

    Returns the first (cheapest) configuration meeting the target, or
    ``met=False`` with the best-recall configuration tried."""
    from .serving import BinaryIndex, IVFPQIndex, PQIndex, RetrievalIndex

    q = np.asarray(queries, np.float32)
    if ground_truth is None:
        if descriptors is None:
            raise ValueError("pass ground_truth= or descriptors=")
        ground_truth = exact_ground_truth(q, descriptors, k)
    gt = np.asarray(ground_truth)
    if gt.shape[1] < k:
        # a narrower truth silently INFLATES recall (the denominator
        # shrinks while search still returns k hits) -> wrong knobs
        raise ValueError(f"ground_truth has {gt.shape[1]} columns; "
                         f"tuning recall@{k} needs at least k")
    gt = gt[:, :k]

    has_rerank = getattr(index, "_rerank_db", None) is not None
    rfs = list(rerank_factors) if has_rerank else [None]

    if isinstance(index, IVFPQIndex):
        # exactness requires nprobe >= the VIRTUAL cell count (split
        # imbalanced lists), which can exceed nlist — top the ladder
        # there or the sweep never reaches the exhaustive setting
        ladder = list(nprobes) if nprobes is not None \
            else _nprobe_ladder(index._ivf.nvlist)
        grid = [(dict(nprobe=p, **({} if rf is None
                                   else {"rerank_factor": rf})))
                for p in ladder for rf in rfs]
        # lexicographic (nprobe, rerank_factor) == ascending cost
    elif isinstance(index, PQIndex):
        grid = [({} if rf is None else {"rerank_factor": rf})
                for rf in rfs]
    elif isinstance(index, BinaryIndex):
        # single-chip asym search is EXACT under the asym score (r5 —
        # no shortlist knob left to tune); the mesh path still rescores
        # per-shard Hamming shortlists of rerank_factor*k
        grid = [{"rerank_factor": rf} for rf in rerank_factors] \
            if (index.asym and index.mesh is not None) else [{}]
    elif isinstance(index, RetrievalIndex):
        grid = [{}]
    else:
        raise TypeError(f"unknown index type {type(index).__name__}")

    trials = []
    best: Tuple[float, dict] = (-1.0, {})
    for params in grid:
        idxs = index.search(q, k=k, **params)[1]
        r = recall_at_k(idxs, gt)
        trials.append((dict(params), r))
        if r > best[0]:
            best = (r, dict(params))
        if r >= target:
            return TuneResult(params=dict(params), recall=r,
                              target=target, met=True, trials=trials)
    return TuneResult(params=best[1], recall=best[0], target=target,
                      met=False, trials=trials)
