"""Retrieval losses: differentiable AP (listwise), tie-aware AP, triplets
(counterpart of ``dirjax/loss.py``, the training objectives of "Learning
with Average Precision", Revaud et al. ICCV'19).

* :class:`APLoss` — AP through score quantization: a bank of nq triangular
  kernels ``q_i(x) = clamp(1 - a*|x - c_i|, 0)`` over bin centers c_i, with
  the two boundary bins saturating to 1 beyond the range.
* :class:`TAPLoss` — tie-aware variant, exact and simplified forms.
* :class:`TripletMarginLoss` / :class:`TripletLogExpLoss` — pairwise
  distance triplet objectives.
* :func:`sim_to_dist` + ``*_dist`` wrappers.

The losses are plain functions and frozen dataclasses on tensors (they have
no parameters) and differentiate through autograd. Where the scores sit on
a clip boundary or two branches tie, the gradient splits as jax splits it:
every clip is ``torch.minimum(torch.maximum(x, lo), hi)``, whose ties give
each side half, as ``jnp.clip`` does (``torch.clamp`` gives the input all
of it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "quantize_scores", "APLoss", "TAPLoss", "APLoss_dist", "TAPLoss_dist",
    "TripletMarginLoss", "TripletLogExpLoss", "sim_to_dist",
]


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with jax's gradient at the bounds (a tie of
    ``maximum``/``minimum`` gives each side half)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def quantize_scores(x: torch.Tensor, nq: int, min_val: float, max_val: float
                    ) -> torch.Tensor:
    """Soft-assign scores (N, M) to nq triangular bins -> (N, nq, M).

    Bin i has center ``c_i = max - i*gap/(nq-1)`` (descending), slope
    ``a=(nq-1)/gap``; bin 0 saturates at 1 for x >= c_0 and bin nq-1 for
    x <= c_{nq-1}.
    """
    gap = max_val - min_val
    a = (nq - 1) / gap
    i = torch.arange(nq, dtype=x.dtype, device=x.device)
    first, last = (i == 0)[None, :, None], (i == nq - 1)[None, :, None]
    # first half: f1_i = -a*x + a*min + (nq - i); row 0 overridden to 1
    f1 = -a * x[:, None, :] + (a * min_val + (nq - i))[None, :, None]
    f1 = torch.where(first, 1.0, f1)
    # second half: f2_i = a*x + (2 - nq + i) - a*min; row nq-1 overridden to 1
    f2 = a * x[:, None, :] + ((2.0 - nq + i) - a * min_val)[None, :, None]
    f2 = torch.where(last, 1.0, f2)
    return _clip(torch.minimum(f1, f2), 0.0)


@dataclass(frozen=True)
class APLoss:
    """1 - mAP over quantized precision/recall.

    Inputs: ``x`` (N, M) scores in [min, max]; ``label`` (N, M) in {0, 1}.
    """

    nq: int = 25
    min: float = 0.0
    max: float = 1.0

    def __post_init__(self):
        if not (isinstance(self.nq, int) and 2 <= self.nq <= 100):
            raise ValueError(f"nq must be an int in [2, 100], got {self.nq!r}")
        if not self.max - self.min > 0:
            raise ValueError(f"max ({self.max}) must exceed min ({self.min})")

    def ap(self, x, label, eps: float = 1e-16):
        q = quantize_scores(x, self.nq, self.min, self.max)  # (N, Q, M)
        label = label.to(q.dtype)
        nbs = q.sum(dim=-1)                                   # (N, Q)
        rec = (q * label[:, None, :]).sum(dim=-1)             # (N, Q)
        prec = torch.cumsum(rec, dim=-1) / (eps + torch.cumsum(nbs, dim=-1))
        # safe divide: a query with no positives gets AP 0, not NaN
        rec = rec / torch.maximum(rec.sum(dim=-1, keepdim=True), rec.new_tensor(eps))
        return (prec * rec).sum(dim=-1)                       # (N,)

    def __call__(self, x, label, qw=None, ret: str = "1-mAP"):
        ap = self.ap(x, label)
        if ret == "1-mAP":
            if qw is not None:
                ap = ap * qw
            return 1.0 - ap.mean()
        if ret == "AP":
            if qw is not None:
                raise ValueError("ret='AP' takes no query weights")
            return ap
        raise ValueError(f"Bad return type for APLoss(): {ret}")

    def measures(self, x, gt, loss=None):
        if loss is None:
            loss = self(x, gt)
        return {"loss_ap": float(loss)}


@dataclass(frozen=True)
class TAPLoss(APLoss):
    """Tie-aware AP."""

    simplified: bool = False

    def ap(self, x, label, eps: float = 1e-8):
        q = quantize_scores(x, self.nq, self.min, self.max)  # (N, Q, M)
        label = label.to(q.dtype)
        n_pos = torch.maximum(label.sum(dim=-1, keepdim=True), label.new_tensor(eps))

        c = q.sum(dim=-1)                                     # (N, Q)
        cp = (q * label[:, None, :]).sum(dim=-1)              # (N, Q)
        C = torch.cumsum(c, dim=-1)
        Cp = torch.cumsum(cp, dim=-1)
        C_1d = F.pad(C[:, :-1], (1, 0))
        Cp_1d = F.pad(Cp[:, :-1], (1, 0))

        if self.simplified:
            aps = cp * (Cp_1d + Cp + 1) / (C_1d + C + 1) / n_pos
        else:
            ratio = _clip(cp - 1, 0.0) / (_clip(c - 1, 0.0) + eps)
            aps = (cp * (c * ratio + (Cp_1d + 1 - ratio * (C_1d + 1))
                         * torch.log((C + 1) / (C_1d + 1)))
                   / (c + eps) / n_pos)
        return aps.sum(dim=-1)

    def measures(self, x, gt, loss=None):
        if loss is None:
            loss = self(x, gt)
        key = "loss_tap" + ("s" if self.simplified else "")
        return {key: float(loss)}


def sim_to_dist(scores):
    """Cosine similarity -> a distance."""
    return 1.0 - torch.sqrt(2.001 - 2.0 * scores)


@dataclass(frozen=True)
class APLoss_dist(APLoss):
    def __call__(self, x, label, **kw):
        return APLoss.__call__(self, sim_to_dist(x), label, **kw)


@dataclass(frozen=True)
class TAPLoss_dist(TAPLoss):
    def __call__(self, x, label, **kw):
        return TAPLoss.__call__(self, sim_to_dist(x), label, **kw)


def _pairwise_distance(a, b, p: float = 2.0, eps: float = 1e-6):
    return torch.pow(torch.sum(torch.abs(a - b + eps) ** p, dim=-1), 1.0 / p)


@dataclass(frozen=True)
class TripletMarginLoss:
    """max(0, d(a,p) - d(a,n) + margin), mean over the batch (torch
    TripletMarginLoss semantics)."""

    margin: float = 1.0
    p: float = 2.0
    eps: float = 1e-6
    swap: bool = False

    def __call__(self, anchor, positive, negative):
        d_p = _pairwise_distance(anchor, positive, self.p, self.eps)
        d_n = _pairwise_distance(anchor, negative, self.p, self.eps)
        if self.swap:
            d_s = _pairwise_distance(positive, negative, self.p, self.eps)
            d_n = torch.minimum(d_n, d_s)
        return torch.mean(_clip(d_p - d_n + self.margin, 0.0))

    def from_distances(self, d_p, d_n):
        """Per-anchor loss from already-mined distances (batch-hard path)."""
        return _clip(d_p - d_n + self.margin, 0.0)

    def eval_func(self, dp, dn):
        return max(0.0, dp - dn + self.margin)


@dataclass(frozen=True)
class TripletLogExpLoss:
    """log(1 + exp(d(a,p) - d(a,n)))."""

    p: float = 2.0
    eps: float = 1e-6
    swap: bool = False

    def __call__(self, anchor, positive, negative):
        if anchor.dim() != 2:
            raise ValueError(f"anchor must be (N, D), got {tuple(anchor.shape)}")
        d_p = _pairwise_distance(anchor, positive, self.p, self.eps)
        d_n = _pairwise_distance(anchor, negative, self.p, self.eps)
        if self.swap:
            d_s = _pairwise_distance(positive, negative, self.p, self.eps)
            d_n = torch.minimum(d_n, d_s)
        return torch.mean(torch.log1p(torch.exp(d_p - d_n)))

    def from_distances(self, d_p, d_n):
        """Per-anchor loss from already-mined distances (batch-hard path)."""
        return torch.log1p(torch.exp(d_p - d_n))

    def eval_func(self, dp, dn):
        return np.log(1 + np.exp(dp - dn))
