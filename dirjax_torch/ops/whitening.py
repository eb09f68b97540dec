"""PCA whitening with power-scaled variance (counterpart of
``dirjax/ops/whitening.py``):

    X_hat = (X - mean) @ components[:v].T / (m * variance[:v]^p)

optionally followed by L2 normalization. :class:`PCAParams` holds numpy
arrays, the checkpoint interop format; :func:`apply_whitening` runs on the
device of its input tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .normalize import l2_normalize

__all__ = ["PCAParams", "fit_pca", "apply_whitening", "whitening_matrix"]


class PCAParams(NamedTuple):
    """Arrays of an sklearn-style PCA."""

    mean: np.ndarray          # (D,)
    components: np.ndarray    # (K, D) rows = principal axes
    variance: np.ndarray      # (K,) explained variance (n-1 divisor)
    #: sklearn's ``whiten`` fit flag: the scaling applies only when it is set
    whiten: bool = True

    @staticmethod
    def from_sklearn(pca) -> "PCAParams":
        return PCAParams(mean=np.asarray(pca.mean_),
                         components=np.asarray(pca.components_),
                         variance=np.asarray(pca.explained_variance_),
                         whiten=bool(getattr(pca, "whiten", True)))


def fit_pca(X: np.ndarray, n_components: Optional[int] = None) -> PCAParams:
    """Full PCA as sklearn fits it: SVD of the centred matrix in fp64, signs
    fixed by svd_flip, variance with the n-1 divisor."""
    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    mean = X.mean(axis=0)
    U, S, Vt = np.linalg.svd(X - mean, full_matrices=False)
    max_abs = np.argmax(np.abs(U), axis=0)
    signs = np.sign(U[max_abs, range(U.shape[1])])
    Vt = Vt * signs[:, None]
    variance = (S ** 2) / (n - 1)
    k = n_components or min(n, d)
    return PCAParams(mean=mean.astype(np.float32),
                     components=Vt[:k].astype(np.float32),
                     variance=variance[:k].astype(np.float32))


def apply_whitening(X: torch.Tensor, pca: PCAParams, whitenp: float = 0.5,
                    whitenv: Optional[int] = None, whitenm: float = 1.0,
                    l2norm: bool = True) -> torch.Tensor:
    """Whiten descriptor rows in fp32 on ``X``'s device.

    An eigenvalue of exactly 0 (a rank-deficient fit) gives a column of 0,
    where dividing by 0^p would give NaN; positive eigenvalues divide
    unfloored, as in the reference."""
    dev = X.device
    mean = torch.as_tensor(np.asarray(pca.mean, np.float32), device=dev)
    comps = torch.as_tensor(np.asarray(pca.components[:whitenv], np.float32),
                            device=dev)
    var = torch.as_tensor(np.asarray(pca.variance[:whitenv], np.float32),
                          device=dev)
    Xt = (X.float() - mean) @ comps.T
    if bool(pca.whiten):
        scaled = Xt / (whitenm * var.clamp_min(1e-38).pow(whitenp))
        Xt = torch.where(var > 0, scaled, torch.zeros((), device=dev))
    return l2_normalize(Xt) if l2norm else Xt


def whitening_matrix(pca: PCAParams, whitenp: float = 0.5,
                     whitenv: Optional[int] = None, whitenm: float = 1.0):
    """Fold the whitening into (W, b) with X_hat = X @ W + b, under the same
    dead-direction rule as :func:`apply_whitening`."""
    comps = np.asarray(pca.components[:whitenv], dtype=np.float64)
    var = np.asarray(pca.variance[:whitenv], dtype=np.float64)
    if bool(pca.whiten):
        scale = np.where(var > 0, 1.0 / (whitenm * np.power(
            np.maximum(var, 1e-300), whitenp)), 0.0)
    else:
        scale = np.ones_like(var)
    W = comps.T * scale[None, :]
    b = -np.asarray(pca.mean, dtype=np.float64) @ W
    return W.astype(np.float32), b.astype(np.float32)
