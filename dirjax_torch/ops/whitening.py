"""PCA whitening with power-scaled variance (counterpart of
``dirjax/ops/whitening.py``):

    X_hat = (X - mean) @ components[:v].T / (m * variance[:v]^p)

optionally followed by L2 normalization. :class:`PCAParams` holds numpy
arrays, the checkpoint interop format; :func:`apply_whitening` runs on the
device of its input tensor. :func:`fit_pca` fits on the host by SVD;
:func:`fit_pca_device` streams row chunks through the card and
eigendecomposes the (D, D) covariance on the host.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Union

import numpy as np
import torch

from .normalize import l2_normalize

__all__ = ["PCAParams", "fit_pca", "fit_pca_device", "apply_whitening",
           "whitening_matrix"]


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


def _device_moments(X, dev: torch.device):
    """(rows, fp32 column sum, fp32 Gram matrix) of one (N, D) array or an
    iterable of row chunks, accumulated on ``dev``; raises below 2 rows, and
    on a card when TF32 is on for matmuls (a process-wide flag, which this
    function reads and never sets: another thread may be using it)."""
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("fit_pca_device needs fp32 products: set "
                         "torch.backends.cuda.matmul.allow_tf32 = False")
    chunks = [X] if hasattr(X, "shape") else X
    s1 = s2 = None
    n = 0
    for c in chunks:
        c = torch.as_tensor(c).to(dev, torch.float32)
        if s1 is None:
            s1 = torch.zeros((c.shape[1],), dtype=torch.float32, device=dev)
            s2 = torch.zeros((c.shape[1], c.shape[1]), dtype=torch.float32, device=dev)
        s1 += c.sum(dim=0)
        s2 += c.T @ c
        n += int(c.shape[0])
    if n < 2:
        raise ValueError(f"need at least 2 rows to fit a PCA, got {n}")
    return n, s1, s2


def fit_pca_device(X: Union[torch.Tensor, np.ndarray, Iterable],
                   n_components: Optional[int] = None, *,
                   device="cuda") -> PCAParams:
    """Covariance PCA for corpora too large for :func:`fit_pca`'s host SVD
    (counterpart of ``dirjax/ops/whitening.py:71-136``).

    ``X`` is one (N, D) array or tensor, or an iterable of row chunks (a
    corpus that never fits on the card at once). On ``device`` each chunk
    adds to an fp32 column sum and an fp32 (D, D) Gram matrix. The caller
    keeps TF32 off for matmuls (PyTorch's default; the CLIs' device setup
    turns it off), the counterpart of dirjax's ``precision=HIGHEST``: TF32
    products shift small eigenvalues, so a card fit with TF32 on raises.
    Only the sum and the Gram matrix go
    to the host, where the covariance is eigendecomposed in fp64. Component
    signs follow dirjax's rule (each row's largest-|entry| positive), and at
    most min(N, D) components are kept. Raises below 2 rows."""
    n, s1, s2 = _device_moments(X, torch.device(device))
    mean = s1.cpu().numpy().astype(np.float64) / n
    cov = (s2.cpu().numpy().astype(np.float64) - n * np.outer(mean, mean)) / (n - 1)
    w, v = np.linalg.eigh(cov)                     # ascending
    order = np.argsort(w)[::-1]
    w = np.clip(w[order], 0.0, None)
    comps = v[:, order].T                          # rows = principal axes
    max_abs = np.argmax(np.abs(comps), axis=1)
    signs = np.sign(comps[np.arange(comps.shape[0]), max_abs])
    signs[signs == 0] = 1.0
    comps = comps * signs[:, None]
    k = n_components or min(n, comps.shape[0])
    return PCAParams(mean=mean.astype(np.float32),
                     components=comps[:k].astype(np.float32),
                     variance=w[:k].astype(np.float32))


def apply_whitening(X: torch.Tensor, pca: PCAParams, whitenp: float = 0.5,
                    whitenv: Optional[int] = None, whitenm: float = 1.0,
                    l2norm: bool = True, dead_floor: float = 0.0) -> torch.Tensor:
    """Whiten descriptor rows in fp32 on ``X``'s device.

    An eigenvalue of exactly 0 (a rank-deficient fit) gives a column of 0,
    where dividing by 0^p would give NaN; positive eigenvalues divide
    unfloored, as in the reference. ``dead_floor > 0`` also zeroes every
    direction whose variance is at most ``max(variance) * dead_floor`` (the
    fp32 noise directions of a rank-deficient fit, which ``var^-p`` would
    blow up), as dirjax's ``dead_floor`` does."""
    dev = X.device
    mean = torch.as_tensor(np.asarray(pca.mean, np.float32), device=dev)
    comps = torch.as_tensor(np.asarray(pca.components[:whitenv], np.float32),
                            device=dev)
    var = torch.as_tensor(np.asarray(pca.variance[:whitenv], np.float32),
                          device=dev)
    Xt = (X.float() - mean) @ comps.T
    if bool(pca.whiten):
        floor = var.max() * dead_floor
        scaled = Xt / (whitenm * torch.maximum(var, floor.clamp_min(1e-38)).pow(whitenp))
        Xt = torch.where(var > floor, scaled, torch.zeros((), device=dev))
    return l2_normalize(Xt) if l2norm else Xt


def whitening_matrix(pca: PCAParams, whitenp: float = 0.5,
                     whitenv: Optional[int] = None, whitenm: float = 1.0,
                     dead_floor: float = 0.0):
    """Fold the whitening into (W, b) with X_hat = X @ W + b, under the same
    dead-direction rule as :func:`apply_whitening`, ``dead_floor`` included."""
    comps = np.asarray(pca.components[:whitenv], dtype=np.float64)
    var = np.asarray(pca.variance[:whitenv], dtype=np.float64)
    if bool(pca.whiten):
        floor = float(var.max()) * dead_floor
        scale = np.where(var > floor, 1.0 / (whitenm * np.power(
            np.maximum(var, max(floor, 1e-300)), whitenp)), 0.0)
    else:
        scale = np.ones_like(var)
    W = comps.T * scale[None, :]
    b = -np.asarray(pca.mean, dtype=np.float64) @ W
    return W.astype(np.float32), b.astype(np.float32)
