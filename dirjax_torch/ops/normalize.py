"""L2 normalization (counterpart of ``dirjax/ops/normalize.py``): division by
max(norm, eps), the semantics of ``torch.nn.functional.normalize``."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||_2, eps) along ``dim``."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
