"""Exact top-k over the generated rows, in float32 and in blocks: the
yardstick of the search cells; and its int8 control.

The rows are regenerated block by block from the seed (``rows_fn(start,
stop)``), as the benchmark made them before the program cast them, so the
reference never reads the program's bf16 copy. Scores are fp32 matrix
products with TF32 off. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

RowsFn = Callable[[int, int], torch.Tensor]


def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    return prev


@torch.no_grad()
def exact(rows_fn: RowsFn, n: int, queries: torch.Tensor, ids: torch.Tensor, k: int,
          block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the k-th best exact score of each query, the exact scores of the rows
    ``ids`` (nq, m) names), both fp32. ``ids`` outside [0, n) score NaN."""
    prev = _no_tf32()
    try:
        q = queries.float()
        nq = q.shape[0]
        best = torch.full((nq, k), -float("inf"), device=q.device)
        got = torch.full(ids.shape, float("nan"), device=q.device)
        ids = ids.to(q.device, torch.int64)
        for start in range(0, n, block):
            stop = min(n, start + block)
            s = q @ rows_fn(start, stop).float().T
            best = torch.topk(torch.cat([best, s], dim=1), k, dim=1).values
            inside = (ids >= start) & (ids < stop)
            picked = s.gather(1, (ids - start).clamp(0, stop - start - 1))
            got = torch.where(inside, picked, got)
        return best[:, -1], got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _int8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes and fp32 scales."""
    scale = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


class Int8Control:
    """The control put in the index's place: rows and queries quantized to
    int8 per row (the step below the configuration's bf16), integer dot
    products summed in fp32 (TF32 off for the process), then scaled;
    ``search`` has the index's contract ((nq, k) fp32 scores and int32 ids,
    as numpy)."""

    def __init__(self, rows_fn: RowsFn, n: int, dim: int, device, block: int):
        _no_tf32()
        self.n, self.dim, self.block = n, dim, block
        codes, scales = [], []
        for start in range(0, n, block):
            c, s = _int8_rows(rows_fn(start, min(n, start + block)).float())
            codes.append(c)
            scales.append(s)
        self.codes = torch.cat(codes)
        self.scales = torch.cat(scales).reshape(1, -1)
        self.device = device

    @torch.no_grad()
    def search(self, queries, k: int = 10, **_):
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        qc, qs = _int8_rows(q)
        vals = torch.full((q.shape[0], k), -float("inf"), device=self.device)
        idxs = torch.zeros((q.shape[0], k), dtype=torch.int64, device=self.device)
        for start in range(0, self.n, self.block):
            stop = min(self.n, start + self.block)
            s = (qc.float() @ self.codes[start:stop].float().T) * qs * self.scales[:, start:stop]
            ids = torch.arange(start, stop, device=self.device).expand(q.shape[0], -1)
            top = torch.topk(torch.cat([vals, s], dim=1), k, dim=1)
            vals = top.values
            idxs = torch.cat([idxs, ids], dim=1).gather(1, top.indices)
        return vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()
