"""Index rows and query rows drawn from the seed on the device.

The database is a landmark set's descriptors among distractors, as
ROxford5k + R1M is: ``landmark_rows`` rows around ``landmarks`` centres
(each row the centre plus Gaussian noise of ``landmark_spread`` times its
norm, so rows of one landmark lie at a cosine of about 0.5 to each other
and 0.7 to their centre), then ``distractor_rows`` rows uniform on the
sphere. Every row is unit-norm fp32. Rows come in blocks of ``BLOCK``, each
drawn by a generator of its own, so any block is made again alike for the
reference.

A query is a perturbed copy of a database row (``perturbed_share`` of them:
the row plus noise of ``perturb_sigma`` times its norm) or a fresh draw
from the sphere.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 65536


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True)


def _gen(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + salt) % 2 ** 63)


class IndexRows:
    """The database of a configuration's ``index`` group, block by block."""

    def __init__(self, index: dict, seed: int, device):
        self.dim = int(index["dim"])
        self.landmark_rows = int(index["landmark_rows"])
        self.n = self.landmark_rows + int(index["distractor_rows"])
        self.spread = float(index["landmark_spread"])
        self.seed, self.device = seed, device
        g = _gen(seed, 0, device)
        self.centres = _unit(torch.randn((int(index["landmarks"]), self.dim), generator=g,
                                         device=device))

    def block(self, b: int) -> torch.Tensor:
        """Rows [b * BLOCK, min(n, (b + 1) * BLOCK)), fp32."""
        start, stop = b * BLOCK, min(self.n, (b + 1) * BLOCK)
        g = _gen(self.seed, b + 1, self.device)
        x = torch.randn((stop - start, self.dim), generator=g, device=self.device)
        land = max(0, min(stop, self.landmark_rows) - start)
        if land:
            which = torch.randint(len(self.centres), (land,), generator=g, device=self.device)
            x[:land] = self.centres[which] + _unit(x[:land]) * self.spread
        return _unit(x)

    def rows(self, start: int, stop: int) -> torch.Tensor:
        """Rows [start, stop); ``start`` a multiple of BLOCK."""
        if start % BLOCK:
            raise ValueError("rows are made in whole blocks")
        parts = [self.block(b) for b in range(start // BLOCK, -(-stop // BLOCK))]
        return torch.cat(parts)[:stop - start]

    def all(self) -> torch.Tensor:
        out = torch.empty((self.n, self.dim), device=self.device)
        for b in range(-(-self.n // BLOCK)):
            out[b * BLOCK:(b + 1) * BLOCK] = self.block(b)
        return out


def queries(db: torch.Tensor, count: int, perturbed_share: float, sigma: float,
            seed: int) -> np.ndarray:
    """(count, dim) fp32 unit query rows on the host."""
    g = _gen(seed, -1, db.device)
    n, dim = db.shape
    x = torch.randn((count, dim), generator=g, device=db.device)
    perturbed = torch.rand(count, generator=g, device=db.device) < perturbed_share
    src = torch.randint(n, (count,), generator=g, device=db.device)
    x = torch.where(perturbed[:, None], db[src] + _unit(x) * sigma, x)
    return _unit(x).cpu().numpy()
