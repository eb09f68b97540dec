"""Operations and bytes of a vision transformer forward, from a configuration's
widths and the dtypes it states.

Nothing here reads the program. For an image of H x W pixels the grid is
(H // patch) x (W // patch) whole patches and the tokens N = 1 + registers +
the patches. Under the configuration's bf16 inference (what autocast gives
DINOv2): every linear layer and the attention read and write bf16 and sum
in fp32; LayerNorm reads and writes the fp32 residual stream; GELU reads
and writes bf16; each LayerScale residual update reads the fp32 stream and
the bf16 branch output and writes the stream; the head (K1) reads the fp32
final-normed patch map. Each input byte is read once and each output byte
written once (``peaks.py``).

At 1022 x 770 (73 x 55 patches, N = 4,020) ViT-L/14 takes 2.428 TFLOP in
its linear layers (24 x 24 N D^2), 1.589 TFLOP in attention (24 x 4 N^2 D),
0.005 in the patch embedding: 4.022 TFLOP an image.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from . import peaks

BF16, FP32 = 2, 4


def grid(model: dict, height: int, width: int) -> Tuple[int, int]:
    p = int(model["patch_size"])
    return height // p, width // p


def tokens(model: dict, height: int, width: int) -> int:
    h, w = grid(model, height, width)
    return 1 + int(model["num_registers"]) + h * w


@dataclass(frozen=True)
class Gemm:
    """One linear layer's launch: ``rows`` x ``k`` bf16 input, ``k`` x ``n``
    bf16 weight and bias, ``rows`` x ``n`` bf16 output."""

    rows: int
    k: int
    n: int

    @property
    def ops(self) -> float:
        return 2.0 * self.rows * self.k * self.n

    @property
    def nbytes(self) -> float:
        return BF16 * (self.rows * self.k + self.k * self.n + self.n + self.rows * self.n)

    @property
    def bound_s(self) -> float:
        return peaks.bound_s(self.nbytes, self.ops, "bf16")


def gemms(model: dict, batch: int, height: int, width: int) -> List[Gemm]:
    """The linear layers of one forward in launch order: the patch embedding
    (its patch rows), then each block's qkv, proj, fc1 and fc2."""
    d, m, p = int(model["embed_dim"]), int(model["mlp_dim"]), int(model["patch_size"])
    h, w = grid(model, height, width)
    rows = batch * tokens(model, height, width)
    out = [Gemm(batch * h * w, p * p * 3, d)]
    for _ in range(int(model["depth"])):
        out += [Gemm(rows, d, 3 * d), Gemm(rows, d, d), Gemm(rows, d, m), Gemm(rows, m, d)]
    return out


def attention_ops(model: dict, batch: int, height: int, width: int) -> float:
    """One layer's attention: q k^T and the weighted sum of v, 4 N^2 D."""
    n = tokens(model, height, width)
    return 4.0 * batch * n * n * int(model["embed_dim"])


def attention_bound_s(model: dict, batch: int, height: int, width: int) -> float:
    """One layer's attention launch: q, k, v read and the output written in
    bf16, or its operations at the bf16 peak."""
    n, d = tokens(model, height, width), int(model["embed_dim"])
    return peaks.bound_s(4 * BF16 * batch * n * d, attention_ops(model, batch, height, width))


def pointwise_bounds(model: dict, batch: int, height: int, width: int) -> dict:
    """Bounds in seconds of one launch of each memory-bound pass, by kind:
    ``layer_norm`` (a block's norm1 or norm2: the fp32 stream read, fp32
    written; the final norm over the patch tokens counted as one of them),
    ``gelu`` (fc1's bf16 output read and written) and ``residual`` (a
    LayerScale update: the fp32 stream and the bf16 branch read, the
    stream written)."""
    n, d, m = tokens(model, height, width), int(model["embed_dim"]), int(model["mlp_dim"])
    x = batch * n * d
    return {"layer_norm": peaks.bound_s(2 * FP32 * x, 0.0),
            "gelu": peaks.bound_s(2 * BF16 * batch * n * m, 0.0),
            "residual": peaks.bound_s((2 * FP32 + BF16) * x, 0.0)}


def gem_head_launches(model: dict, batch: int, height: int, width: int):
    """Bounds, in seconds, of K1's two launches on the fp32 (batch, h, w, D)
    patch map: the pool (the map read, fp32 pooled features written) and
    the projection with the L2 (pooled features, fp32 FC weight and bias
    read, descriptors written; 2 B C D fp32 operations)."""
    h, w = grid(model, height, width)
    c, d = int(model["fc_in"]), int(model["out_dim"])
    pool = peaks.bound_s(batch * h * w * c * FP32 + batch * c * FP32, 0.0)
    project = peaks.bound_s(batch * c * FP32 + c * d * FP32 + d * FP32 + batch * d * FP32,
                            2.0 * batch * c * d, "fp32")
    return pool, project


def forward_flops(model: dict, batch: int, height: int, width: int) -> float:
    """Operations of one forward: every linear layer, every layer's
    attention, and the head's FC."""
    return (sum(g.ops for g in gemms(model, batch, height, width))
            + int(model["depth"]) * attention_ops(model, batch, height, width)
            + 2.0 * batch * int(model["fc_in"]) * int(model["out_dim"]))
