"""Operations and bytes of the program's work, from a configuration's shapes.

Nothing here reads the program: each count follows from the widths in the
configuration file and the sizes the traffic gives (a batch's image size, a
search's query rows). Each input byte is read once and each output byte
written once (``peaks.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from . import peaks

BF16, FP32 = 2, 4


@dataclass(frozen=True)
class Conv:
    """One convolution launch of a forward, with its fused epilogue."""

    batch: int
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    groups: int
    h: int                      # input height
    w: int                      # input width
    x_bytes: int                # bytes per input element
    out_bytes: int              # bytes per output element
    residual_bytes: int = 0     # bytes of the residual read (0: none)

    @property
    def ho(self) -> int:
        return (self.h + 2 * self.pad - self.k) // self.stride + 1

    @property
    def wo(self) -> int:
        return (self.w + 2 * self.pad - self.k) // self.stride + 1

    @property
    def ops(self) -> float:
        return 2.0 * self.batch * self.ho * self.wo * self.cout * self.k * self.k * (
            self.cin // self.groups)

    @property
    def nbytes(self) -> float:
        return (self.batch * self.h * self.w * self.cin * self.x_bytes
                + self.cout * self.k * self.k * (self.cin // self.groups) * BF16
                + 2 * FP32 * self.cout                       # BN scale and shift
                + self.batch * self.ho * self.wo * self.cout * self.out_bytes
                + self.residual_bytes)

    @property
    def bound_s(self) -> float:
        return peaks.bound_s(self.nbytes, self.ops, "bf16")


def backbone_convs(model: dict, batch: int, height: int, width: int) -> List[Conv]:
    """The convolutions of one bf16 inference forward of a ResNet / ResNeXt
    with bottleneck blocks, in launch order: the stem (reading the fp32
    normalized input), then each block's 1x1, 3x3 (grouped in ResNeXt), its
    downsample (fp32 output) where it has one, and the 1x1 with the residual."""
    if model["block"] != "bottleneck":
        raise ValueError("only bottleneck backbones are counted")
    stem = model["stem_channels"]
    convs = [Conv(batch, 3, stem, 7, 2, 3, 1, height, width, FP32, BF16)]
    h, w = convs[0].ho, convs[0].wo
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1       # max pool 3x3, stride 2
    cin = stem
    for s, (planes, blocks) in enumerate(zip(model["stage_planes"], model["layers"])):
        mid = int(planes * model["base_width"] / 64.0) * model["groups"]
        cout = planes * model["expansion"]
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            c1 = Conv(batch, cin, mid, 1, 1, 0, 1, h, w, BF16, BF16)
            c2 = Conv(batch, mid, mid, 3, stride, 1, model["groups"], h, w, BF16, BF16)
            ho, wo = c2.ho, c2.wo
            convs += [c1, c2]
            if stride != 1 or cin != cout:
                convs.append(Conv(batch, cin, cout, 1, stride, 0, 1, h, w, BF16, FP32))
                residual = batch * ho * wo * cout * FP32
            else:
                residual = batch * h * w * cin * BF16
            convs.append(Conv(batch, mid, cout, 1, 1, 0, 1, ho, wo, BF16, BF16, residual))
            cin, h, w = cout, ho, wo
    return convs


def feature_map(model: dict, height: int, width: int):
    """(h, w) of the last stage's map for an input of height x width."""
    c = backbone_convs(model, 1, height, width)[-1]
    return c.ho, c.wo


def gem_head_launches(model: dict, batch: int, height: int, width: int):
    """Bounds, in seconds, of the head's two launches (K1): the GeM pool
    (the bf16 map read, fp32 pooled features written) and the projection
    with the L2 (pooled features, fp32 FC weight and bias read, descriptors
    written; 2 B C D fp32 operations)."""
    h, w = feature_map(model, height, width)
    c, d = model["fc_in"], model["out_dim"]
    pool = peaks.bound_s(batch * h * w * c * BF16 + batch * c * FP32, 0.0)
    project = peaks.bound_s(batch * c * FP32 + c * d * FP32 + d * FP32 + batch * d * FP32,
                            2.0 * batch * c * d, "fp32")
    return pool, project


def forward_flops(model: dict, batch: int, height: int, width: int) -> float:
    """Operations of one forward: every convolution and the FC."""
    convs = backbone_convs(model, batch, height, width)
    return sum(c.ops for c in convs) + 2.0 * batch * model["fc_in"] * model["out_dim"]


def finemax_bound_s(rows: int, dim: int, nq: int, row_bytes: int = BF16) -> float:
    """K3 over ``rows`` x ``dim`` rows for ``nq`` queries: the rows and the
    queries read once, or 2 nq rows dim operations at the bf16 peak."""
    return peaks.bound_s(rows * dim * row_bytes + nq * dim * BF16,
                         2.0 * nq * rows * dim, "bf16")


def search_flops(rows: int, dim: int, nq: int) -> float:
    """Operations of an exact search of ``nq`` queries: their dot products
    with every row."""
    return 2.0 * nq * rows * dim
