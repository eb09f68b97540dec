"""The chip's published peaks and the roofline arithmetic.

NVIDIA H100 SXM (data sheet, dense rates, 700 W): 3.35 TB/s of HBM3, 989
TFLOP/s in bf16 on the tensor cores, 1,979 TOP/s in int8, 67 TFLOP/s in
fp32 outside them. The bound of a piece of work is the larger of its bytes
over the memory rate and its operations over the peak of their type, where
each input byte is read once and each output byte written once.
"""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound_s(nbytes: float, ops: float, kind: str = "bf16") -> float:
    """The least seconds the chip could take: bytes at the memory rate or
    operations at the peak of ``kind``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def roofline_pct(bound_total_s: float, device_s: float) -> Optional[float]:
    """The share of its roofline a kernel reached: its bounds summed over the
    device time it took, in %; None where it did not run."""
    if device_s <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / device_s


def mfu_pct(flops: float, seconds: float, kind: str = "bf16") -> Optional[float]:
    """Operations done over ``seconds`` as a share of the chip's peak, in %."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_OPS_PER_S[kind]
