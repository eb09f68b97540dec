"""The ViT's memory-bound passes (LayerNorm, GELU, the LayerScale residual
updates) against their bytes at 3.35 TB/s, over their device time (%)."""

from harness.vit_readings import pointwise_roofline as read  # noqa: F401
