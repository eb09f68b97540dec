"""The ViT's linear layers (qkv, proj, fc1, fc2 and the patch embedding's
GEMM, on cuBLAS) against their roofline: each launch's operations and bf16
bytes from the configuration's widths, over their device time (%)."""

from harness.vit_readings import linear_roofline as read  # noqa: F401
