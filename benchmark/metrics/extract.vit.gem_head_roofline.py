"""K1, the GeM -> FC -> L2 head (ops/gem_head.py -> csrc/gem_head.cu), on the
ViT's fp32 (8, 55, 73, 1024) patch map: its two launches against their
bounds (%)."""

from harness.vit_readings import gem_head_roofline as read  # noqa: F401
