"""K1, the GeM -> FC -> L2 head (ops/gem_head.py -> csrc/gem_head.cu), its two
launches against their bounds (%)."""

from harness.readings import gem_head_roofline as read  # noqa: F401
