"""Mean host us of one call of the backbone's fused-conv wrapper in the traced
slice (program span ``conv.call``: the operand cache key, the input
packing, the launch)."""

from harness.program_spans import mean_us


def read(reading):
    return mean_us(reading, "conv.call")
