"""Mean host ms of the ViT's 24 blocks' launches a batch in the traced slice
(program span ``vit.blocks``, not synchronised)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "vit.blocks")
