"""Mean host ms of the forward's launch path a batch in the traced slice
(program span ``extract.forward``, not synchronised)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "extract.forward")
