"""Mean host ms of one image's decode and transform on a loader thread in the
traced slice (program span ``loader.decode``)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "loader.decode")
