"""Mean ms a request waits in the DynamicBatcher, from its submit to the start
of its dispatch, in the traced slice (program span ``batcher.wait``)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "batcher.wait")
