"""Mean host ms of a RetrievalIndex.search dispatch's results pull in the
traced slice (program span ``index.pull``: the wait for the device, then
the copy)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "index.pull")
