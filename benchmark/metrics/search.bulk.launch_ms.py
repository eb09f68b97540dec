"""Mean host ms of a RetrievalIndex.search dispatch up to its results' pull in
the traced slice (program span ``index.launch``: the queries to the device,
K3, the selection, K4)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "index.launch")
