"""Mean host ms extract_image_features waits for the loader's next batch in
the traced slice (program span ``extract.wait``: the decodes not yet done,
then the batching)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "extract.wait")
