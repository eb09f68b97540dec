"""Mean host ms of FeatureExtractor's upload a batch in the traced slice
(program span ``extract.upload``: the pageable copy, the mask, the
normalize and permute launches)."""

from harness.program_spans import mean_ms


def read(reading):
    return mean_ms(reading, "extract.upload")
