"""Device ms of host-to-device copies in the traced slice, over the images
handed to the extractor in it (the FeatureExtractor upload)."""

from harness.readings import h2d_ms_per_img as read  # noqa: F401
