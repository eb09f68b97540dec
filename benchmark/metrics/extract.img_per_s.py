"""Images whose descriptors came back over the whole window, over its
length on the host's clock (img/s): the rate, where the cell's end-to-end
metric is the device's time an image."""

from harness.readings import extract_img_per_s as read  # noqa: F401
