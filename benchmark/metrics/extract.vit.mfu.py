"""The ViT forward's share of the bf16 peak over the device's busy time: 4.022
TFLOP an image at 1022 x 770, for every image extracted in the traced
slice, over the slice's busy union (%)."""

from harness.vit_readings import device_mfu as read  # noqa: F401
