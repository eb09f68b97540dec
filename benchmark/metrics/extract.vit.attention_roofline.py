"""The ViT's attention (torch's scaled-dot-product attention pinned to
cuDNN's fused backend) against its roofline: 4 N^2 D operations a layer an
image at the bf16 peak, over the device time of its launches (%)."""

from harness.vit_readings import attention_roofline as read  # noqa: F401
