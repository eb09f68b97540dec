"""The backbone convolution (ops/conv.py -> csrc/conv.cu) against its roofline:
each launch's bound from the configuration's shapes over the device time of
every fused-conv launch, stem included (%)."""

from harness.readings import conv_roofline as read  # noqa: F401
