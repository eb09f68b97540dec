"""The backbone convolution (ops/conv.py -> csrc/conv.cu) against its roofline:
each launch's bound from the configuration's shapes over the device time of
every fused-conv launch, stem included (%).
The same reading, in a cell whose end-to-end metric is the device's ms an
image."""

from harness.readings import conv_roofline as read  # noqa: F401
