"""K3 (dirjax_finemax, csrc/topk.cu) against its roofline: its launches' bounds
(the rows read once, or 2 nq N D operations at the bf16 peak) over their
device time (%)."""

from harness.readings import finemax_roofline as read  # noqa: F401
