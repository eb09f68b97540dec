"""Device idle share of the traced extraction slice: its wall time minus the
busy union of kernels, copies and memsets, over its wall time (%)."""

from harness.readings import idle_share as read  # noqa: F401
