"""Device idle share of the traced slice in the server's process: its wall time
minus the busy union, over its wall time (%)."""

from harness.readings import idle_share as read  # noqa: F401
