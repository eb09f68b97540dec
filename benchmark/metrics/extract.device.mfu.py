"""The whole forward's share of the bf16 peak over the device's busy time:
the configuration's forward operations for every image extracted in the
traced slice, over the slice's busy union (%)."""

from harness.readings import extract_device_mfu as read  # noqa: F401
