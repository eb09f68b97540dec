"""The whole forward's share of the bf16 peak: the configuration's forward
operations for every image extracted in the traced slice, over its seconds
(%)."""

from harness.readings import extract_mfu as read  # noqa: F401
