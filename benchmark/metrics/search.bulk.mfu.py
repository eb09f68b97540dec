"""The whole search step's share of the bf16 peak: 2 x query rows answered in
the traced slice x N x D operations, over its seconds (%)."""

from harness.readings import search_mfu as read  # noqa: F401
