"""Mean query rows a DynamicBatcher dispatch hands to RetrievalIndex.search in
the traced slice (the benchmark's proxy around the index)."""

from harness.readings import rows_per_batch as read  # noqa: F401
