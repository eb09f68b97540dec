"""Mean host ms of a RetrievalIndex.search dispatch, its results on the host,
in the traced slice (the benchmark's proxy around the index)."""

from harness.readings import index_ms as read  # noqa: F401
