"""Host-side helpers of the port: merge observability (the stats
counters and the profiler span), the default device, the host recv
fold and the lock helpers."""

from .stats import MergeStats, merge_annotation

__all__ = ["MergeStats", "merge_annotation"]
