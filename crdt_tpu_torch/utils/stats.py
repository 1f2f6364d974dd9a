"""Merge observability: per-backend counters and a named profiler span.

`MergeStats` counts merges and record flow on a backend;
`merge_annotation` wraps the device launch in a
``torch.profiler.record_function`` span so kernel time shows up named
in ``torch.profiler`` traces. Port of ``crdt_tpu/utils/stats.py``
without the process-wide metrics registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class MergeStats:
    """Counters for one CRDT backend instance.

    ``records_seen``/``records_adopted`` may be fed unfetched device
    scalars via the ``add_*_lazy`` methods so the merge hot path never
    blocks on a device→host copy; reading the property drains them.
    """
    merges: int = 0            # merge() calls
    puts: int = 0              # local write batches (put/put_all)
    records_put: int = 0       # local records written
    _seen: int = 0
    _seen_pending: Any = None  # lazy running sum (device scalar)
    _adopted: int = 0
    _adopted_pending: Any = None

    @property
    def records_seen(self) -> int:
        """Remote records examined, winners+losers (crdt.dart:80-85)."""
        if self._seen_pending is not None:
            self._seen += int(self._seen_pending)
            self._seen_pending = None
        return self._seen

    @records_seen.setter
    def records_seen(self, value: int) -> None:
        self._seen_pending = None
        self._seen = value

    def add_seen_lazy(self, count: Any) -> None:
        """Accumulate a host int or an unfetched device scalar without
        forcing a sync; kept as one running device sum (O(1) memory)."""
        self._seen_pending = (count if self._seen_pending is None
                              else self._seen_pending + count)

    @property
    def records_adopted(self) -> int:
        """LWW winners written; may drain a lazy device sum."""
        if self._adopted_pending is not None:
            self._adopted += int(self._adopted_pending)
            self._adopted_pending = None
        return self._adopted

    @records_adopted.setter
    def records_adopted(self, value: int) -> None:
        self._adopted_pending = None
        self._adopted = value

    def add_adopted_lazy(self, count: Any) -> None:
        self._adopted_pending = (
            count if self._adopted_pending is None
            else self._adopted_pending + count)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("merges", "records_seen", "records_adopted", "puts",
                 "records_put")}

    def reset(self) -> None:
        for k in self.as_dict():
            setattr(self, k, 0)


def merge_annotation(name: str = "crdt_tpu_torch.merge"):
    """Named profiler span around a merge launch."""
    return torch.profiler.record_function(name)
