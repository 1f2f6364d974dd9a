"""Percentiles and the bytes arithmetic the readers share."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-quantile (``0 < q <= 1``): the smallest
    value with at least ``q`` of the samples at or below it; None for no
    samples."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
