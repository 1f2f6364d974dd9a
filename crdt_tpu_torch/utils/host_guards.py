"""Vectorized host-side ``Hlc.recv`` fold over a payload column.

A copy of ``crdt_tpu/utils/host_guards.py``. The reference's merge runs
``Hlc.recv`` per record in payload visit order (crdt.dart:82,
hlc.dart:80-97); its fast path shields records the running canonical
clock already dominates (hlc.dart:85). On columns that collapses to:
running = exclusive cummax of the packed logical times (seeded with the
canonical), a record is "slow" iff it exceeds the running clock, and
only slow records face the duplicate-node / drift guards. The columnar
merges of `DenseCrdt` (`merge_packed`, `merge_json`, `merge_records`)
fold here before their join.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..hlc import MAX_DRIFT, SHIFT

_NEG = -(2 ** 62)


class RecvFold(NamedTuple):
    """Result of the vectorized recv fold over a payload column."""
    new_canonical: int            # max(canonical, lt.max())
    bad_index: Optional[int]      # first offender, or None
    bad_is_dup: bool              # duplicate-node (vs drift) there
    canonical_at_fail: int        # running clock just BEFORE the offender


def recv_fold_columns(lt: np.ndarray, local_mask: np.ndarray,
                      canonical_lt: int, wall: int) -> RecvFold:
    """Fold ``Hlc.recv`` over packed logical times in visit order.

    ``local_mask`` marks records bearing THIS replica's node id (the
    duplicate-node candidates). Returns the post-absorption canonical
    and, if a guard trips, the first offender's index plus the
    partially-advanced canonical the sequential path would leave
    behind (crdt.dart:77-94 throw path). Raising is the caller's job."""
    running = np.maximum(canonical_lt, np.concatenate(
        ([_NEG], np.maximum.accumulate(lt)[:-1])))
    slow = lt > running
    if slow.any():
        dup = slow & local_mask
        drift = slow & ~dup & ((lt >> SHIFT) - wall > MAX_DRIFT)
        bad = dup | drift
        if bad.any():
            i = int(np.argmax(bad))
            return RecvFold(new_canonical=0, bad_index=i,
                            bad_is_dup=bool(dup[i]),
                            canonical_at_fail=int(running[i]))
    return RecvFold(new_canonical=max(canonical_lt, int(lt.max())),
                    bad_index=None, bad_is_dup=False, canonical_at_fail=0)
