"""The lock-creation seam of the port's host runtime.

Port of ``make_lock`` from ``crdt_tpu/analysis/concurrency.py``. Every
lock of the wire, gossip and observability layers is made here under
its contract name and rank (``"ClassName.attr"``, its place in the
declared global order: larger is acquired later, nearer the leaves),
the same names and ranks as the JAX package's, so that a lock-order
sanitizer can plug in at this one seam later (ROADMAP A11). Until then
it returns a plain ``threading.Lock`` / ``RLock``: no per-acquisition
cost and the semantics of the standard library.
"""

from __future__ import annotations

import threading


def make_lock(name: str, rank: int, rlock: bool = False):
    """A lock for contract key ``name`` at order ``rank``: a plain
    ``threading.RLock`` when ``rlock`` is set, else a
    ``threading.Lock``."""
    del name, rank   # read by the sanitizer, which is not ported yet
    return threading.RLock() if rlock else threading.Lock()
