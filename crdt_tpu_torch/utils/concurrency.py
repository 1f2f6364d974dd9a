"""The lock-creation seam of the port's host runtime.

Every lock of the wire, gossip, watch and observability layers is made
here under its contract name and rank (``"ClassName.attr"``, its place
in the declared global order: larger is acquired later, nearer the
leaves), the same names and ranks as the JAX package's. With
``CRDT_TPU_SANITIZE`` set when the lock is made, it is an
`analysis.concurrency.OrderedLock` that counts and traces every
acquisition against that order; otherwise a plain ``threading.Lock`` /
``RLock``: no per-acquisition cost and the semantics of the standard
library.
"""

from __future__ import annotations

from ..analysis.concurrency import make_lock

__all__ = ["make_lock"]
