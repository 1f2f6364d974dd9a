"""Clock absorption on device: the recv guards and the send bump.

Port of the two functions of ``crdt_tpu/ops/merge.py`` that the dense
replication loop runs:

- `recv_guards` — the vectorized ``Hlc.recv`` guard masks over a record
  batch (hlc.dart:80-97). A record reaches recv's slow path iff its lt
  exceeds the *running* canonical clock, the exclusive cumulative max
  over earlier records (``torch.cummax``), because the fast path skips
  every check whenever the canonical clock is already ahead
  (hlc.dart:85).
- `send_step` — ``Hlc.send`` on a packed logicalTime, returning guard
  flags instead of raising, so a pipelined window keeps the clock on
  the device.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT

_NEG = -(2 ** 62)

Scalar = Union[int, torch.Tensor]


def recv_guards(lt: torch.Tensor, node: torch.Tensor, valid: torch.Tensor,
                canonical_lt: Scalar, local_node: int, wall_millis: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Guard masks over a record batch (any shape; visited flattened in
    row-major order). It trips duplicate-node if a slow-path record
    carries the local ordinal (hlc.dart:88-90), else drift if it is
    more than 60 s ahead of the wall (hlc.dart:92-94). Returns
    ``(any_bad, first_bad, first_is_dup, canonical_at_fail)`` with a
    flat row-major ``first_bad`` index."""
    flat_lt = torch.where(valid, lt, _NEG).reshape(-1)
    incl = torch.cummax(flat_lt, 0).values
    excl = torch.cat([incl.new_full((1,), _NEG), incl[:-1]])
    running = torch.maximum(excl, torch.as_tensor(
        canonical_lt, dtype=torch.int64, device=lt.device))

    slow = valid.reshape(-1) & (flat_lt > running)
    dup = slow & (node.reshape(-1) == local_node)
    drift = slow & ~dup & ((flat_lt >> SHIFT) - wall_millis > MAX_DRIFT)
    bad = dup | drift
    # argmax returns the FIRST maximal index: the first offender.
    first_bad = torch.argmax(bad.to(torch.uint8))
    return bad.any(), first_bad, dup[first_bad], running[first_bad]


def send_step(lt: torch.Tensor, wall_millis: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``Hlc.send`` on a packed int64 logicalTime, on device
    (hlc.dart:51-74 on the lane encoding): millis = max(stored, wall),
    the counter increments iff millis is unchanged, else resets — on
    the packed form ``lt + 1`` vs ``wall << 16``. Returns ``(new_lt,
    overflow, drift)`` guard FLAGS instead of raising; on overflow the
    clock stays put, as the host path leaves it when it raises."""
    ms = lt >> SHIFT
    stay = ms >= wall_millis
    overflow = stay & ((lt & MAX_COUNTER) == MAX_COUNTER)
    new_lt = torch.where(overflow, lt,
                         torch.where(stay, lt + 1,
                                     torch.full_like(lt,
                                                     wall_millis << SHIFT)))
    drift = ms - wall_millis > MAX_DRIFT
    return new_lt, overflow, drift
