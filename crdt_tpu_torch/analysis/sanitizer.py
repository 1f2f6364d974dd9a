"""Opt-in runtime lattice sanitizer (``CRDT_TPU_SANITIZE=1``).

Port of ``crdt_tpu/analysis/sanitizer.py``. The static auditors check
properties of the JOINS; the sanitizer checks the deployed
COMPOSITION: after every merge the store must dominate the merged
payload in the (logical_time, node) lattice order — stored >= remote
for every record the merge saw. That is the post-state every correct
join leaves regardless of who won (local winners already dominated;
adopted remotes dominate by construction), so it holds across devices,
windows and overflow masking — and a merge that drops, reorders, or
double-applies records breaks it.

Each dense check runs as torch ops on the store's device over lanes the
merge already holds there; only the verdict and the first bad slot
come to the host (one small copy per check, one more on a failure).
The mode stays opt-in (the variable is read LIVE, so a test can flip it
per case). Messages are the JAX package's, character for character.

Scope notes:

- The DenseCrdt PIPELINED path is exempt by contract: it keeps
  everything on device with no host syncs per merge, which is the
  point of the window — a host-side verdict there would serialize it.
  Sanitize soaks run unpipelined.
- ``mod_lt`` / ``mod_node`` lanes are NOT checked: stamping is
  order-dependent bookkeeping by design (see analysis.lattice_laws).
"""

from __future__ import annotations

import os
from typing import Dict

_ENV = "CRDT_TPU_SANITIZE"


class LatticeViolation(AssertionError):
    """A merge left the store NOT dominating its input — the lattice
    join invariant is broken (lost update, reordered winner, or
    double-apply)."""


def enabled() -> bool:
    """Read ``CRDT_TPU_SANITIZE`` live — per-test toggling works
    without reimporting anything."""
    return os.environ.get(_ENV, "") not in ("", "0")


def check_scalar_join(crdt, remote_records: Dict) -> None:
    """Post-``Crdt.merge`` invariant: every remote record is dominated
    by what the store now holds for its key, and by the canonical
    clock."""
    canonical = crdt.canonical_time
    for key, remote in remote_records.items():
        stored = crdt.get_record(key)
        if stored is None:
            raise LatticeViolation(
                f"sanitizer: merge saw key {key!r} but the store "
                f"holds no record for it afterwards")
        if stored.hlc < remote.hlc:
            raise LatticeViolation(
                f"sanitizer: store does not dominate merged input at "
                f"key {key!r}: stored hlc {stored.hlc} < remote hlc "
                f"{remote.hlc}")
        if canonical < remote.hlc:
            raise LatticeViolation(
                f"sanitizer: canonical clock {canonical} was not "
                f"absorbed past remote hlc {remote.hlc} at key "
                f"{key!r}")


def _on(x, device, dtype):
    """``x`` (a tensor, numpy array or sequence) on ``device`` as
    ``dtype``."""
    import numpy as np
    import torch
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _first_bad(bad):
    """``None`` when no entry of the flat bool tensor ``bad`` is set,
    else the index of the first one — one host copy either way."""
    import torch
    if not bad.numel():
        return None
    hit, i = torch.stack([bad.any().long(),
                          torch.argmax(bad.to(torch.uint8)).long()]
                         ).tolist()
    return i if hit else None


def check_dense_sparse_join(store, slots, lt, node, valid=None) -> None:
    """Post-merge invariant for a payload-order sparse delta against a
    DenseStore: stored (lt, node) at each valid slot is lex >= the
    delta's. Duplicate slots must already be collapsed (the same
    contract the merge itself requires)."""
    import torch
    dev = store.lt.device
    at = _on(slots, dev, torch.int64)
    s_lt, s_node = store.lt[at], store.node[at]
    r_lt = _on(lt, dev, torch.int64)
    r_node = _on(node, dev, torch.int32)
    dominated = (s_lt > r_lt) | ((s_lt == r_lt) & (s_node >= r_node))
    if valid is not None:
        dominated = dominated | ~_on(valid, dev, torch.bool)
    i = _first_bad(~dominated)
    if i is not None:
        slot, a, b, c, d = torch.stack(
            [at[i], s_lt[i], s_node[i].long(), r_lt[i],
             r_node[i].long()]).tolist()
        raise LatticeViolation(
            f"sanitizer: store does not dominate merged delta at slot "
            f"{slot}: stored (lt={a}, node={b}) < remote (lt={c}, "
            f"node={d})")


def check_dense_no_resurrection(store, purged_slots, floor_lt) -> None:
    """Post-merge invariant after an epoch GC pass: no purged slot may
    re-occupy with a record stamped AT OR BELOW the purge floor — that
    would be a resurrection of purged state (a replayed pre-purge delta
    got past the merge fence). Re-occupation above the floor is a
    legitimate fresh write and passes. Armed by `DenseCrdt.gc_purge`
    under ``CRDT_TPU_SANITIZE=1``; retired on `compact` (the remap
    invalidates the recorded slot indices)."""
    import torch
    dev = store.lt.device
    purged = _on(purged_slots, dev, torch.int64).reshape(-1)
    if not purged.numel():
        return
    occ = store.occupied[purged]
    lt = store.lt[purged]
    i = _first_bad(occ & (lt <= int(floor_lt)))
    if i is not None:
        slot, at_lt = torch.stack([purged[i], lt[i]]).tolist()
        raise LatticeViolation(
            f"sanitizer: purged slot {slot} re-occupied "
            f"at or below the GC floor (lt={at_lt} <= floor "
            f"{int(floor_lt)}) — a pre-purge delta resurrected "
            f"purged state past the merge fence")


def check_dense_join(store, cs) -> None:
    """Post-merge invariant for a wide [R, N] DenseChangeset (any
    object with ``lt``, ``node`` and ``valid`` lanes, rows of N slots
    in any leading shape): per slot, the store dominates the lex max
    over the valid replica rows."""
    import torch
    dev = store.lt.device
    n = store.lt.shape[0]
    lt = _on(cs.lt, dev, torch.int64).reshape(-1, n)
    node = _on(cs.node, dev, torch.int32).reshape(-1, n)
    valid = _on(cs.valid, dev, torch.bool).reshape(-1, n)
    neg = torch.tensor(-(2 ** 62), dtype=torch.int64, device=dev)
    m_lt = torch.where(valid, lt, neg)
    # lex max over rows: max lt, then max node among rows at that lt
    best_lt = m_lt.amax(dim=0)
    at_best = valid & (m_lt == best_lt)
    low = torch.tensor(torch.iinfo(torch.int32).min, dtype=torch.int32,
                       device=dev)
    best_node = torch.where(at_best, node, low).amax(dim=0)
    any_valid = valid.any(dim=0)
    s_lt, s_node = store.lt, store.node
    dominated = (~any_valid | (s_lt > best_lt)
                 | ((s_lt == best_lt) & (s_node >= best_node)))
    i = _first_bad(~dominated)
    if i is not None:
        a, b, c, d = torch.stack(
            [s_lt[i], s_node[i].long(), best_lt[i],
             best_node[i].long()]).tolist()
        raise LatticeViolation(
            f"sanitizer: store does not dominate merged changeset at "
            f"slot {i}: stored (lt={a}, "
            f"node={b}) < changeset best "
            f"(lt={c}, node={d})")
