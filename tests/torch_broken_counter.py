"""Deliberately BROKEN counter join — the port's crdtlint self-test
fixture.

The torch counterpart of ``tests/fixtures/broken_counter.py`` (which
imports jax): the counter "join" below applies the remote value as an
INCREMENT (``2*local + remote``) instead of the per-lane max of the
gcounter join in `semantics.kernels`. Increment application is not a
semilattice join — re-delivering the same delta changes the value again
and the two merge orders disagree — so the seeded law search must find
a counterexample:

    python -m crdt_tpu_torch.analysis --device cpu \\
        --law-fixture tests/torch_broken_counter.py

The clock lanes are kept CORRECT on purpose (strict (lt, node) lex,
winner adoption): the breakage is confined to the value lattice.
"""

import torch

from crdt_tpu_torch.analysis.lattice_laws import make_wire_join_target
from crdt_tpu_torch.ops.dense import _NEG, DenseStore


def skewed_counter_join_step(store: DenseStore, lt, node, val, tomb,
                             valid, stamp_lt, local_node):
    """Counter wire join with the max→increment bug planted."""
    lt = torch.where(valid, lt, _NEG)
    node = node.to(torch.int32)
    val = val.to(torch.int64)
    remote_newer = ((lt > store.lt) |
                    ((lt == store.lt) & (node > store.node)))
    take = valid & (~store.occupied | remote_newer)
    both = valid & store.occupied
    # BUG: increment application instead of a per-lane max join —
    # 2*local + remote is neither commutative nor idempotent.
    joined = torch.where(both, 2 * store.val + val,
                         torch.where(take, val, store.val))
    win = take | (valid & (joined != store.val))
    new_store = DenseStore(
        lt=torch.where(take, lt, store.lt),
        node=torch.where(take, node, store.node),
        val=joined,
        mod_lt=store.mod_lt.masked_fill(win, stamp_lt),
        mod_node=store.mod_node.masked_fill(win, local_node),
        occupied=store.occupied | valid,
        tomb=torch.where(take, tomb, store.tomb),
    )
    return new_store, win


def LAW_TARGETS(device="cpu"):
    return [make_wire_join_target(skewed_counter_join_step,
                                  "broken-counter-join",
                                  notes="max→increment planted bug",
                                  device=device)]
