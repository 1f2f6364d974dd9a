"""Deliberately BROKEN merge join — the port's crdtlint self-test fixture.

The torch counterpart of ``tests/fixtures/broken_merge.py`` (which
imports jax): a max→mean corruption of `ops.dense.wire_join_step`.
Where the real join ADOPTS the winning remote logical time, this one
stores the AVERAGE of local and remote lt on a win. Averaging is not a
lattice join, so the law search must find a counterexample and print
the violating input:

    python -m crdt_tpu_torch.analysis --device cpu \\
        --law-fixture tests/torch_broken_merge.py

``LAW_TARGETS`` is a function of the device, so the same fixture runs
on the card (``--device cuda``).
"""

import torch

from crdt_tpu_torch.analysis.lattice_laws import make_wire_join_target
from crdt_tpu_torch.ops.dense import _NEG, DenseStore


def mean_join_step(store: DenseStore, lt, node, val, tomb, valid,
                   stamp_lt, local_node):
    """wire_join_step with the max→mean bug planted."""
    lt = torch.where(valid, lt, _NEG)
    node = node.to(torch.int32)
    val = val.to(torch.int64)
    remote_newer = ((lt > store.lt) |
                    ((lt == store.lt) & (node > store.node)))
    win = valid & (~store.occupied | remote_newer)
    # BUG: mean instead of max — not a semilattice join.
    mean_lt = torch.div(store.lt + lt, 2, rounding_mode="floor")
    new_store = DenseStore(
        lt=torch.where(win, mean_lt, store.lt),
        node=torch.where(win, node, store.node),
        val=torch.where(win, val, store.val),
        mod_lt=store.mod_lt.masked_fill(win, stamp_lt),
        mod_node=store.mod_node.masked_fill(win, local_node),
        occupied=store.occupied | win,
        tomb=torch.where(win, tomb, store.tomb),
    )
    return new_store, win


def LAW_TARGETS(device="cpu"):
    return [make_wire_join_target(mean_join_step, "broken-mean-join",
                                  notes="max→mean planted bug",
                                  device=device)]
