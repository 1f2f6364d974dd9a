"""A merge's ``records_seen`` at the model level, on the CPU: the valid
peer records left after the ``value_width=32`` masking and the GC
fence, for every path a `DenseCrdt` merge takes — the fan-in join's own
count (K1's plain version here, the kernel on the card) in and out of
`pipelined()` windows, and the whole changeset's count on the typed
fold and on `ShardedDenseCrdt`.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_seen.py
"""

import contextlib

import numpy as np
import pytest
import torch

import crdt_tpu_torch as port
from crdt_tpu_torch import parallel
from crdt_tpu_torch.hlc import SHIFT
from crdt_tpu_torch.models.dense_crdt import PipelinedGuardError
from crdt_tpu_torch.ops.dense import DenseChangeset
from crdt_tpu_torch.testing import FakeClock

from torch_threads import cap_torch_threads

cap_torch_threads()

N = 64
ROWS = 5
MILLIS = 1_700_000_000_000
PEERS = ["p0", "p1", "p2"]
PURGED = list(range(8))      # the slots the GC case tombstones and purges


def changeset(seed, floor_ms):
    """Peer rows stamped either side of ``floor_ms`` (ties on purpose),
    a third invalid, a quarter of the values past int32."""
    rng = np.random.default_rng(seed)
    ms = floor_ms + rng.integers(-3, 4, (ROWS, N))
    vals = rng.integers(-2 ** 31, 2 ** 31, (ROWS, N))
    wide = rng.random((ROWS, N)) < 0.25
    vals[wide] = rng.integers(2 ** 31, 2 ** 40, int(wide.sum()))
    return DenseChangeset(
        lt=torch.tensor((ms << SHIFT) + rng.integers(0, 3, (ROWS, N))),
        node=torch.tensor(rng.integers(0, len(PEERS), (ROWS, N)),
                          dtype=torch.int32),
        val=torch.tensor(vals),
        tomb=torch.tensor(rng.random((ROWS, N)) < 0.2),
        valid=torch.tensor(rng.random((ROWS, N)) < 0.67))


def expected_seen(cs, value_width, floor_lt):
    """The valid records after the masking and the fence, from the
    inputs alone."""
    valid = cs.valid.numpy().copy()
    if value_width == 32:
        val = cs.val.numpy()
        valid &= (val >= -2 ** 31) & (val < 2 ** 31)
    if floor_lt:
        fenced = np.zeros(N, bool)
        fenced[PURGED] = True
        valid &= ~((cs.lt.numpy() <= floor_lt) & fenced[None, :])
    return int(valid.sum())


# case: (replica kind, value_width, merges as tuples of changeset seeds,
# window, GC floor first). The value_width=32 window reports the masked
# records at its fence; they are counted all the same.
CASES = {
    "merge": ("dense", 64, [(1,)], None, False),
    "merge_many-3": ("dense", 64, [(2, 3, 4)], None, False),
    "coarse-window": ("dense", 64, [(5,), (6, 7), (8,)], "coarse", False),
    "exact-window": ("dense", 64, [(9,), (10, 11)], "exact", False),
    "value_width-32": ("dense", 32, [(12,), (13, 14)], "coarse", False),
    "gc-floor": ("dense", 64, [(15,), (16, 17)], None, True),
    "typed": ("typed", 64, [(18,), (19, 20)], None, False),
    "sharded": ("sharded", 64, [(21,), (22, 23)], None, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_records_seen_counts_masked_fenced_valid_records(case):
    kind, value_width, merges, window, gc = CASES[case]
    clock = FakeClock(start=MILLIS)
    if kind == "sharded":
        mesh = parallel.make_fanin_mesh(2, 2, devices=["cpu"] * 4)
        crdt = port.ShardedDenseCrdt("h", N, mesh, wall_clock=clock,
                                     value_width=value_width)
    else:
        crdt = port.DenseCrdt("h", N, device="cpu", wall_clock=clock,
                              value_width=value_width)
    if kind == "typed":
        crdt.set_semantics(range(8, 16), "gcounter")
    floor_lt = 0
    if gc:
        crdt.put_batch(PURGED, [1] * len(PURGED))
        crdt.delete_batch(PURGED)
        floor_lt = crdt.canonical_time.logical_time
        assert crdt.gc_purge(crdt.canonical_time, drift_slack_ms=0) == \
            len(PURGED)
    floor_ms = (floor_lt >> SHIFT) or clock.millis
    batches = [[changeset(seed, floor_ms) for seed in seeds]
               for seeds in merges]
    want = sum(expected_seen(cs, value_width, floor_lt)
               for batch in batches for cs in batch)
    assert want > 0
    seen0 = crdt.stats.records_seen

    def run():
        for batch in batches:
            if len(batch) == 1:
                crdt.merge(batch[0], PEERS)
            else:
                crdt.merge_many([(cs, PEERS) for cs in batch])

    overflow = (pytest.raises(PipelinedGuardError,
                              match="value-ref overflow")
                if value_width == 32 else contextlib.nullcontext())
    with overflow:
        if window is None:
            run()
        else:
            with crdt.pipelined(exact_guards=window == "exact"):
                run()
    assert crdt.stats.records_seen - seen0 == want
