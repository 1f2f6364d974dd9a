"""The port's `DenseCrdt` against the JAX package's on one op script.

The same calls go to ``crdt_tpu.DenseCrdt(executor="pallas-interpret")``
(the Pallas kernels in interpret mode) and to
``crdt_tpu_torch.DenseCrdt(device="cpu")`` (the plain versions of the
port's kernels), each with its own `FakeClock`. After every phase the
two must agree exactly: lanes on occupied slots, the canonical clock,
the node table; and the outputs: `to_json` strings, `PackedDelta`
bytes, exported changesets, records, exception classes and messages,
watch events, npz snapshots loaded across packages both ways.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDenseCrdt
from crdt_tpu.ops.dense import DenseChangeset as JaxChangeset
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch.ops.dense import DenseChangeset as PortChangeset
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 2 * 4096
START = 1_700_000_000_000


def peer_changeset(seed, rows, n_ids, lo_ms, hi_ms, fill=0.3):
    """Numpy lanes of a peer changeset whose records sit in
    ``[START + lo_ms, START + hi_ms)``."""
    rng = np.random.default_rng(seed)
    return dict(
        lt=((START + rng.integers(lo_ms, hi_ms, (rows, N))) << 16)
        + rng.integers(0, 3, (rows, N)),
        node=rng.integers(0, n_ids, (rows, N)).astype(np.int32),
        val=rng.integers(-2 ** 40, 2 ** 40, (rows, N)),
        tomb=rng.random((rows, N)) < 0.3,
        valid=rng.random((rows, N)) < fill)


class Pair:
    """One replica in each package, driven in lockstep."""

    def __init__(self, node_id="n1", **kw):
        self.jax = JaxDenseCrdt(node_id, N, wall_clock=FakeClock(),
                                executor="pallas-interpret", **kw)
        self.port = port.DenseCrdt(node_id, N, device="cpu",
                                   wall_clock=FakeClock(), **kw)

    def each(self, fn):
        return fn(self.jax), fn(self.port)

    def merge(self, lanes_and_ids):
        self.jax.merge_many([
            (JaxChangeset(**{k: jnp.asarray(v) for k, v in lanes.items()}),
             ids) for lanes, ids in lanes_and_ids])
        self.port.merge_many([
            (PortChangeset(**{k: torch.tensor(v) for k, v in lanes.items()}),
             ids) for lanes, ids in lanes_and_ids])

    def raises(self, lanes_and_ids):
        """Both replicas refuse the merge with the same exception."""
        errs = []
        for crdt, cls in ((self.jax, JaxChangeset),
                          (self.port, PortChangeset)):
            as_lane = jnp.asarray if cls is JaxChangeset else torch.tensor
            with pytest.raises(Exception) as info:
                crdt.merge_many([
                    (cls(**{k: as_lane(v) for k, v in lanes.items()}), ids)
                    for lanes, ids in lanes_and_ids])
            errs.append(info.value)
        assert type(errs[0]).__name__ == type(errs[1]).__name__
        assert str(errs[0]) == str(errs[1])
        return errs[1]

    def check(self, where):
        assert_dense_stores_equal(self.jax.store, self.port.store, where)
        assert str(self.jax.canonical_time) == str(self.port.canonical_time)
        assert self.jax._table.ids() == self.port._table.ids()


def port_hlc(h):
    return port.Hlc(h.millis, h.counter, h.node_id)


def run_writes(p, rng):
    """Ingest windows with auto flushes, reads through the overlay, and
    plain put/delete batches."""
    with p.jax.ingest(auto_flush_rows=64) as jw, \
            p.port.ingest(auto_flush_rows=64) as pw:
        for _ in range(5):
            slots = rng.choice(N, 40, replace=False)
            vals = rng.integers(-2 ** 40, 2 ** 40, 40)
            dels = rng.choice(N, 10, replace=False)
            p.each(lambda c: c.put_batch(slots, vals))
            p.each(lambda c: c.delete_batch(dels))
            for s in (int(slots[0]), int(dels[0]), int(slots[-1])):
                assert len(set(p.each(lambda c: c.get(s)))) == 1
                assert len(set(p.each(lambda c: c.is_deleted(s)))) == 1
                assert len(set(p.each(lambda c: c.contains_slot(s)))) == 1
        assert jw.flushes == pw.flushes
    assert jw.rows_committed == pw.rows_committed
    p.check("after ingest")
    slots = rng.choice(N, 30, replace=False)
    p.each(lambda c: c.put_batch(slots, 7, tombs=np.arange(30) % 4 == 0))
    p.each(lambda c: c.delete_batch(slots[:3]))
    p.check("after put/delete")


def test_op_script_matches_jax():
    p = Pair()
    rng = np.random.default_rng(0)
    run_writes(p, rng)

    # Two peers at once; "a0" sorts before "n1", so interning it shifts
    # every stored ordinal (the store lanes are re-encoded).
    ids1, ids2 = ["n0", "n2", "n3"], ["a0", "n2", "z9"]
    p.merge([(peer_changeset(1, 3, 3, 0, 40), ids1),
             (peer_changeset(2, 2, 3, 0, 40), ids2)])
    p.check("after merge_many")
    since = p.jax.canonical_time

    # A coarse pipelined window: two merges and an empty one.
    with p.jax.pipelined(), p.port.pipelined():
        p.merge([(peer_changeset(3, 4, 3, 20, 60), ids1)])
        p.merge([])
        p.merge([(peer_changeset(4, 1, 3, 30, 80), ids2)])
    p.check("after pipelined window")
    assert p.jax.stats.records_adopted == p.port.stats.records_adopted
    assert p.jax.stats.records_seen == p.port.stats.records_seen

    # Deltas out: the changeset, the packed form, records, JSON.
    (jcs, jids), (pcs, pids) = (p.jax.export_delta(since),
                                p.port.export_delta(port_hlc(since)))
    assert jids == pids
    valid = np.asarray(jcs.valid)
    np.testing.assert_array_equal(valid, pcs.valid.numpy())
    assert 0 < valid.sum() < N
    for f in ("lt", "node", "val", "tomb"):
        np.testing.assert_array_equal(np.asarray(getattr(jcs, f))[valid],
                                      getattr(pcs, f).numpy()[valid])
    (jpk, _), (ppk, _) = (p.jax.pack_since(since),
                          p.port.pack_since(port_hlc(since)))
    assert jpk.k == ppk.k == valid.sum()
    for f in ("slots", "lt", "node", "val", "tomb"):
        a, b = getattr(jpk, f), getattr(ppk, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert p.jax.to_json(since) == p.port.to_json(port_hlc(since))
    assert p.jax.to_json() == p.port.to_json()
    jrm, prm = p.jax.record_map(since), p.port.record_map(port_hlc(since))
    assert list(jrm) == list(prm)
    for slot in list(jrm)[:50]:
        assert str(jrm[slot].hlc) == str(prm[slot].hlc)
        assert str(jrm[slot].modified) == str(prm[slot].modified)
        assert jrm[slot].value == prm[slot].value
    for s in (0, 1, int(np.nonzero(valid[0])[0][0])):
        a, b = p.each(lambda c: c.get_slot_record(s))
        assert (a is None) == (b is None)
        if a is not None:
            assert (str(a.hlc), a.value, str(a.modified)) == \
                (str(b.hlc), b.value, str(b.modified))

    # A replica fed the port's export converges with one fed JAX's.
    fresh = Pair("n5")
    fresh.jax.merge(jcs, jids)
    fresh.port.merge(pcs, pids)
    fresh.check("fresh replica after export_delta")


def test_guard_exceptions_match_jax():
    p = Pair()
    run_writes(p, np.random.default_rng(1))
    canonical_ms = p.jax.canonical_time.millis - START

    # A record carrying our own id above canonical: duplicate node.
    dup = peer_changeset(5, 2, 2, 0, 10, fill=0.0)
    dup["valid"][1, 9] = True
    dup["node"][1, 9] = 0                          # "n1" in ["n1", "n7"]
    dup["lt"][1, 9] = (START + canonical_ms + 500) << 16
    err = p.raises([(dup, ["n1", "n7"])])
    assert isinstance(err, port.DuplicateNodeException)
    p.check("after duplicate-node refusal")

    # A record more than a minute past the wall clock: drift.
    drift = peer_changeset(6, 2, 2, 0, 10, fill=0.1)
    drift["valid"][0, 3] = True
    drift["lt"][0, 3] = (START + canonical_ms + 200_000) << 16
    err = p.raises([(drift, ["n7", "n8"])])
    assert isinstance(err, port.ClockDriftException)
    p.check("after drift refusal")

    # A local-node record shielded by an earlier, larger one: the batch
    # flag trips, the exact recompute clears it and the merge lands.
    shielded = peer_changeset(7, 2, 2, 0, 10, fill=0.0)
    shielded["valid"][0, 1] = shielded["valid"][1, 2] = True
    shielded["node"][0, 1], shielded["node"][1, 2] = 1, 0
    shielded["tomb"][0, 1] = False
    shielded["lt"][0, 1] = (START + canonical_ms + 900) << 16
    shielded["lt"][1, 2] = (START + canonical_ms + 400) << 16
    p.merge([(shielded, ["n1", "n7"])])
    p.check("after shielded merge")
    assert p.port.get(1) == p.jax.get(1) is not None


def test_value_width_32_overflow_refused_like_jax():
    p = Pair(value_width=32)
    cs = peer_changeset(8, 2, 2, 0, 10)
    cs["val"] = cs["val"] % 1000
    cs["val"][0, :5] = 2 ** 40
    cs["valid"][0, :5] = True
    err = p.raises([(cs, ["n0", "n2"])])
    assert isinstance(err, ValueError)
    p.check("after value-width refusal")
    with pytest.raises(ValueError):
        p.port.put_batch([1], [2 ** 40])


def test_pipelined_guard_error_matches_jax():
    p = Pair()
    dup = peer_changeset(9, 1, 2, 0, 10, fill=0.0)
    dup["valid"][0, 4] = True
    dup["node"][0, 4] = 0
    dup["lt"][0, 4] = (START + 5000) << 16
    errs = []
    for crdt, cls, lane in ((p.jax, JaxChangeset, jnp.asarray),
                            (p.port, PortChangeset, torch.tensor)):
        with pytest.raises(Exception) as info:
            with crdt.pipelined():
                crdt.merge_many([])
                crdt.merge(cls(**{k: lane(v) for k, v in dup.items()}),
                           ["n1", "n7"])
        errs.append(info.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__ \
        == "PipelinedGuardError"
    assert "first flagged at merge #1 of 2" in str(errs[1])
    assert str(errs[1]) == str(errs[0])
    p.check("after pipelined guard error")


def test_watch_events_match_jax():
    p = Pair()
    streams = p.each(lambda c: c.watch().record())
    keyed = p.each(lambda c: c.watch(slot=3).record())
    p.each(lambda c: c.put_batch([3, 4], [30, 40]))
    p.each(lambda c: c.delete_batch([4]))
    with p.jax.ingest(), p.port.ingest():
        p.each(lambda c: c.put_batch([3, 5, 3], [31, 50, 32]))
    p.merge([(peer_changeset(10, 1, 1, 0, 50, fill=0.01), ["n9"])])
    assert streams[0].events == streams[1].events
    assert keyed[0].events == keyed[1].events
    assert len(streams[1].events) > 6


def test_npz_snapshots_load_across_packages(tmp_path):
    p = Pair()
    run_writes(p, np.random.default_rng(2))
    p.merge([(peer_changeset(11, 2, 3, 0, 40), ["a0", "n0", "n2"])])
    p.jax.save(str(tmp_path / "jax.npz"))
    p.port.save(str(tmp_path / "port.npz"))

    from_port = JaxDenseCrdt.load("n1", str(tmp_path / "port.npz"),
                                  wall_clock=FakeClock(),
                                  executor="pallas-interpret")
    from_jax = port.DenseCrdt.load("n1", str(tmp_path / "jax.npz"),
                                   device="cpu", wall_clock=FakeClock())
    for a, b in ((p.port, from_port), (p.jax, from_jax)):
        assert_dense_stores_equal(a.store, b.store, "npz")
        assert a._table.ids() == b._table.ids()
    # A resumed clock rebuilds from the lanes (refreshCanonicalTime).
    p.each(lambda c: c.refresh_canonical_time())
    assert str(from_port.canonical_time) == str(from_jax.canonical_time) \
        == str(p.jax.canonical_time) == str(p.port.canonical_time)
    # Both resumed replicas keep going in lockstep.
    from_port.put_batch([1, 2], [3, 4])
    from_jax.put_batch([1, 2], [3, 4])
    assert from_port.to_json() == from_jax.to_json()
