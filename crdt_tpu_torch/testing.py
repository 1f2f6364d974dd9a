"""Backend-agnostic CRDT conformance kit — EXPORTED API.

Port of ``crdt_tpu/testing.py`` over this package's `Hlc`, `Record`
and semantics registry; `assert_dense_stores_equal` compares torch
lanes (on any device) through numpy. It is itself a port of the
reference's exported parameterized suite
`test/crdt_test.dart:7-132`: any storage backend (in-tree or
out-of-tree, the README.md:39 plugin pattern) subclasses
:class:`CrdtConformance`, provides ``make_crdt()``, and inherits the
full behavioral test set under pytest — the same mechanism the
reference uses to keep external backends like hive_crdt conformant
(CHANGELOG.md:16). :class:`FakeClock` is the deterministic wall clock
every test should inject (the reference's own millis-injection pattern,
hlc_test.dart:185).
"""


from __future__ import annotations

import itertools

from crdt_tpu_torch import Crdt
# Fault-injection siblings of this kit: a backend proves CONFORMANCE
# here, and proves ROBUSTNESS against the scheduled-misbehavior proxy.
from crdt_tpu_torch.testing_faults import (  # noqa: F401
    FaultProxy, FaultSchedule, ProxyFarm, ScriptedSchedule)


class FakeClock:
    """Deterministic, strictly advancing wall clock for tests.

    The reference's tests order events with real sleeps
    (map_crdt_test.dart:248); injecting millis is the deterministic
    equivalent and is the reference's own pattern for clock tests
    (hlc_test.dart:185).
    """

    def __init__(self, start: int = 1_700_000_000_000, step: int = 1):
        self._millis = start
        self._step = step

    def __call__(self) -> int:
        self._millis += self._step
        return self._millis

    def advance(self, millis: int) -> None:
        self._millis += millis

    @property
    def millis(self) -> int:
        return self._millis


class CountingClock(FakeClock):
    """`FakeClock` that also counts reads.

    Tick-accounting differentials are built on this: two backends fed
    the same op sequence through counting clocks must consume the SAME
    number of wall reads, or their clocks (and so their HLC stamps)
    silently diverge under any injected clock — the failure mode the
    shared ``Crdt._decode_wall_millis`` helper exists to prevent."""

    def __init__(self, start: int = 1_700_000_000_000, step: int = 1):
        super().__init__(start, step)
        self.reads = 0

    def __call__(self) -> int:
        self.reads += 1
        return super().__call__()


def _host(lane):
    """A lane as numpy: a torch tensor on any device, or an array."""
    import numpy as np
    if hasattr(lane, "detach"):
        return lane.detach().cpu().numpy()
    return np.asarray(lane)


def assert_dense_stores_equal(a, b, where: str = "store") -> None:
    """Lane-exact equality of two `DenseStore`s on OCCUPIED slots (an
    unoccupied slot's lane contents are unobservable through
    `record_map`, so executors may differ there). The stores may sit
    on different devices. Shared by the test suite and the on-card
    check — one definition of store equality."""
    import numpy as np
    occ = _host(a.occupied)
    np.testing.assert_array_equal(occ, _host(b.occupied),
                                  err_msg=f"{where}: occupied")
    for lane in ("lt", "node", "val", "mod_lt", "mod_node", "tomb"):
        np.testing.assert_array_equal(
            _host(getattr(a, lane))[occ],
            _host(getattr(b, lane))[occ],
            err_msg=f"{where}: {lane}")


class SemanticsConformance:
    """Per-semantics lattice conformance over the typed dense surface
    (`crdt_tpu_torch.semantics`, docs/TYPES.md). The registry's law search
    proves each kernel algebraically; this suite proves the MODEL
    wiring — per-slot tag column, combiner routing, delta export and
    merge — delivers those laws end to end, for EVERY registered
    semantics: the tests iterate `semantics.names()`, so registering
    a new type without extending the workload table fails the suite
    instead of silently skipping the newcomer.

    Subclass and implement ``make_dense(node_id)`` returning an empty
    typed-capable dense model (``DenseCrdt``-shaped surface).
    Counters keep one WRITER per slot — the dense counter contract
    (`DenseCrdt.counter_add`): concurrent same-slot increments join
    by per-lane max, not addition.
    """

    n_slots = 64

    def make_dense(self, node_id):
        raise NotImplementedError

    # --- helpers ---

    def _pair(self, sem: str):
        a, b = self.make_dense("a"), self.make_dense("b")
        for c in (a, b):
            if sem != "lww":   # lww IS the untyped default (tag 0)
                c.set_semantics([0, 1], sem)
        return a, b

    @staticmethod
    def _write(c, sem: str, variant: int) -> None:
        """Replica-``variant`` (0 or 1) workload for one semantics."""
        if sem == "lww":
            c.put_batch([0, 1], [10 + variant, 20 + variant])
        elif sem == "gcounter":
            c.counter_add(variant, 5 + variant)
            c.counter_add(variant, 2)
        elif sem == "pncounter":
            c.counter_add(variant, 7)
            c.counter_add(variant, -(3 + variant))
        elif sem == "orset":
            c.orset_add(0, 1 + variant)
            if variant:
                c.orset_add(0, 3)
                c.orset_remove(0, 3)
        else:
            assert sem == "mvreg", \
                f"no conformance workload for registered " \
                f"semantics {sem!r} — extend SemanticsConformance"
            c.mvreg_put(0, 100 + variant)

    @staticmethod
    def _exchange(a, b) -> None:
        """Full bidirectional delta exchange (cold-start shape: both
        sides export everything — immune to same-millisecond watermark
        exclusion, which is a clock concern, not a semantics one)."""
        cs_a, ids_a = a.export_delta()
        cs_b, ids_b = b.export_delta()
        b.merge(cs_a, ids_a)
        a.merge(cs_b, ids_b)

    @staticmethod
    def _assert_lanes_equal(a, b, where: str) -> None:
        """Replica-visible lane equality: ``modified`` stamps are
        local-only and unoccupied slots are unobservable (ordinal
        remaps legitimately rewrite them), so compare (lt, node, val,
        tomb) at occupied slots only."""
        import numpy as np
        sa, sb = a.store, b.store
        occ = _host(sa.occupied)
        np.testing.assert_array_equal(
            occ, _host(sb.occupied), err_msg=f"{where}: occupied")
        for lane in ("lt", "node", "val", "tomb"):
            np.testing.assert_array_equal(
                _host(getattr(sa, lane))[occ],
                _host(getattr(sb, lane))[occ],
                err_msg=f"{where}: {lane}")

    # --- the per-semantics laws, end to end ---

    def test_every_registered_semantics_converges(self):
        from crdt_tpu_torch.semantics import names
        for sem in names():
            a, b = self._pair(sem)
            self._write(a, sem, 0)
            self._write(b, sem, 1)
            self._exchange(a, b)
            self._assert_lanes_equal(a, b, f"{sem}: converged")
            if sem in ("gcounter", "pncounter"):
                assert (a.counter_value(0) == b.counter_value(0)
                        and a.counter_value(1) == b.counter_value(1)
                        ), sem
            elif sem == "orset":
                assert (a.orset_members(0) == b.orset_members(0)
                        == frozenset({1, 2})), sem
            elif sem == "mvreg":
                got = a.mvreg_get(0)
                assert got == b.mvreg_get(0) and got != (), sem

    def test_every_registered_semantics_idempotent_redelivery(self):
        import numpy as np
        from crdt_tpu_torch.semantics import names
        for sem in names():
            a, b = self._pair(sem)
            self._write(a, sem, 0)
            self._write(b, sem, 1)
            cs, ids = a.export_delta()
            b.merge(cs, ids)
            before = b.store
            b.merge(cs, ids)   # exact redelivery: a no-op join
            for lane in before._fields:
                np.testing.assert_array_equal(
                    _host(getattr(before, lane)),
                    _host(getattr(b.store, lane)),
                    err_msg=f"{sem}: redelivery changed {lane}")

    def test_every_registered_semantics_merge_order_commutes(self):
        from crdt_tpu_torch.semantics import names
        for sem in names():
            a, b = self._pair(sem)
            self._write(a, sem, 0)
            self._write(b, sem, 1)
            da = a.export_delta()
            db = b.export_delta()
            # receiver names sort AFTER both writers so the interned
            # node tables end identical on both orders
            c1, c2 = self.make_dense("c1"), self.make_dense("c2")
            for c in (c1, c2):
                if sem != "lww":
                    c.set_semantics([0, 1], sem)
            c1.merge(*da)
            c1.merge(*db)
            c2.merge(*db)
            c2.merge(*da)
            self._assert_lanes_equal(c1, c2, f"{sem}: merge order")


class CrdtConformance:
    """Inherit and implement ``make_crdt`` to run the conformance suite."""

    node_id = "abc"

    def make_crdt(self) -> Crdt:
        raise NotImplementedError

    # --- Basic (crdt_test.dart:13-94) ---

    def test_node_id(self):
        assert self.make_crdt().node_id == self.node_id

    def test_empty(self):
        crdt = self.make_crdt()
        assert crdt.is_empty
        assert crdt.length == 0
        assert crdt.map == {}
        assert crdt.keys == []
        assert crdt.values == []

    def test_one_record(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        assert not crdt.is_empty
        assert crdt.length == 1
        assert crdt.map == {"x": 1}
        assert crdt.keys == ["x"]
        assert crdt.values == [1]

    def test_empty_after_deleted_record(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        crdt.delete("x")
        assert crdt.is_empty
        assert crdt.length == 0
        assert crdt.map == {}
        assert crdt.keys == []
        assert crdt.values == []

    def test_put(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        assert crdt.get("x") == 1

    def test_update_existing(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        crdt.put("x", 2)
        assert crdt.get("x") == 2

    def test_put_many(self):
        crdt = self.make_crdt()
        crdt.put_all({"x": 2, "y": 3})
        assert crdt.get("x") == 2
        assert crdt.get("y") == 3

    def test_put_all_single_timestamp(self):
        # One send per batch: all records share one HLC (crdt.dart:50-52).
        crdt = self.make_crdt()
        crdt.put_all({"x": 2, "y": 3})
        assert crdt.get_record("x").hlc == crdt.get_record("y").hlc

    def test_delete_value(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        crdt.put("y", 2)
        crdt.delete("x")
        assert crdt.is_deleted("x") is True
        assert crdt.is_deleted("y") is False
        assert crdt.get("x") is None
        assert crdt.get("y") == 2

    def test_is_deleted_missing_key(self):
        assert self.make_crdt().is_deleted("nope") is None

    def test_clear(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        crdt.put("y", 2)
        crdt.clear()
        assert crdt.is_deleted("x") is True
        assert crdt.is_deleted("y") is True
        assert crdt.get("x") is None
        assert crdt.get("y") is None

    def test_clear_purge(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        crdt.clear(purge=True)
        assert crdt.record_map() == {}

    def test_contains_key(self):
        crdt = self.make_crdt()
        crdt.put("x", 1)
        assert crdt.contains_key("x")
        assert not crdt.contains_key("y")

    # --- Watch (crdt_test.dart:96-131) ---

    def test_watch_all_changes(self):
        crdt = self.make_crdt()
        stream = crdt.watch().record()
        crdt.put("x", 1)
        crdt.put("y", 2)
        got = {(e.key, e.value) for e in stream.events}
        assert {("x", 1), ("y", 2)} <= got

    def test_watch_key(self):
        crdt = self.make_crdt()
        stream = crdt.watch(key="y").record()
        crdt.put("x", 1)
        crdt.put("y", 2)
        assert [(e.key, e.value) for e in stream.events] == [("y", 2)]

    def test_watch_put_all_unordered(self):
        # putAll emits one event per record; delivery order is
        # unspecified (the reference asserts emitsInAnyOrder,
        # crdt_test.dart:106-114).
        crdt = self.make_crdt()
        stream = crdt.watch().record()
        crdt.put_all({"x": 1, "y": 2, "z": 3})
        assert sorted((e.key, e.value) for e in stream.events) == \
            [("x", 1), ("y", 2), ("z", 3)]

    def test_watch_delete_emits_none(self):
        # Deletes notify with a null value (crdt_test.dart:116-122:
        # MapEntry(key, null)).
        crdt = self.make_crdt()
        crdt.put("x", 1)
        stream = crdt.watch().record()
        crdt.delete("x")
        assert ("x", None) in [(e.key, e.value) for e in stream.events]

    def test_watch_merge_emits_winners_only(self):
        # Merge-driven reactivity: adopted records reach putRecords and
        # emit (map_crdt.dart:33-39); LWW losers never do. Includes a
        # merged-in tombstone (value None event) and the idempotent
        # re-merge (no events).
        cs1, cs2, _ = self._seeded_changesets()
        crdt = self.make_crdt()
        stream = crdt.watch().record()
        crdt.merge(dict(cs1))          # both records new -> both emit
        assert sorted((e.key, e.value) for e in stream.events) == \
            [("x", 1), ("y", 7)]
        crdt.merge(dict(self._seeded_changesets()[0]))  # idempotent
        assert len(stream.events) == 2  # no new events
        # cs2: "x" ties on logical time, nodeB > nodeA -> remote wins;
        # "z" is a new tombstone -> merge-driven None event.
        crdt.merge(dict(cs2))
        assert sorted(((e.key, e.value) for e in stream.events[2:]),
                      key=lambda kv: kv[0]) == [("x", 2), ("z", None)]

    def test_watch_key_filter_under_merge(self):
        # Per-key filtering applies to merge-driven events too
        # (crdt_test.dart:124-131 shape, driven through merge).
        cs1, _, cs3 = self._seeded_changesets()
        crdt = self.make_crdt()
        stream = crdt.watch(key="y").record()
        crdt.merge(dict(cs1))          # y=7 wins, x=1 wins (filtered out)
        crdt.merge(dict(cs3))          # y=9 wins, z=4 wins (filtered out)
        assert [(e.key, e.value) for e in stream.events] == \
            [("y", 7), ("y", 9)]

    def test_watch_bulk_merge_events(self):
        # Bulk-merge reactivity at batch size: winners (and ONLY
        # winners) emit — new keys, newer updates, merged-in
        # tombstones — while LWW losers stay silent; a key-filtered
        # stream sees exactly its key; an idempotent re-merge emits
        # nothing. Pins the batch emission path the vectorized
        # backends use (hub.add_batch), not just single-record adds.
        from crdt_tpu_torch import Hlc, Record
        base = 1_700_000_000_000
        crdt = self.make_crdt()
        crdt.put_all({f"mine{i}": 100 + i for i in range(20)})
        mk = lambda ms, v: Record(Hlc(ms, 0, "peer"), v,
                                  Hlc(ms, 0, "peer"))
        cs = {}
        for i in range(20):
            cs[f"mine{i}"] = mk(base - 1000, -1)     # losers: too old
        for i in range(20):
            cs[f"new{i}"] = mk(base + 100 + i,
                               None if i % 5 == 0 else i)
        whole = crdt.watch().record()
        keyed = crdt.watch(key="new7").record()
        crdt.merge(dict(cs))
        got = sorted((e.key, e.value) for e in whole.events)
        want = sorted((f"new{i}", None if i % 5 == 0 else i)
                      for i in range(20))
        assert got == want, f"winner events wrong: {got[:5]}..."
        assert [(e.key, e.value) for e in keyed.events] == [("new7", 7)]
        crdt.merge(dict(cs))                          # idempotent
        assert len(whole.events) == 20
        assert len(keyed.events) == 1

    # --- Merge algebra: the CRDT laws (SURVEY.md §5 race-detection
    # equivalent — commutativity/associativity/idempotence under
    # permutation, map_crdt_test.dart:252-269 in spirit) ---

    def _seeded_changesets(self):
        from crdt_tpu_torch import Hlc, Record
        base = 1_700_000_000_000
        mk = lambda ms, c, n, v: Record(Hlc(ms, c, n), v, Hlc(ms, c, n))
        cs1 = {"x": mk(base + 5, 0, "nodeA", 1), "y": mk(base + 1, 0, "nodeA", 7)}
        cs2 = {"x": mk(base + 5, 0, "nodeB", 2), "z": mk(base + 3, 1, "nodeB", None)}
        cs3 = {"y": mk(base + 9, 2, "nodeC", 9), "z": mk(base + 3, 0, "nodeC", 4)}
        return [cs1, cs2, cs3]

    def test_merge_commutative_associative(self):
        changesets = self._seeded_changesets()
        results = []
        for perm in itertools.permutations(range(3)):
            crdt = self.make_crdt()
            for i in perm:
                crdt.merge(dict(self._seeded_changesets()[i]))
            results.append({k: (r.hlc, r.value)
                            for k, r in crdt.record_map().items()})
        assert all(r == results[0] for r in results[1:])

    def test_merge_idempotent(self):
        cs = self._seeded_changesets()[0]
        crdt = self.make_crdt()
        crdt.merge(dict(cs))
        snapshot = {k: (r.hlc, r.value) for k, r in crdt.record_map().items()}
        crdt.merge(dict(self._seeded_changesets()[0]))
        again = {k: (r.hlc, r.value) for k, r in crdt.record_map().items()}
        assert snapshot == again
