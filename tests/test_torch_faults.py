"""Parity tests for three faults the port had against the JAX package,
each held against ``crdt_tpu`` on the same numpy inputs:

- C1: a valid entry's node ordinal in -len..-1 is counted from the end
  of the peer's id list, as the JAX package's gather counts it, before
  every ordinal is clamped into range; on `DenseCrdt` and
  `ShardedDenseCrdt`, against the ``"xla"`` and ``"pallas-interpret"``
  executors.
- C2: ``put_batch`` with repeated slots outside ``ingest()`` keeps the
  last entry of each slot in every lane, and the scatter is handed each
  slot once (on the card the winner among repeated indices of an
  indexed write is unspecified lane by lane).
- C3: `DenseCrdt.grow` against the JAX package's (lanes after growth,
  the shrink refusal, merges of a narrower peer after growth), and the
  wider-peer ``ValueError`` with the same message in both packages.
- C4: ``pack_since`` and ``merge_and_repack`` take the JAX package's
  ``sem_mode`` keyword, which ``crdt_tpu.sync.sync_packed`` always
  passes: a round between a port replica and a JAX replica converges in
  either order, each replica equal to a JAX-JAX run of the same
  operations, and an unknown mode raises the same ``ValueError``.
- C5: the snapshot loaders put the lanes on the card by default, as the
  JAX loaders put them on the default accelerator: without a card,
  ``load_dense`` / ``load_dense_with_node_ids`` raise the port's
  default-device ``RuntimeError`` unless asked for ``device="cpu"``,
  and ``DenseCrdt.load`` / ``ShardedDenseCrdt.load`` load onto the
  device (or the mesh) they are given.
- C6: the store helpers ``ops.dense.empty_dense_store`` and
  ``store_from_numpy`` place a store on the card by default, as the
  JAX ``empty_dense_store`` places it on the default accelerator:
  without a card they raise the same default-device ``RuntimeError``
  unless asked for ``device="cpu"``.
- C10: the law and audit target builders (``analysis.lattice_laws``'
  ``builtin_targets`` and ``kernel_targets``, ``analysis.op_audit``'s
  ``builtin_targets``, ``semantics.law_targets`` / ``audit_targets``)
  build on the card by default, as the JAX builders build on the
  default accelerator: without a card they raise the same
  default-device ``RuntimeError`` unless asked for ``device="cpu"``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crdt_tpu_torch as port
from crdt_tpu import DenseCrdt as JaxDense
from crdt_tpu.models.dense_crdt import ShardedDenseCrdt as JaxSharded
from crdt_tpu.ops.dense import DenseChangeset as JaxChangeset
from crdt_tpu.testing import FakeClock, assert_dense_stores_equal
from crdt_tpu_torch.models import dense_crdt as port_model
from crdt_tpu_torch.ops.dense import DenseChangeset as PortChangeset

from test_torch_sharded import meshes
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 8192                  # two TPU tiles: one per key shard of (2, 2)
START = 1_700_000_000_000


def replicas(model, executor, node_id="m", n=N):
    """A JAX replica and the port's, unsharded or on a (2, 2) mesh."""
    if model == "dense":
        return (JaxDense(node_id, n, wall_clock=FakeClock(),
                         executor=executor),
                port.DenseCrdt(node_id, n, device="cpu",
                               wall_clock=FakeClock()))
    jmesh, tmesh = meshes((2, 2))
    return (JaxSharded(node_id, n, jmesh, wall_clock=FakeClock(),
                       executor=executor),
            port.ShardedDenseCrdt(node_id, n, tmesh,
                                  wall_clock=FakeClock()))


def changeset(lanes, jax_side):
    if jax_side:
        return JaxChangeset(**{k: jnp.asarray(v) for k, v in lanes.items()})
    return PortChangeset(**{k: torch.tensor(v) for k, v in lanes.items()})


def peer_lanes(seed, rows, n=N, fill=0.3):
    rng = np.random.default_rng(seed)
    return dict(
        lt=((START + rng.integers(0, 50, (rows, n))) << 16)
        + rng.integers(0, 3, (rows, n)),
        node=rng.integers(0, 2, (rows, n)).astype(np.int32),
        val=rng.integers(-2 ** 40, 2 ** 40, (rows, n)),
        tomb=rng.random((rows, n)) < 0.3,
        valid=rng.random((rows, n)) < fill)


def assert_same(jax_crdt, port_crdt, where):
    assert_dense_stores_equal(jax_crdt.store, port_crdt.store, where)
    assert str(jax_crdt.canonical_time) == str(port_crdt.canonical_time)
    assert jax_crdt._table.ids() == port_crdt._table.ids()


# --- C1: negative node ordinals -------------------------------------------


@pytest.mark.parametrize("executor", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_negative_ordinals_attributed_as_jax(model, executor):
    """A peer with ids ``["a", "z"]`` merged into ``"m"`` (so the remap
    is not the identity): valid entries carrying -3, -2, -1 and 2 land
    as written by "a", "a", "z" and "z", as the JAX gather gives them."""
    ids = ["a", "z"]
    lanes = peer_lanes(1, 4)
    for row, ordinal in enumerate((-len(ids) - 1, -len(ids), -1, len(ids))):
        lanes["node"][row, row::5] = ordinal
        lanes["valid"][row, row::5] = True
        lanes["lt"][row, row::5] += 100 << 16      # above the other rows
    jc, pc = replicas(model, executor)
    jc.merge(changeset(lanes, True), ids)
    pc.merge(changeset(lanes, False), ids)
    assert_same(jc, pc, f"{model}/{executor}")
    table = pc._table.ids()
    got = [table[int(pc.store.node[row])] for row in range(4)]
    assert got == ["a", "a", "z", "z"]


# --- C2: repeated slots in put_batch --------------------------------------


@pytest.mark.parametrize("model", ["dense", "sharded"])
def test_put_batch_repeated_slots_keep_the_last_entry(model, monkeypatch):
    jc, pc = replicas(model, "xla")
    events = [c.watch().record() for c in (jc, pc)]
    handed = []
    real = port_model.put_scatter

    def spy(store, idx, *args, **kw):
        handed.append(idx.tolist())
        return real(store, idx, *args, **kw)

    monkeypatch.setattr(port_model, "put_scatter", spy)
    rng = np.random.default_rng(2)
    slots = np.concatenate([[3, 3, 5, 5], rng.integers(0, N, 2000),
                            [N - 1] * 5])
    vals = rng.integers(-2 ** 40, 2 ** 40, len(slots))
    vals[:4] = [1, 2, 7, 8]
    tombs = rng.random(len(slots)) < 0.5
    tombs[:4] = [False, True, True, False]
    for c in (jc, pc):
        c.put_batch(slots, vals, tombs=tombs)
        c.delete_batch([7, 7, 9])
        c.put_batch([9, 9], [90, 91])
    assert_same(jc, pc, model)
    assert pc.is_deleted(3) and pc.get(5) == 8 and pc.get(9) == 91
    last = {s: i for i, s in enumerate(slots.tolist())}
    assert pc.get(N - 1) == (None if tombs[last[N - 1]]
                             else int(vals[last[N - 1]]))
    # Each scatter saw every slot once; the watch saw every entry.
    assert handed and all(len(set(h)) == len(h) for h in handed)
    assert events[0].events == events[1].events
    assert len(events[1].events) == len(slots) + 3 + 2


# --- C3: grow and the wider-peer message ----------------------------------


def test_grow_matches_jax():
    jc, pc = replicas("dense", "xla", node_id="n1", n=4096)
    for c in (jc, pc):
        c.put_batch([0, 17, 4095], [1, 2, 3], tombs=[False, True, False])
    narrow = peer_lanes(3, 2, n=4096)
    for c, jax_side in ((jc, True), (pc, False)):
        c.merge(changeset(narrow, jax_side), ["n0", "n2"])
    errs = []
    for c in (jc, pc):
        with pytest.raises(ValueError) as info:
            c.grow(100)
        errs.append(str(info.value))
        c.grow(4096)                              # unchanged: no-op
    assert errs[0] == errs[1] and "cannot shrink 4096 -> 100" in errs[1]
    assert_same(jc, pc, "after the refusals")
    for c in (jc, pc):
        with c.ingest():
            c.put_batch([4000], [5])              # drained by grow
            c.grow(N)
        c.put_batch([N - 1, 4096], [6, 7])
    assert pc.n_slots == N and pc.get(4000) == 5 and pc.get(N - 1) == 6
    assert_same(jc, pc, "after grow")
    # A peer at the old capacity still merges: its lanes are padded.
    late = peer_lanes(4, 3, n=4096)
    late["lt"] += 10_000 << 16
    for c, jax_side in ((jc, True), (pc, False)):
        c.merge(changeset(late, jax_side), ["n0", "n2"])
    assert_same(jc, pc, "after merging the narrower peer")
    assert pc.to_json() == jc.to_json()


def test_wider_peer_refused_with_the_jax_message():
    jc, pc = replicas("dense", "xla", n=4096)
    wide = peer_lanes(5, 1, n=N)
    errs = []
    for c, jax_side in ((jc, True), (pc, False)):
        with pytest.raises(ValueError) as info:
            c.merge(changeset(wide, jax_side), ["n0"])
        errs.append(str(info.value))
    assert errs[0] == errs[1] == (
        f"peer changeset covers {N} slots but this replica holds 4096; "
        f"call grow({N}) first")
    assert_same(jc, pc, "after the refusal")


# --- C4: sem_mode -----------------------------------------------------------

# The module, not the package-level function of the same name.
jax_sync = importlib.import_module("crdt_tpu.sync")


def c4_replica(kind, node_id):
    if kind == "jax":
        return JaxDense(node_id, 64, wall_clock=FakeClock())
    return port.DenseCrdt(node_id, 64, device="cpu", wall_clock=FakeClock())


def c4_rounds(a, b):
    """Two rounds of the JAX package's `sync_packed`: a one-shot round,
    then a delta round from its watermark (its pull goes through
    ``merge_and_repack(..., sem_mode=...)``)."""
    a.put_batch([1, 2], [10, 20])
    b.put_batch([2, 3], [30, 40])
    watermark = jax_sync.sync_packed(a, b)
    a.delete_batch([1])
    b.put_batch([5, 63], [50, -1])
    jax_sync.sync_packed(a, b, since=watermark)


@pytest.mark.parametrize("order", ["port-jax", "jax-port"])
def test_jax_sync_packed_with_a_port_replica_converges(order):
    pair = [c4_replica(kind, nid)
            for kind, nid in zip(order.split("-"), ("a", "b"))]
    ref = [c4_replica("jax", nid) for nid in ("a", "b")]
    c4_rounds(*pair)
    c4_rounds(*ref)
    for got, want in zip(pair, ref):
        assert_same(want, got, f"{order}: {got.node_id}")
    for lane in ("lt", "val", "tomb", "occupied"):
        np.testing.assert_array_equal(np.asarray(getattr(pair[0].store,
                                                         lane)),
                                      np.asarray(getattr(pair[1].store,
                                                         lane)))


@pytest.mark.parametrize("op", ["pack_since", "merge_and_repack"])
def test_unknown_sem_mode_raises_like_jax(op):
    src = c4_replica("jax", "w")
    src.put_batch([4], [44])
    delta = src.pack_since(None)
    errs = []
    for kind in ("jax", "port"):
        c = c4_replica(kind, "r")
        c.put_batch([1], [1])
        with pytest.raises(ValueError) as info:
            if op == "pack_since":
                c.pack_since(None, sem_mode="typed")
            else:
                c.merge_and_repack(*delta, None, "typed")
        errs.append(str(info.value))
        assert c.get(4) is None        # refused before the merge
        for mode in ("auto", "include", "withhold"):
            assert c.pack_since(None, sem_mode=mode)[0].k == 1
    assert errs[0] == errs[1] == "unknown sem_mode 'typed'"


# --- C5: the snapshot loaders default to the card -----------------------------


def test_snapshot_loaders_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = port.DenseCrdt("s", 64, device="cpu", wall_clock=FakeClock())
    src.put_batch([1, 5, 63], [10, 50, 630])
    path = str(tmp_path / "s.npz")
    src.save(path)
    with pytest.raises(RuntimeError) as refused:
        port_model.resolve_device(None)
    for load in (port.load_dense,
                 port.checkpoint.load_dense_with_node_ids):
        with pytest.raises(RuntimeError) as e:
            load(path)
        assert str(e.value) == str(refused.value)
    store = port.load_dense(path, device="cpu")
    assert store.lt.device.type == "cpu"
    store, ids = port.checkpoint.load_dense_with_node_ids(path, "cpu")
    assert ids == ["s"] and store.val[5] == 50
    with pytest.raises(RuntimeError):
        port.DenseCrdt.load("r", path)
    back = port.DenseCrdt.load("r", path, device="cpu")
    assert back.get(63) == 630 and back.device.type == "cpu"
    _, tmesh = meshes((2, 2))
    sharded = port.ShardedDenseCrdt.load("r", path, mesh=tmesh)
    assert sharded.get(5) == 50
    jax_back = JaxDense.load("r", path, executor="xla")
    assert_dense_stores_equal(jax_back.store, back.store, "C5 load")


# --- C6: the store helpers default to the card --------------------------------


def test_store_helpers_default_to_the_card(monkeypatch):
    from crdt_tpu.ops.dense import empty_dense_store as jax_empty
    from crdt_tpu_torch.ops import dense as td
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as refused:
        port_model.resolve_device(None)
    lanes = td.store_to_numpy(td.empty_dense_store(16, "cpu"))
    for call in (lambda: td.empty_dense_store(16),
                 lambda: td.store_from_numpy(lanes),
                 lambda: td.empty_dense_store(16, None),
                 lambda: td.store_from_numpy(lanes, device=None)):
        with pytest.raises(RuntimeError) as e:
            call()
        assert str(e.value) == str(refused.value)
    host = td.empty_dense_store(16, "cpu")
    assert all(lane.device.type == "cpu" for lane in host)
    back = td.store_from_numpy(lanes, "cpu")
    assert all(lane.device.type == "cpu" for lane in back)
    # The same lanes as the JAX helper's store.
    ref = jax_empty(16)
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(back, f).numpy(), f)


# --- C10: the law and audit target builders default to the card ---------------


C10_BUILDERS = {
    "lattice_laws.builtin_targets": ("crdt_tpu_torch.analysis.lattice_laws",
                                     "builtin_targets"),
    "lattice_laws.kernel_targets": ("crdt_tpu_torch.analysis.lattice_laws",
                                    "kernel_targets"),
    "op_audit.builtin_targets": ("crdt_tpu_torch.analysis.op_audit",
                                 "builtin_targets"),
    "semantics.law_targets": ("crdt_tpu_torch.semantics", "law_targets"),
    "semantics.audit_targets": ("crdt_tpu_torch.semantics",
                                "audit_targets"),
}


@pytest.mark.parametrize("builder", sorted(C10_BUILDERS))
def test_target_builders_default_to_the_card(builder, monkeypatch):
    module, name = C10_BUILDERS[builder]
    build = getattr(importlib.import_module(module), name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as refused:
        port_model.resolve_device(None)
    with pytest.raises(RuntimeError) as e:
        build()
    assert str(e.value) == str(refused.value)
    targets = build(device="cpu")
    assert targets
    # Every target's inputs lie on the host when the host is asked for.
    for t in targets:
        made = t.fresh() if hasattr(t, "fresh") else t.build()[1]
        devices = {x.device.type for x in _tensors(made)}
        assert devices <= {"cpu"}, (t.name, devices)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)
