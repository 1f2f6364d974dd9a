"""Package-level checks of the PyTorch port `crdt_tpu_torch`: it stands
alone (no jax, nothing of `crdt_tpu`), it refuses to run on the host
unless asked, and its copied host layer (HLC, record and JSON codecs,
node table, checkpoint format, watch hub) behaves exactly like the JAX
package's.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import crdt_json as jax_json
from crdt_tpu.ops import packing as jax_packing
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import _build, crdt_json as port_json
from crdt_tpu_torch import checkpoint as port_ckpt
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import packing as port_packing
from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "crdt_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_crdt_tpu(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        # The root modules bench and benchmarks import jax too.
        assert top not in ("jax", "jaxlib", "crdt_tpu", "bench",
                           "benchmarks"), (path, mod)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.DenseCrdt("n0", 16)
    assert port.DenseCrdt("n0", 16, device="cpu").device.type == "cpu"
    # A mesh takes the cards unless it is given devices.
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* 4"):
        port.parallel.make_fanin_mesh(2, 2)
    mesh = port.parallel.make_fanin_mesh(2, 2, devices=["cpu"] * 4)
    assert port.ShardedDenseCrdt("n0", 16, mesh).device.type == "cpu"


def test_any_slot_count_works():
    """No tile alignment: any n_slots, any replica row count."""
    c = port.DenseCrdt("n0", 37, device="cpu", wall_clock=FakeClock())
    c.put_batch([0, 36], [1, 2])
    cs, ids = c.export_delta()
    d = port.DenseCrdt("n1", 37, device="cpu", wall_clock=FakeClock())
    d.merge_many([(cs, ids)] * 3)
    assert (d.get(0), d.get(36), d.get(5)) == (1, 2, None)


@pytest.mark.parametrize("millis,counter,node", [
    (0, 0, "a"), (1_700_000_000_123, 0xFFFF, "node-with-dash"),
    (253_402_300_790_000, 7, "z")])
def test_hlc_copy_matches_jax(millis, counter, node):
    a = crdt_tpu.Hlc(millis, counter, node)
    b = port.Hlc(millis, counter, node)
    assert str(a) == str(b) and a.pack() == b.pack()
    assert a.logical_time == b.logical_time
    assert str(port.Hlc.parse(str(a))) == str(a)
    assert str(port.Hlc.unpack(a.pack())) == str(crdt_tpu.Hlc.unpack(a.pack()))
    for wall in (millis - 5, millis, millis + 5):
        if counter < 0xFFFF or wall > millis:
            assert str(crdt_tpu.Hlc.send(a, millis=wall)) == \
                str(port.Hlc.send(b, millis=wall))
    ja, jl = crdt_tpu.Hlc.send_batch(a, 1, millis=millis + 1)
    pa, pl = port.Hlc.send_batch(b, 1, millis=millis + 1)
    assert (str(ja), jl) == (str(pa), pl)


def test_hlc_guards_match_jax():
    for mod in (crdt_tpu, port):
        canonical = mod.Hlc(1000, 0, "me")
        with pytest.raises(mod.DuplicateNodeException):
            mod.Hlc.recv(canonical, mod.Hlc(2000, 0, "me"), millis=2000)
        with pytest.raises(mod.ClockDriftException):
            mod.Hlc.recv(canonical, mod.Hlc(200_000, 0, "x"), millis=1000)
        with pytest.raises(mod.OverflowException):
            mod.Hlc.send_batch(mod.Hlc(1000, 0xFFF0, "me"), 100, millis=1)


def test_json_codec_matches_jax_pure_path():
    records = {k: crdt_tpu.Record(crdt_tpu.Hlc(1_700_000_000_000 + k, k,
                                               f"n{k % 3}"),
                                  None if k % 4 == 0 else k * 7,
                                  crdt_tpu.Hlc(1, 0, "x"))
               for k in range(20)}
    port_records = {k: port.Record(port.Hlc(r.hlc.millis, r.hlc.counter,
                                            r.hlc.node_id), r.value,
                                   port.Hlc(1, 0, "x"))
                    for k, r in records.items()}
    wire = jax_json.encode(records)
    assert port_json.encode(port_records) == wire
    canonical = port.Hlc(5, 0, "me")
    decoded = port_json.decode(wire, canonical, now_millis=10)
    ref = jax_json.decode(wire, crdt_tpu.Hlc(5, 0, "me"), now_millis=10)
    assert [(k, str(r.hlc), r.value, str(r.modified))
            for k, r in decoded.items()] == \
        [(k, str(r.hlc), r.value, str(r.modified)) for k, r in ref.items()]


def test_node_table_matches_jax():
    ids = ["n3", "n1", "a", "n2"]
    a, b = jax_packing.NodeTable(ids), port_packing.NodeTable(ids)
    for new in (["n0"], ["zz", "b"], ["n1"]):
        ra, rb = a.intern(new), b.intern(new)
        assert (ra is None and rb is None) or np.array_equal(ra, rb)
        assert a.ids() == b.ids()
    np.testing.assert_array_equal(a.encode(["zz", "a", "n2"]),
                                  b.encode(["zz", "a", "n2"]))


def test_store_numpy_round_trip_copies(tmp_path):
    rng = np.random.default_rng(0)
    lanes = {f: rng.integers(0, 2 if dt == torch.bool else 100, 32)
             .astype(np.dtype(str(dt).split(".")[1]))
             for f, dt in td.STORE_DTYPES.items()}
    store = td.store_from_numpy(lanes, "cpu")
    store.lt[0] = -1                     # must not write through
    assert lanes["lt"][0] != -1
    back = td.store_to_numpy(td.store_from_numpy(lanes, "cpu"))
    for f in lanes:
        np.testing.assert_array_equal(back[f], lanes[f])
        assert back[f].dtype == lanes[f].dtype
    path = str(tmp_path / "s.npz")
    port_ckpt.save_dense(td.store_from_numpy(lanes, "cpu"), path)
    loaded, ids = port_ckpt.load_dense_with_node_ids(path, device="cpu")
    assert ids is None
    for f in lanes:
        np.testing.assert_array_equal(getattr(loaded, f).numpy(), lanes[f])
    from crdt_tpu import load_dense as jax_load_dense
    jax_store = jax_load_dense(path)
    for f in lanes:
        np.testing.assert_array_equal(np.asarray(getattr(jax_store, f)),
                                      lanes[f])


def test_load_refuses_lane_only_snapshot(tmp_path):
    path = str(tmp_path / "lanes.npz")
    port_ckpt.save_dense(td.empty_dense_store(8, "cpu"), path)
    with pytest.raises(ValueError, match="no node-id table"):
        port.DenseCrdt.load("n0", path, device="cpu")


def test_row_stride_check_takes_column_blocks():
    """The K1 wrapper's lane check: a key shard's column block of wider
    lanes passes with its row stride, lanes with no rows pass whatever
    their strides, and column-major or mixed strides are refused."""
    lanes = dict(lt=torch.zeros((6, 40), dtype=torch.int64),
                 valid=torch.zeros((6, 40), dtype=torch.bool))
    dtypes = {"lt": torch.int64, "valid": torch.bool}
    block = {f: x[2:5, 8:24] for f, x in lanes.items()}
    assert td.check_rows("k", block, dtypes, (3, 16), torch.device("cpu")) \
        == 40
    empty = {f: torch.empty((0, 16), dtype=dt).as_strided((0, 16), (0, 0))
             for f, dt in dtypes.items()}
    assert td.check_rows("k", empty, dtypes, (0, 16), torch.device("cpu")) \
        == 16
    for bad in ({**block, "lt": lanes["lt"].t().contiguous().t()[2:5, :16]},
                {**block, "valid": block["valid"].contiguous()}):
        with pytest.raises(ValueError, match="contiguous rows"):
            td.check_rows("k", bad, dtypes, (3, 16), torch.device("cpu"))


def test_written_store_handed_out_stays_unchanged():
    """A store read through `store` is not written in place later."""
    c = port.DenseCrdt("n0", 8, device="cpu", wall_clock=FakeClock())
    c.put_batch([1], [10])
    snap = c.store
    c.put_batch([1], [20])
    with c.ingest():
        c.put_batch([2], [30])
    assert int(snap.val[1]) == 10 and not bool(snap.occupied[2])
    assert (c.get(1), c.get(2)) == (20, 30)


def test_refusals_inside_windows():
    c = port.DenseCrdt("n0", 8, device="cpu", wall_clock=FakeClock())
    with c.pipelined():
        with pytest.raises(RuntimeError, match="host clock"):
            c.put_batch([1], [1])
        with pytest.raises(RuntimeError, match="do not nest"):
            with c.pipelined():
                pass
    with c.ingest():
        with pytest.raises(RuntimeError, match="do not nest"):
            with c.ingest():
                pass
    with pytest.raises(IndexError):
        c.put_batch([8], [1])
    with pytest.raises(ValueError, match="holds 8"):
        cs, ids = port.DenseCrdt("n1", 9, device="cpu").export_delta()
        c.merge(cs, ids)


def test_async_watch_iterator_delivers():
    import asyncio
    c = port.DenseCrdt("n0", 8, device="cpu", wall_clock=FakeClock())

    async def consume():
        it = c.watch().aiter()
        c.put_batch([3], [4])
        c.delete_batch([3])
        it.close()
        return [e async for e in it]

    assert asyncio.run(consume()) == [port.ChangeEvent(3, 4),
                                      port.ChangeEvent(3, None)]


def test_launch_counters_and_build_paths():
    obs_device.reset()
    assert obs_device.launches() == dict.fromkeys(obs_device.KERNELS, 0)
    obs_device.note_launch("fanin_batch")
    assert obs_device.launches()["fanin_batch"] == 1
    obs_device.reset()
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)   # stable tag
        assert (_build.CSRC / f"{name}.cu").exists()
    # One source per kernel; K1 is counted apart where the sharded step
    # launches it on a block.
    assert set(_build.SOURCES) == {
        "fanin_batch", "ingest_scatter", "fanin_split", "fanin_stream",
        "probe_join", "probe_copy", "probe_stream_noguard",
        "probe_copy_batch"}
    assert set(obs_device.KERNELS) == set(_build.SOURCES) | {
        "fanin_batch_sharded"}
    # The AST import check above covers every module of the port.
    assert {"split.py", "stream_kernel.py", "fanin_kernel.py",
            "fanin.py", "probe.py", "probe_kernel.py", "data.py",
            "merge.py", "tpu_map_crdt.py", "sqlite_crdt.py", "testing.py",
            "collective.py"} <= {p.name for p in PORT_FILES}
    assert {"crdt_tpu_torch/collective.py",
            "crdt_tpu_torch/parallel/collective.py"} <= {
        str(p.relative_to(ROOT)) for p in PORT_FILES}


def test_cpu_wrappers_of_every_kernel_launch_nothing():
    """On CPU tensors every path — ingest, merge, merge_split in each
    window, the stream replay, the sharded model on a CPU mesh — takes
    the plain versions: no launch counter moves."""
    from crdt_tpu_torch.ops import stream_kernel
    obs_device.reset()
    c = port.DenseCrdt("n0", 64, device="cpu", wall_clock=FakeClock())
    with c.ingest():
        c.put_batch([1, 5, 63], [10, 50, 630])
    scs, ids = c.export_split_delta()
    d = port.DenseCrdt("n1", 64, device="cpu", wall_clock=FakeClock())
    d.merge(*c.export_delta())
    d.merge_split(scs, ids)
    for exact in (False, True):
        with d.pipelined(exact_guards=exact):
            d.merge_split(scs, ids)
    _, res = stream_kernel.fanin_stream(
        c.store, td.store_to_changeset(c.store), 0, 1, 1_700_000_000_000,
        n_chunks=3)
    s = port.ShardedDenseCrdt(
        "n2", 64, port.parallel.make_fanin_mesh(2, 2, devices=["cpu"] * 4),
        wall_clock=FakeClock())
    with s.ingest():
        s.put_batch([2, 40], [20, 400])
    s.merge(*c.export_delta())
    with s.pipelined():
        s.merge_split(scs, ids)
    assert obs_device.launches() == dict.fromkeys(obs_device.KERNELS, 0)
    assert (s.get(1), s.get(2), s.get(40)) == (10, 20, 400)
    # From chunk 1 on the replayed records beat their own store slots.
    assert d.get(5) == 50 and int(res.win.sum()) == 3


# The JAX package's exports the port does not carry yet (ROADMAP A10 and
# A11: the serving tier, routing, federation, autoscaling and
# replication), the Pallas entries of its ops (the port's kernels are in
# csrc/, behind the same ops), and the port's own module exports.
JAX_ONLY = {
    "crdt_tpu": {"ServeTier", "RoutingTable", "PartitionRouter",
                 "FederatedTier", "FederatedClient", "Autoscaler",
                 "ReplicaGroup", "Replicator"},
    "crdt_tpu.ops": {"SplitStore", "SplitChangeset", "PallasFaninResult",
                     "pallas_fanin_batch", "pallas_fanin_step",
                     "pallas_fanin_stream", "split_store",
                     "split_changeset", "join_store", "tile_changeset",
                     "model_fanin_split", "pad_split_rows", "split_to_wide",
                     "TILE"},
    "crdt_tpu.utils": set(),
}
PORT_ONLY = {"crdt_tpu": {"parallel", "semantics"}}


@pytest.mark.parametrize("name", sorted(JAX_ONLY))
def test_exports_match_jax_but_the_named_entries(name):
    import importlib
    jax_mod = importlib.import_module(name)
    port_mod = importlib.import_module(name.replace("crdt_tpu",
                                                    "crdt_tpu_torch", 1))
    jax_all = [n for n in jax_mod.__all__ if n not in JAX_ONLY[name]]
    port_all = [n for n in port_mod.__all__
                if n not in PORT_ONLY.get(name, ())]
    assert sorted(jax_all) == sorted(port_all)
    assert len(set(port_all)) == len(port_all)
    for n in port_mod.__all__:
        assert hasattr(port_mod, n), n
    assert JAX_ONLY[name] <= set(jax_mod.__all__)


def test_host_layer_leftovers_match_jax(tmp_path):
    """`pack_logical_time` / `unpack_logical_time`, `arena_of`,
    `checkpoint.load_dense_node_ids` and the `utils` exports."""
    from crdt_tpu import checkpoint as jax_ckpt
    from crdt_tpu import utils as jax_utils
    from crdt_tpu_torch import utils as port_utils
    for ms, c in ((0, 0), (1_700_000_000_123, 0xFFFF), (5, 7)):
        lt = port_packing.pack_logical_time(ms, c)
        assert lt == jax_packing.pack_logical_time(ms, c)
        assert port_packing.unpack_logical_time(lt) == \
            jax_packing.unpack_logical_time(lt) == (ms, c)
    c = port.DenseCrdt("n0", 64, device="cpu", wall_clock=FakeClock())
    c.put_batch([1, 5, 9], [10, 50, 90])
    packed, _ = c.pack_since()
    arena = port_packing.arena_of(packed.lt)
    assert all(port_packing.arena_of(lane) is arena for lane in packed
               if lane is not None)
    path = str(tmp_path / "s.npz")
    c.save(path)
    assert port_ckpt.load_dense_node_ids(path) == \
        jax_ckpt.load_dense_node_ids(path) == ["n0"]
    lanes = str(tmp_path / "lanes.npz")
    port_ckpt.save_dense(td.empty_dense_store(8, "cpu"), lanes)
    assert port_ckpt.load_dense_node_ids(lanes) is None
    assert port_utils.__all__ == jax_utils.__all__
    assert port.KeyDecoder is port.record.KeyDecoder
