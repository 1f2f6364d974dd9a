"""Parity tests of the record-map surface of the port (the `Crdt` base,
`MapCrdt`, `KeyedDenseCrdt`, the ``sync`` / ``sync_json`` rounds and the
JSON and gossip-state checkpoints) against ``crdt_tpu`` on the CPU:

- the port's ``CrdtConformance`` (``crdt_tpu_torch/testing.py``, over
  the port's own ``Hlc`` and ``Record``) on the port's `MapCrdt` and on
  `KeyedDenseCrdt` over the port's `DenseCrdt` and `ShardedDenseCrdt`,
  and a check that it defines the JAX kit's tests;
- the same op script on each package's replica: ``to_json`` bytes,
  record maps, watch events and clocks equal, typed keys included;
- ``sync`` and ``sync_json`` between a port replica and a JAX replica in
  both orders, each pair equal to a JAX-JAX run;
- ``save_json`` / ``load_json`` and ``save_gossip_state`` /
  ``load_gossip_state``: each package loads what the other saved, and
  both refuse the same foreign files.
"""

import importlib

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import checkpoint as jax_ckpt
from crdt_tpu import testing as jax_testing
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch import testing as port_testing
from crdt_tpu_torch import checkpoint as port_ckpt
from crdt_tpu_torch.obs import device as obs_device

from torch_threads import cap_torch_threads

cap_torch_threads()

# The modules, not the package-level functions of the same name.
jax_sync = importlib.import_module("crdt_tpu.sync")
port_sync = importlib.import_module("crdt_tpu_torch.sync")

BASE = 1_700_000_000_000
PKGS = {"jax": crdt_tpu, "port": port}


PortKit = port_testing.CrdtConformance


def test_port_kit_defines_the_jax_kits_tests():
    for kit in ("CrdtConformance", "SemanticsConformance"):
        names = [{n for n in dir(getattr(m, kit)) if n.startswith("test_")}
                 for m in (jax_testing, port_testing)]
        assert names[0] == names[1], kit


class TestPortMapConformance(PortKit):
    def make_crdt(self):
        return port.MapCrdt("abc", wall_clock=FakeClock())


class TestPortKeyedDenseConformance(PortKit):
    def make_crdt(self):
        return port.KeyedDenseCrdt(port.DenseCrdt(
            "abc", 64, device="cpu", wall_clock=FakeClock()))


class TestPortKeyedShardedConformance(PortKit):
    def make_crdt(self):
        mesh = port.parallel.make_fanin_mesh(2, 2, devices=["cpu"] * 4)
        return port.KeyedDenseCrdt(port.ShardedDenseCrdt(
            "abc", 64, mesh, wall_clock=FakeClock()))


def make(pkg, kind, node_id, start=BASE, n=8):
    """A replica of ``kind`` in package ``pkg``: the host `MapCrdt`, or
    `KeyedDenseCrdt` over an unsharded dense model of ``n`` slots (it
    doubles as keys arrive)."""
    mod = PKGS[pkg]
    if kind == "map":
        return mod.MapCrdt(node_id, wall_clock=FakeClock(start))
    if pkg == "jax":
        dense = mod.DenseCrdt(node_id, n, wall_clock=FakeClock(start),
                              executor="xla")
    else:
        dense = mod.DenseCrdt(node_id, n, device="cpu",
                              wall_clock=FakeClock(start))
    return mod.KeyedDenseCrdt(dense)


def script(c, seed):
    """Keyed writes, deletes, a mixed put_all, merges of foreign records (in the replica's own package's types) and
    JSON; a keyed replica also takes typed keys."""
    rng = np.random.default_rng(seed)
    mod = crdt_tpu if isinstance(c, (crdt_tpu.Crdt,)) else port
    keys = [f"k{i}" for i in range(24)]
    for i in range(6):
        c.put(keys[int(rng.integers(0, 24))], int(rng.integers(-99, 99)))
    c.put_all({keys[i]: (None if i % 5 == 0 else i * 3) for i in range(8)})
    c.delete(keys[3])
    rec = mod.Record(mod.Hlc(BASE + 500, 2, "peer"), 77,
                     mod.Hlc(BASE + 500, 2, "peer"))
    c.merge({"far": rec, keys[1]: rec})
    c.merge_json('{"j1": {"hlc": "' + str(mod.Hlc(BASE + 9, 0, "zz"))
                 + '", "value": 5}}')
    if isinstance(c, mod.KeyedDenseCrdt):
        c.set_semantics(["hits", "debt"], "pncounter")
        c.set_semantics(["tags"], "orset")
        c.set_semantics(["who"], "mvreg")
        c.counter_add("hits", 4)
        c.counter_add("debt", -7)
        c.orset_add("tags", 3)
        c.orset_add("tags", 9)
        c.orset_remove("tags", 3)
        c.mvreg_put("who", 123)
        with c.ingest():
            c.counter_add("hits", 2)
            c.put("staged", 1)
            c.counter_add("hits", 2)
        return (c.counter_value("hits"), c.counter_value("debt"),
                c.orset_members("tags"), c.mvreg_get("who"),
                c.semantics_of("hits").name, c.semantics_of("nope").name)
    return None


def view(c):
    return (c.to_json(), sorted(c.map.items()), str(c.canonical_time),
            {k: (str(r.hlc), r.value, str(r.modified))
             for k, r in c.record_map().items()})


@pytest.mark.parametrize("kind", ["map", "keyed"])
def test_same_script_same_json_and_events(kind):
    got = {}
    for pkg in PKGS:
        c = make(pkg, kind, "me")
        events = c.watch().record()
        typed = script(c, 1)
        got[pkg] = (view(c), typed,
                    [(e.key, e.value) for e in events.events])
    assert got["jax"] == got["port"]
    if kind == "keyed":
        assert got["port"][1][:4] == (8, -7, frozenset({9}), (123,))


def test_keyed_compact_and_gc_match_jax():
    out = {}
    for pkg in PKGS:
        c = make(pkg, "keyed", "me")
        script(c, 2)
        c.delete("k5")
        head = c.canonical_time
        purged = c.gc_purge(head, drift_slack_ms=0)
        kept = c.compact()
        c.put("after", 9)
        out[pkg] = (purged, kept, view(c), c._slot_keys,
                    c.dense.n_slots, c.dense.digest_tree().root)
    assert out["jax"] == out["port"]


class Across:
    """A record-map replica of one package seen through the other's
    record and clock types: the surface `sync` reads and writes."""

    def __init__(self, crdt):
        self.crdt = crdt
        self.own = port if isinstance(crdt, port.Crdt) else crdt_tpu
        self.other = crdt_tpu if self.own is port else port

    @staticmethod
    def hlc(h, mod):
        return mod.Hlc(h.millis, h.counter, h.node_id)

    def records(self, rmap, mod):
        return {k: mod.Record(self.hlc(r.hlc, mod), r.value,
                              self.hlc(r.modified, mod))
                for k, r in rmap.items()}

    @property
    def canonical_time(self):
        return self.hlc(self.crdt.canonical_time, self.other)

    def record_map(self, modified_since=None):
        return self.records(self.crdt.record_map(
            None if modified_since is None
            else self.hlc(modified_since, self.own)), self.other)

    def merge(self, rmap):
        self.crdt.merge(self.records(rmap, self.own))


@pytest.mark.parametrize("kind", ["map", "keyed"])
@pytest.mark.parametrize("order", ["port_local", "jax_local"])
@pytest.mark.parametrize("round_", ["sync", "sync_json"])
def test_sync_rounds_across_packages(kind, order, round_):
    """Round 1 by the port's function, a write, round 2 by JAX's: the
    mixed pair ends equal, replica by replica, to a JAX-JAX pair."""
    def run(pkgs, mods):
        a = make(pkgs[0], kind, "a")
        b = make(pkgs[1], kind, "b", start=BASE + 1000)
        script(a, 3)
        script(b, 4)
        for i, mod in enumerate(mods):
            # Record maps cross into the remote in its own package's
            # types; the JSON wire needs no adapter.
            pair = (a, b if round_ == "sync_json" or pkgs[0] == pkgs[1]
                    else Across(b))
            getattr(mod, round_)(*pair)
            a.put(f"later{i}", i)
        return a, b

    mixed = ("port", "jax") if order == "port_local" else ("jax", "port")
    a, b = run(mixed, (port_sync, jax_sync))
    ra, rb = run(("jax", "jax"), (jax_sync, jax_sync))
    assert view(a) == view(ra) and view(b) == view(rb)
    # Converged but for the last local write and the typed keys, whose
    # rows an LWW-framed payload never joins (withheld both ways).
    skip = {"later1", "hits", "debt", "tags", "who"}
    assert {k: v for k, v in a.map.items() if k not in skip} == \
        {k: v for k, v in b.map.items() if k not in skip}


def test_sync_json_map_with_keyed_typed_peer():
    """A keyed replica's typed keys go out as their raw lanes over JSON
    (the JAX package's wire has no tags there) and come back withheld:
    a `MapCrdt` peer never rewrites a typed slot."""
    out = {}
    for pkg in PKGS:
        k = make(pkg, "keyed", "k")
        m = make(pkg, "map", "m", start=BASE + 50)
        script(k, 5)
        script(m, 6)
        m.put("hits", 1_000)            # an LWW write to a typed key
        getattr(port_sync if pkg == "port" else jax_sync,
                "sync_json")(k, m)
        out[pkg] = (view(k), view(m), k.counter_value("hits"))
    assert out["jax"] == out["port"]
    assert out["port"][2] == 8


@pytest.mark.parametrize("kind", ["map", "keyed"])
def test_json_checkpoint_loads_across_packages(kind, tmp_path):
    srcs = {}
    for pkg, ckpt in (("jax", jax_ckpt), ("port", port_ckpt)):
        c = make(pkg, kind, "me")
        script(c, 7)
        ckpt.save_json(c, str(tmp_path / f"{pkg}.json"))
        srcs[pkg] = c
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    for saver in PKGS:
        path = str(tmp_path / f"{saver}.json")
        back = [ckpt.load_json(PKGS[pkg].MapCrdt, "me", path,
                               wall_clock=FakeClock())
                for pkg, ckpt in (("jax", jax_ckpt), ("port", port_ckpt))]
        assert view(back[0]) == view(back[1])
        assert back[1].to_json() == srcs[saver].to_json()


def test_gossip_state_round_trips_across_packages(tmp_path):
    marks = {"peer-a": port.Hlc(BASE, 3, "peer-a"), "b": None,
             "c": port.Hlc(BASE + 9, 0, "c")}
    jmarks = {k: None if v is None else crdt_tpu.Hlc(v.millis, v.counter,
                                                      v.node_id)
              for k, v in marks.items()}
    port_ckpt.save_gossip_state(str(tmp_path / "p.json"), "n1", marks)
    jax_ckpt.save_gossip_state(str(tmp_path / "j.json"), "n1", jmarks)
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    for path in ("p.json", "j.json"):
        got = [{k: str(v) for k, v in ckpt.load_gossip_state(
                    str(tmp_path / path), "n1").items()}
               for ckpt in (port_ckpt, jax_ckpt)]
        assert got[0] == got[1] == {"peer-a": str(marks["peer-a"]),
                                    "c": str(marks["c"])}
    for ckpt in (port_ckpt, jax_ckpt):
        assert ckpt.load_gossip_state(str(tmp_path / "none.json"),
                                      "n1") == {}
    (tmp_path / "foreign.json").write_text('{"magic": "x"}')
    for path, node in (("p.json", "n2"), ("foreign.json", "n1")):
        errs = []
        for ckpt in (port_ckpt, jax_ckpt):
            with pytest.raises(ValueError) as e:
                ckpt.load_gossip_state(str(tmp_path / path), node)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_map_crdt_runs_on_the_host_only():
    """`MapCrdt` is host code: a merge launches nothing."""
    obs_device.reset()
    a, b = make("port", "map", "a"), make("port", "map", "b")
    script(a, 8)
    port_sync.sync(a, b)
    assert sum(obs_device.launches().values()) == 0
    assert sum(obs_device.op_launches().values()) == 0
    assert a.map == b.map
