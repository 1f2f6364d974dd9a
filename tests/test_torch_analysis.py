"""The port's analysis layer (`crdt_tpu_torch.analysis`) against the JAX
package's (`crdt_tpu.analysis`): the host linter and the lock-order
analyzer on the same sources, the law search over the port's plain ops
and hand-kernel wrappers (their plain versions here), the op audit, the
runtime sanitizers and the CLI gate. Equal findings, lanes and text:
the tolerance is 0.
"""

import ast
import io
import json
import os
import textwrap
import threading
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu.analysis import cli as jax_cli
from crdt_tpu.analysis import concurrency as jax_conc
from crdt_tpu.analysis import host_lint as jax_lint
from crdt_tpu.analysis import lattice_laws as jax_laws
from crdt_tpu.analysis import sanitizer as jax_san
from crdt_tpu.testing import FakeClock
from crdt_tpu_torch.analysis import cli as port_cli
from crdt_tpu_torch.analysis import concurrency as port_conc
from crdt_tpu_torch.analysis import host_lint as port_lint
from crdt_tpu_torch.analysis import lattice_laws as port_laws
from crdt_tpu_torch.analysis import op_audit
from crdt_tpu_torch.analysis import sanitizer as port_san
from crdt_tpu_torch.obs import device as obs_device
from torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PORT_PKG = os.path.join(REPO, "crdt_tpu_torch")
STATIC_FIXTURES = ("racy_gossip.py", "deadlock_cycle.py",
                   "blocking_hold.py", "unfenced_purge.py")


def _key(findings):
    return [(f.rule, f.line, f.message) for f in findings]


def _load(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "fixture_" + os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ C9: watch


def test_watch_iterator_lock_is_the_contract_lock(monkeypatch):
    """The async watch bridge's lock carries the JAX package's contract:
    an `OrderedLock` named ``AsyncChangeIterator._lock`` at rank 60
    under the sanitizer, and a declared order the analyzer reads."""
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    c = port.DenseCrdt("n0", 8, device="cpu", wall_clock=FakeClock())
    it = c.watch().aiter()
    assert isinstance(it._lock, port_conc.OrderedLock)
    assert (it._lock.name, it._lock.rank) == ("AsyncChangeIterator._lock",
                                              60)
    it.close()
    path = os.path.join(PORT_PKG, "watch.py")
    with open(path) as fh:
        model = port_conc._build_model([(path, fh.read())])
    contract = model.by_class[(path, "AsyncChangeIterator")]
    assert contract.order == ["AsyncChangeIterator._lock"]
    assert port.watch.AsyncChangeIterator._CRDTLINT_GUARDED == \
        crdt_tpu.watch.AsyncChangeIterator._CRDTLINT_GUARDED


# ---------------------------------------------------------- host linter


@pytest.mark.parametrize("name", STATIC_FIXTURES)
def test_static_fixture_findings_match_jax(name):
    path = os.path.join(FIXTURES, name)
    jax_f = jax_lint.lint_file(path) + jax_conc.analyze_paths([path])
    port_f = port_lint.lint_file(path) + port_conc.analyze_paths([path])
    assert jax_f, name
    assert _key(port_f) == _key(jax_f)


def _rule_snippets():
    """Every source snippet the JAX package's analysis tests lint: the
    multi-line string constants of ``tests/test_analysis.py`` that
    parse as Python."""
    with open(os.path.join(REPO, "tests", "test_analysis.py")) as fh:
        tree = ast.parse(fh.read())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        n = 0
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and "\n" in node.value:
                text = textwrap.dedent(node.value)
                try:
                    ast.parse(text)
                except SyntaxError:
                    continue
                out.append(pytest.param(text, id=f"{fn.name}-{n}"))
                n += 1
    return out


@pytest.mark.parametrize("text", _rule_snippets())
def test_rule_snippet_findings_match_jax(text):
    jax_f = jax_lint.lint_source(text, "s.py") + \
        jax_conc.analyze_source(text, "s.py")
    port_f = port_lint.lint_source(text, "s.py") + \
        port_conc.analyze_source(text, "s.py")
    assert _key(port_f) == _key(jax_f)


def test_torch_spellings_of_a_pack_path_copy():
    src = textwrap.dedent("""
        def pack_rows(store, mask):
            a = store.lt.cpu()
            b = a.numpy()
            c = mask.tolist()
            d = mask.sum().item()
            return a, b, c, d

        def unpack_rows(buf):
            return buf.cpu().numpy().tolist()
    """)
    found = port_lint.lint_source(src, "p.py")
    assert [(f.line, f.message.split(" in ")[0]) for f in found] == [
        (3, ".cpu()"), (4, ".numpy()"), (5, ".tolist()"), (6, ".item()")]
    assert {f.rule for f in found} == {"pack-path-extra-copy"}
    assert jax_lint.lint_source(src, "p.py") == []


def test_shipped_port_tree_is_clean_under_both_analyzers():
    assert port_lint.lint_package(PORT_PKG) == []
    assert port_conc.analyze_package(PORT_PKG) == []
    assert jax_lint.lint_package(PORT_PKG) == []
    assert jax_conc.analyze_package(PORT_PKG) == []


def test_ingest_window_writes_commit_in_hlc_order_as_jax():
    """Inside an ingest() window put_batch / delete_batch stage their
    rows and put_slot_records drains the window before its verbatim
    write, on both packages: the same lanes, and the staged row is
    committed before the verbatim one lands."""
    out = []
    for pkg, make in ((port, lambda: port.DenseCrdt(
            "n0", 8, device="cpu", wall_clock=FakeClock())),
            (crdt_tpu, lambda: crdt_tpu.DenseCrdt(
                "n0", 8, wall_clock=FakeClock()))):
        c = make()
        with c.ingest():
            c.put_batch([1, 3], [10, 30])
            c.delete_batch([3])
            c.put_slot_records({2: pkg.Record(pkg.Hlc(5, 0, "n9"), 7,
                                              pkg.Hlc(5, 0, "n9"))})
            assert c.get(1) == 10       # drained before the verbatim write
            c.put_batch([4], [40])
        out.append(([c.get(s) for s in range(8)],
                    {int(k): (r.hlc.logical_time, r.hlc.node_id, r.value)
                     for k, r in c.record_map().items()}))
    assert out[0] == out[1]
    assert out[0][0] == [None, 10, 7, None, 40, None, None, None]


def test_stream_replay_records_one_ledger_dispatch():
    """K3's wrapper reports each replay to the dispatch ledger under
    the JAX route's name: ``dense.fanin_stream`` on the plain route
    (a CPU tensor), with the kernel route's Pallas entry registered
    beside it (the card test holds that launch)."""
    from crdt_tpu_torch.ops import dense as td
    from crdt_tpu_torch.ops.stream_kernel import fanin_stream
    led = obs_device.default_ledger()
    assert {"dense.fanin_stream", "pallas.pallas_fanin_stream"} <= set(
        led.registered_kernels())
    store = td.empty_dense_store(16, "cpu")
    cs = td.store_to_changeset(store)
    before = led.as_dict()
    fanin_stream(store, cs, 0, 0, 1, n_chunks=3)
    after = led.as_dict()
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == {"dense.fanin_stream": 1}


# ----------------------------------------------------------- law search

PORT_LAW_NAMES = [t.name for t in port_laws.builtin_targets(device="cpu")]


def test_law_target_names_contain_jax():
    jax_names = {t.name for t in jax_laws.builtin_targets()}
    assert jax_names <= set(PORT_LAW_NAMES)
    assert {"pallas.model_fanin_batch", "pallas.model_fanin_split[wide]",
            "pallas.model_fanin_split[narrow]",
            "pallas.pallas_fanin_step[exact]",
            "pallas.pallas_fanin_step[fast]",
            "pallas.ingest_scatter_tiles",
            "parallel.pallas_fanin_block"} <= set(PORT_LAW_NAMES)


@pytest.mark.parametrize("name", PORT_LAW_NAMES)
def test_builtin_law_target_holds(name):
    target, = [t for t in port_laws.builtin_targets(device="cpu")
               if t.name == name]
    obs_device.reset()
    assert port_laws.run_laws([target], seeds=(0, 1, 2)) == []
    # CPU tensors take the plain versions: no kernel launched.
    assert not any(obs_device.launches().values())


@pytest.mark.parametrize("fixture", ["merge", "counter"])
def test_broken_fixture_fails_the_laws_jax_twin_fails(fixture):
    port_mod = _load(os.path.join(REPO, "tests", f"torch_broken_{fixture}.py"))
    jax_mod = _load(os.path.join(FIXTURES, f"broken_{fixture}.py"))
    for seeds in ((0, 1, 2), (3,), (4,)):
        port_f = port_laws.run_laws(port_mod.LAW_TARGETS("cpu"), seeds)
        jax_f = jax_laws.run_laws(jax_mod.LAW_TARGETS, seeds)
        assert port_f
        assert [(f.rule, f.path, f.message) for f in port_f] == \
            [(f.rule, f.path, f.message) for f in jax_f]
    # Every law the search checks, one at a time.
    port_t, = port_mod.LAW_TARGETS("cpu")
    jax_t, = jax_mod.LAW_TARGETS
    laws = {f.rule for s in range(8)
            for f in port_laws.check_target(port_t, s)}
    assert laws == {f.rule for s in range(8)
                    for f in jax_laws.check_target(jax_t, s)}


def test_kernel_targets_catch_a_planted_lost_update(monkeypatch):
    """A K1 wrapper that drops half its rows is caught: the kernel law
    targets read what the wrapper returns."""
    from crdt_tpu_torch.ops import fanin_kernel
    real = fanin_kernel.model_fanin_batch

    def lossy(store, cs, *a, **k):
        return real(store, cs._replace(valid=cs.valid.clone().fill_(False)
                                       if cs.lt.shape[0] > 8
                                       else cs.valid), *a, **k)

    monkeypatch.setattr(fanin_kernel, "model_fanin_batch", lossy)
    target, = [t for t in port_laws.kernel_targets(device="cpu")
               if t.name == "pallas.model_fanin_batch"]
    found = port_laws.run_laws([target])
    assert [f.rule for f in found] == ["law-associativity"]


def test_dense_kernel_targets_hold_at_a_wider_shape():
    """`kernel_targets(dense=True)`, what the card runs at the main
    path's shapes, at a small odd shape through the plain versions."""
    targets = port_laws.kernel_targets(device="cpu", n=258, rows=5,
                                       chunks=3, flush_rows=33, dense=True)
    assert port_laws.run_laws(targets, seeds=(0,)) == []


# ------------------------------------------------------------- op audit

PORT_AUDIT = op_audit.builtin_targets(device="cpu")


def test_audit_target_names_equal_jaxpr_audit():
    from crdt_tpu.analysis import jaxpr_audit
    assert sorted(t.name for t in PORT_AUDIT) == \
        sorted(t.name for t in jaxpr_audit.builtin_targets())


@pytest.mark.parametrize("name", [t.name for t in PORT_AUDIT])
def test_audit_target_clean(name):
    target, = [t for t in op_audit.builtin_targets(device="cpu")
               if t.name == name]
    report = op_audit.audit_target(target)
    assert report.hazards == []
    assert report.prim_counts


def test_per_shard_audit_matches_the_golden():
    with open(os.path.join(REPO, "tests", "goldens",
                           "fanin_pallas_audit.json")) as fh:
        golden = json.load(fh)
    target, = [t for t in PORT_AUDIT
               if t.name == "parallel.pallas_fanin_block[per-shard]"]
    report = op_audit.audit_target(target)
    assert report.golden()["target"] == golden["target"]
    assert report.golden()["hazards"] == golden["hazards"]


def _planted(fn, *args, unique=False):
    return op_audit.audit_target(op_audit.AuditTarget(
        name="planted", build=lambda: (fn, args), unique_slots=unique))


def test_audit_flags_one_planted_op_per_rule():
    lane = torch.zeros(8, dtype=torch.int64)
    idx = torch.tensor([1, 1, 2])
    src = torch.tensor([5, 6, 7])

    def int_scatter(x, i, v):
        out = x.clone()
        out[i] = v
        return out

    rep = _planted(int_scatter, lane, idx, src)
    assert [h["rule"] for h in rep.hazards] == ["scatter-duplicate-order"]
    rep = _planted(int_scatter, lane, idx, src, unique=True)
    assert rep.hazards == [] and rep.assumptions == [
        "aten.index_put_ without accumulation is order-safe only under "
        "the unique-slots call contract"]
    rep = _planted(lambda x, i, v: x.clone().scatter_(0, i, v), lane, idx,
                   src)
    assert [h["rule"] for h in rep.hazards] == ["scatter-duplicate-order"]
    # A boolean mask cannot repeat an index.
    rep = _planted(lambda x: x.clone().masked_fill_(x > 0, 1)
                   .index_put_((x == 0,), torch.tensor(3)), lane)
    assert rep.hazards == []
    rep = _planted(lambda x: x.float().sum(), lane)
    assert [h["rule"] for h in rep.hazards] == ["nonassoc-float-reduce"]
    rep = _planted(lambda x: x.sum(), lane)
    assert rep.hazards == []
    rep = _planted(lambda x: x + torch.randint(0, 2, (8,)), lane)
    assert [h["rule"] for h in rep.hazards] == ["prng-in-merge"]

    def in_place(x):
        x.add_(1)

    rep = _planted(in_place, lane.clone())
    assert rep.hazards == [] and rep.assumptions == [
        "aten.add_ writes an input tensor in place: the caller must not "
        "reuse the written buffer as the old state"]


def test_audit_reports_a_failing_target():
    def boom():
        raise ValueError("no")

    reports, found = op_audit.audit_all([op_audit.AuditTarget(
        name="x", build=lambda: (boom, ()))])
    assert reports == [] and [f.rule for f in found] == ["audit-run-error"]


# ------------------------------------------------------------ sanitizer


def _np_ns(**lanes):
    return types.SimpleNamespace(**{k: np.asarray(v) for k, v in
                                    lanes.items()})


def _torch_ns(ns):
    return types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in
                                    vars(ns).items()})


def _verdict(check, *args):
    try:
        check(*args)
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


SANITIZER_CASES = {
    "sparse_dominated": ("check_dense_sparse_join", dict(
        lt=np.array([10, 20, 30], np.int64),
        node=np.array([2, 1, 3], np.int32)),
        (np.array([0, 2]), np.array([10, 5]), np.array([1, 9]))),
    "sparse_lost_update": ("check_dense_sparse_join", dict(
        lt=np.array([10, 20], np.int64), node=np.array([2, 1], np.int32)),
        (np.array([0, 1]), np.array([10, 20]), np.array([1, 4]))),
    "sparse_invalid_row_masked": ("check_dense_sparse_join", dict(
        lt=np.array([10, 20], np.int64), node=np.array([2, 1], np.int32)),
        (np.array([0, 1]), np.array([10, 99]), np.array([1, 4]),
         np.array([True, False]))),
    "sparse_lost_at_third_row": ("check_dense_sparse_join", dict(
        lt=np.array([1 << 40, 7, 9, 11], np.int64),
        node=np.array([0, 3, 3, 3], np.int32)),
        (np.array([3, 2, 0]), np.array([11, 9, (1 << 40) + 1]),
         np.array([2, 3, 0]))),
    "resurrection": ("check_dense_no_resurrection", dict(
        lt=np.array([0, 50, 500, 7], np.int64),
        occupied=np.array([False, True, True, True])),
        (np.array([0, 1, 2]), 100)),
    "fresh_write_above_floor": ("check_dense_no_resurrection", dict(
        lt=np.array([0, 150, 500], np.int64),
        occupied=np.array([False, True, True])),
        (np.array([0, 1]), 100)),
    "no_purged_slots": ("check_dense_no_resurrection", dict(
        lt=np.array([1], np.int64), occupied=np.array([True])),
        (np.array([], np.int64), 100)),
}


@pytest.mark.parametrize("case", sorted(SANITIZER_CASES))
def test_sanitizer_check_matches_jax(case):
    name, store, args = SANITIZER_CASES[case]
    jax_store = _np_ns(**store)
    want = _verdict(getattr(jax_san, name), jax_store, *args)
    got = _verdict(getattr(port_san, name), _torch_ns(jax_store),
                   *(torch.as_tensor(a) if isinstance(a, np.ndarray)
                     else a for a in args))
    assert got == want
    # numpy inputs reach the torch checks too
    assert _verdict(getattr(port_san, name), _torch_ns(jax_store),
                    *args) == want


@pytest.mark.parametrize("rows", [
    [[5, 9]], [[5, 3], [4, 4]], [[0, 0]], [[5, 5], [6, 1]]])
def test_sanitizer_dense_join_matches_jax(rows):
    store = _np_ns(lt=np.array([5, 5], np.int64),
                   node=np.array([0, 1], np.int32))
    lt = np.array(rows, np.int64)
    cs = _np_ns(lt=lt, node=np.ones_like(lt, np.int32),
                valid=lt > 0)
    want = _verdict(jax_san.check_dense_join, store, cs)
    assert _verdict(port_san.check_dense_join, _torch_ns(store),
                    _torch_ns(cs)) == want


def _script(mod, dense_kwargs, packed_ids):
    """One op script on two dense replicas of either package: local
    writes, a wide merge, a packed merge, GC at the stability head,
    then the same deltas replayed into the fence."""
    clk = FakeClock()
    a = mod.DenseCrdt("a", 64, wall_clock=clk, **dense_kwargs)
    b = mod.DenseCrdt("b", 64, wall_clock=clk, **dense_kwargs)
    a.put_batch([1, 2, 3, 40, 63], [10, 20, 30, 400, 630])
    a.delete_batch([2, 40])
    b.put_batch([3, 5], [33, 55])
    b.delete_batch([5])
    b.merge(*a.export_delta())
    packed = a.pack_since()
    b.merge_packed(*packed)
    b.gc_purge(b.canonical_time, drift_slack_ms=0)
    b.merge(*a.export_delta())
    b.merge_packed(*packed)
    a.put_batch([2], [21])
    b.merge(*a.export_delta())
    return {f: np.asarray(getattr(b.store, f)) for f in
            ("lt", "node", "val", "occupied", "tomb")}


def test_sanitized_script_ends_with_jax_lanes(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    jax_lanes = _script(crdt_tpu, {}, None)
    port_lanes = {k: v.numpy() if hasattr(v, "numpy") else v
                  for k, v in _script(port, {"device": "cpu"},
                                      None).items()}
    for f in jax_lanes:
        np.testing.assert_array_equal(port_lanes[f], jax_lanes[f])


def test_planted_drop_raises_in_both(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    for mod in (crdt_tpu, port):
        a, b = mod.MapCrdt("a"), mod.MapCrdt("b")
        b.put("k", 1)
        payload = b.record_map()
        mod.MapCrdt("c").merge(dict(payload))     # honest: passes
        monkeypatch.setattr(a, "put_records", lambda record_map: None)
        with pytest.raises(AssertionError, match="sanitizer: merge saw "
                                                 "key 'k'"):
            a.merge(payload)


def test_planted_dense_drop_raises(monkeypatch):
    """A wide merge whose join keeps the old lanes, and a columnar one
    whose join writes nothing, both trip the port's dense checks."""
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    a = port.DenseCrdt("a", 64, device="cpu", wall_clock=FakeClock())
    a.put_batch([3, 9], [30, 90])
    b = port.DenseCrdt("b", 64, device="cpu", wall_clock=FakeClock())
    real = b._dispatch_fanin

    def keep_old(cs, wall):
        join, g = real(cs, wall)
        old = b._store
        return join._replace(outs=(old.lt, old.node, old.val, old.tomb,
                                   old.occupied, *join.outs[5:])), g

    monkeypatch.setattr(b, "_dispatch_fanin", keep_old)
    with pytest.raises(port_san.LatticeViolation,
                       match="merged changeset at slot 3"):
        b.merge(*a.export_delta())
    c = port.DenseCrdt("c", 64, device="cpu", wall_clock=FakeClock())
    monkeypatch.setattr(c, "_dispatch_columns",
                        lambda slots, *rest: (torch.zeros(len(slots),
                                                          dtype=torch.bool),
                                              False, None))
    with pytest.raises(port_san.LatticeViolation,
                       match="merged delta at slot 3"):
        c.merge_packed(*a.pack_since())


def test_sanitizer_catches_a_resurrection(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    a = port.DenseCrdt("a", 16, device="cpu", wall_clock=FakeClock())
    a.put_batch([4], [1])
    a.delete_batch([4])
    stale = a.export_delta()
    b = port.DenseCrdt("b", 16, device="cpu", wall_clock=FakeClock())
    b.merge(*stale)
    assert b.gc_purge(b.canonical_time, drift_slack_ms=0) == 1
    slots, floor = b._gc_purged
    assert slots.tolist() == [4]
    b._set_fence(None)                    # plant: the fence is gone
    with pytest.raises(port_san.LatticeViolation,
                       match="purged slot 4 re-occupied"):
        b.merge(*stale)


# ---------------------------------------------------------- OrderedLock


def test_make_lock_is_plain_when_the_sanitizer_is_off(monkeypatch):
    monkeypatch.delenv("CRDT_TPU_SANITIZE", raising=False)
    from crdt_tpu_torch.utils.concurrency import make_lock
    assert isinstance(make_lock("T.l", 10), type(threading.Lock()))
    r = make_lock("T.r", 10, rlock=True)
    assert not isinstance(r, port_conc.OrderedLock)
    with r:
        with r:
            pass


def test_ordered_lock_catches_an_inversion_without_hanging(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_SANITIZE", "1")
    from crdt_tpu_torch.obs.registry import default_registry
    from crdt_tpu_torch.obs.trace import tracer
    from crdt_tpu_torch.utils.concurrency import make_lock
    a, b = make_lock("PortInvA.a", 10), make_lock("PortInvB.b", 20)
    assert isinstance(a, port_conc.OrderedLock)
    counter = default_registry().counter(
        "crdt_tpu_lock_order_violations_total")
    before = counter.value(held="PortInvB.b", acquiring="PortInvA.a")
    ring = tracer()
    was = ring.enabled
    ring.enabled = True
    try:
        def inverted():
            with b:
                with a:
                    pass

        t = threading.Thread(target=inverted, name="port-inv-bad")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with a:
            with b:
                pass
        assert counter.value(held="PortInvB.b",
                             acquiring="PortInvA.a") == before + 1
        assert counter.value(held="PortInvA.a",
                             acquiring="PortInvB.b") == 0
        ev = [e for e in ring.events()
              if e.get("kind") == "lock_order_violation"
              and e.get("acquiring") == "PortInvA.a"]
        assert ev and ev[-1]["thread"] == "port-inv-bad"
    finally:
        ring.enabled = was
    r = make_lock("PortReent.r", 30, rlock=True)
    with r:
        with r:
            pass
    assert counter.value(held="PortReent.r", acquiring="PortReent.r") == 0


# ------------------------------------------------------------------ CLI


def _main(mod, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


def test_cli_default_run_is_clean_on_cpu():
    rc, out = _main(port_cli, ["--json", "--device", "cpu", "--seeds", "0"])
    payload = json.loads(out)
    assert rc == 0 and payload["ok"] and payload["findings"] == []
    gate = payload["gate"]
    assert gate["device"] == "cpu" and gate["seeds"] == [0]
    assert gate["law_targets"] == len(PORT_LAW_NAMES)
    assert gate["audit_targets"] == len(PORT_AUDIT)
    assert gate["law_launches"] == {} == gate["audit_launches"]
    golden = {r["target"]: r for r in payload["jaxpr_reports"]}
    assert golden["parallel.pallas_fanin_block[per-shard]"]["hazards"] == []


@pytest.mark.parametrize("argv", [
    ["--lint", "tests/fixtures/racy_gossip.py"],
    ["--lint", "tests/fixtures/deadlock_cycle.py"],
    ["--lint", "tests/fixtures/blocking_hold.py"],
    ["--lint", "tests/fixtures/unfenced_purge.py"],
    ["--lint", "tests/fixtures"],
])
def test_cli_json_matches_jax_on_static_fixtures(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    rc_j, out_j = _main(jax_cli, ["--json", *argv])
    rc_p, out_p = _main(port_cli, ["--json", *argv, "--device", "cpu"])
    assert rc_p == rc_j == 1
    assert json.loads(out_p) == json.loads(out_j)
    rc_j, out_j = _main(jax_cli, argv)
    rc_p, out_p = _main(port_cli, [*argv, "--device", "cpu"])
    assert out_p == out_j


@pytest.mark.parametrize("fixture", ["torch_broken_merge.py",
                                     "torch_broken_counter.py"])
def test_cli_fails_on_a_broken_law_fixture(fixture, monkeypatch):
    monkeypatch.chdir(REPO)
    rc, out = _main(port_cli, ["--device", "cpu", "--law-fixture",
                               f"tests/{fixture}"])
    assert rc == 1
    assert "violated by broken-" in out and "violating input" in out


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from crdt_tpu_torch.obs import cli as obs_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--lint", "tests/fixtures/racy_gossip.py"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        obs_cli.main(["--trace", "x.jsonl"], out=io.StringIO())


def test_completeness_gates_fail_when_a_name_is_dropped():
    from crdt_tpu_torch.semantics import all_semantics
    specs = all_semantics()
    assert port_cli._registry_completeness(specs) == []
    bad = [types.SimpleNamespace(name=s.name, tag=s.tag, law_target=None,
                                 audit_target=s.audit_target)
           for s in specs[:1]]
    assert [f.rule for f in port_cli._registry_completeness(bad)] == [
        "semantics-missing-law-target"]
    bad[0].law_target, bad[0].audit_target = specs[0].law_target, None
    assert [f.rule for f in port_cli._registry_completeness(bad)] == [
        "semantics-missing-audit-target"]
    names = {t.name for t in PORT_AUDIT}
    for gate, required, rule in (
            (port_cli._fastpath_completeness, port_cli._FASTPATH_REQUIRED,
             "fastpath-kernel-unregistered"),
            (port_cli._merkle_completeness, port_cli._MERKLE_REQUIRED,
             "merkle-kernel-unregistered")):
        assert gate(names) == []
        for req in required:
            assert [f.rule for f in gate(names - {req})] == [rule]
    assert port_cli._ledger_completeness() == []
    registered = set(obs_device.default_ledger().registered_kernels())
    counters = set(obs_device.KERNELS) | set(obs_device.OPS)
    for req in port_cli._LEDGER_REQUIRED:
        assert [f.rule for f in port_cli._ledger_completeness(
            registered - {req}, counters)] == [
            "dispatch-ledger-unregistered"]
    for req in port_cli._COUNTERS_REQUIRED:
        assert [f.rule for f in port_cli._ledger_completeness(
            registered, counters - {req})] == ["launch-counter-missing"]
    law = set(PORT_LAW_NAMES)
    assert port_cli._gc_completeness(names, law) == []
    for req in port_cli._GC_REQUIRED:
        assert [f.rule for f in port_cli._gc_completeness(
            names - {req}, law)] == ["gc-kernel-unaudited"]
        assert [f.rule for f in port_cli._gc_completeness(
            names, law - {req})] == ["gc-kernel-unlawed"]


def test_export_lists_equal_jax():
    import crdt_tpu.analysis as ja
    import crdt_tpu_torch.analysis as pa
    assert sorted(pa.__all__) == sorted(ja.__all__)
    for name in pa.__all__:
        assert getattr(pa, name) is not None
