"""The port's C HLC wire codec (`crdt_tpu_torch.native`) against the
JAX package's (`crdt_tpu.native`) and against the port's own
pure-Python branch, on `tests/test_native_codec.py`'s inputs:

- the extension loads (this container ships a C compiler, so a silent
  fallback would hide a broken build), is built under
  ``crdt_tpu_torch/build/`` and nowhere in the package's source
  directories, from a verbatim copy of the JAX package's source;
- the batch HLC parse / format, the one-pass wire scan and the node
  ordinal lookup give the JAX codec's outputs;
- the port's `crdt_json.encode` / `decode` / `decode_columns`,
  `NodeTable.encode` and `DenseCrdt`'s codec paths (the lane-direct
  `to_json`, the dense wire scan of `merge_json`, the record columns of
  `merge_records`) give the same results with the codec and without it
  (``native.load`` patched to None), and the JAX package's.
"""

import math
import pathlib
import random

import numpy as np
import pytest

import crdt_tpu
from crdt_tpu import crdt_json as jax_json
from crdt_tpu import native as jax_native
from crdt_tpu.ops import packing as jax_packing
from crdt_tpu.testing import FakeClock
import crdt_tpu_torch as port
from crdt_tpu_torch import crdt_json as port_json
from crdt_tpu_torch import native as port_native
from crdt_tpu_torch.ops import packing as port_packing

from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
H = "2026-01-01T00:00:01.123Z-004D-nodeid"


@pytest.fixture(scope="module")
def codecs():
    mod = port_native.load()
    assert mod is not None, "the port's native codec failed to build/load"
    ref = jax_native.load()
    assert ref is not None
    return mod, ref


def random_hlcs(n, seed=0):
    rng = random.Random(seed)
    nodes = ["abc", "node-x", "a-b-c", "x" * 10, "n0", "ünïcode"]
    return [port.Hlc(rng.randrange(0, 1 << 44), rng.randrange(0, 1 << 16),
                     rng.choice(nodes)) for _ in range(n)]


def test_built_under_build_dir_from_the_same_source(codecs):
    mod, _ = codecs
    so = pathlib.Path(mod.__file__).resolve()
    assert so == port_native.library_path()
    assert so.parent == ROOT / "crdt_tpu_torch" / "build"
    stray = [p for p in (ROOT / "crdt_tpu_torch").rglob("*.so")
             if "build" not in p.relative_to(ROOT / "crdt_tpu_torch").parts]
    assert stray == []
    assert (ROOT / "crdt_tpu_torch/native/hlccodec.c").read_bytes() == \
        (ROOT / "crdt_tpu/native/hlccodec.c").read_bytes()


def test_no_native_env_falls_back(monkeypatch):
    monkeypatch.setenv("CRDT_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(port_native, "_tried", False)
    monkeypatch.setattr(port_native, "_mod", None)
    assert port_native.load() is None


@pytest.mark.parametrize("seed", [0, 1])
def test_hlc_batches_match_jax(codecs, seed):
    mod, ref = codecs
    hlcs = random_hlcs(300, seed)
    strings = [str(h) for h in hlcs]
    bad = ["", "garbage", "2026-07-29 12:00:00.000Z-0000-n",
           "2026-07-29T12:00:00Z-0000-n", "2026-02-30T00:00:00.000Z-0000-n",
           "2026-07-29T12:00:00.000Z-00-n"]
    assert mod.parse_hlc_batch(strings + bad) == \
        ref.parse_hlc_batch(strings + bad)
    args = ([h.millis for h in hlcs] + [-1, 400_000_000_000_000],
            [h.counter for h in hlcs] + [0, 0],
            [str(h.node_id) for h in hlcs] + ["n", "n"])
    out = mod.format_hlc_batch(*args)
    assert out == ref.format_hlc_batch(*args)
    assert out[:-2] == strings and out[-1] is None


PAYLOADS = {
    "values": ('{"int":{"hlc":"%s","value":42},'
               '"neg":{"hlc":"%s","value":-7},'
               '"float":{"hlc":"%s","value":3.14e2},'
               '"esc":{"hlc":"%s","value":"a\\"b\\\\c\\n\\u00e9"},'
               '"emoji":{"hlc":"%s","value":"\\ud83d\\ude00"},'
               '"null":{"hlc":"%s","value":null},'
               '"miss":{"hlc":"%s"},'
               '"obj":{"hlc":"%s","value":{"a":[1,{"b":null}]}}}'
               % ((H,) * 8)),
    "order_and_duplicates": (
        '{"swap":{"value":1,"hlc":"%s"},'
        '"extra":{"hlc":"%s","value":2,"x":[1,2],"y":"z"},'
        '"dup":{"hlc":"%s","value":3},'
        '"dup":{"hlc":"2026-01-01T00:00:02.000Z-0000-nb","value":4}}'
        % (H, H, H)),
    "escaped_key_and_node": (
        '{"k\\u00e9y\\t1":{"hlc":"2026-01-01T00:00:01.123Z-004D-'
        'n\\u00e9\\\\x","value":1}}'),
    "non_canonical": ('{"a":{"hlc":"2026-01-01 00:00:01.123Z-004D-n",'
                      '"value":1}}'),
    "nan_infinity": (' {\n "a" :\t{ "hlc" : "%s" , "value" : Infinity },'
                     '"c":{"hlc":"%s","value":NaN} } ' % (H, H)),
    "lone_surrogate": '{"a":{"hlc":"%s","value":"\\ud800"}}' % H,
    "year_zero": ('{"a":{"hlc":"0000-01-01T00:00:01.123Z-004D-n",'
                  '"value":1}}'),
    "many": "{%s}" % ",".join('"%d":{"hlc":"%s","value":%d}' % (i, H, i)
                              for i in range(100)),
}


def same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def columns_equal(x, y):
    assert x[0] == y[0]
    np.testing.assert_array_equal(x[1], y[1])
    assert list(x[2]) == list(y[2])
    assert len(x[3]) == len(y[3])
    assert all(same(a, b) for a, b in zip(x[3], y[3]))


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_wire_scan_and_decode_columns_match(codecs, monkeypatch, name):
    mod, ref = codecs
    payload = PAYLOADS[name]
    got, want = mod.parse_wire(payload), ref.parse_wire(payload)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] == want[0] and bytes(got[1]) == bytes(want[1])
        assert got[2] == want[2] and got[4] == want[4]
    fast = port_json.decode_columns(payload)
    columns_equal(fast, jax_json.decode_columns(payload))
    monkeypatch.setattr(port_native, "load", lambda: None)
    columns_equal(fast, port_json.decode_columns(payload))


@pytest.mark.parametrize("payload", [
    '{"a":{"hlc":"%s","value":01}}' % H, '{"a":{"hlc":"%s","value":1}' % H,
    '{"a":{"hlc":"%s","value":tru}}' % H, '[1,2]', '42', '',
    '{"a":{"value":1}}'])
def test_malformed_payloads_raise_identically(monkeypatch, payload):
    with pytest.raises(Exception) as want:
        jax_json.decode_columns(payload)
    with pytest.raises(Exception) as fast:
        port_json.decode_columns(payload)
    monkeypatch.setattr(port_native, "load", lambda: None)
    with pytest.raises(Exception) as slow:
        port_json.decode_columns(payload)
    assert type(fast.value) is type(slow.value) is type(want.value)


def test_encode_and_decode_match(monkeypatch):
    def source(pkg):
        src = pkg.MapCrdt("remote", wall_clock=FakeClock())
        src.put_all({f"k{i}": {"v": i, "s": "x" * (i % 23)}
                     for i in range(200)})
        src.put_all({"k5": "plain", "k6": 2.5, "k8": None})
        src.delete("k3")
        return src
    native = source(port).to_json()
    assert native == source(crdt_tpu).to_json()
    canonical = port.Hlc(1, 0, "local")
    fast = port_json.decode(native, canonical, now_millis=5)
    monkeypatch.setattr(port_native, "load", lambda: None)
    assert source(port).to_json() == native
    assert port_json.decode(native, canonical, now_millis=5) == fast
    ref = jax_json.decode(native, crdt_tpu.Hlc(1, 0, "local"),
                          now_millis=5)
    assert {k: (str(r.hlc), r.value, str(r.modified))
            for k, r in fast.items()} == \
        {k: (str(r.hlc), r.value, str(r.modified)) for k, r in ref.items()}


def test_node_table_encode_matches(codecs, monkeypatch):
    ids = [f"n{i}" for i in range(0, 500, 7)]
    rng = np.random.default_rng(0)
    query = [ids[i] for i in rng.integers(0, len(ids), 2000)]
    want = jax_packing.NodeTable(ids).encode(query)
    fast = port_packing.NodeTable(ids).encode(query)
    np.testing.assert_array_equal(fast, want)
    with pytest.raises(KeyError):
        port_packing.NodeTable(ids).encode(["missing"])
    monkeypatch.setattr(port_native, "load", lambda: None)
    np.testing.assert_array_equal(
        port_packing.NodeTable(ids).encode(tuple(query)), want)


def dense_pair(rng):
    """A JAX and a port `DenseCrdt` given the same writes."""
    out = []
    for pkg, kw in ((crdt_tpu, {}), (port, {"device": "cpu"})):
        c = pkg.DenseCrdt("d", 700, wall_clock=FakeClock(), **kw)
        c.put_batch(np.arange(3, 700, 3), np.arange(3, 700, 3) * 11)
        c.delete_batch([9, 30])
        out.append(c)
    return out


def store_equal(a, b):
    for f in a.store._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a.store, f)),
                                      np.asarray(getattr(b.store, f)), f)
    assert str(a.canonical_time) == str(b.canonical_time)


@pytest.mark.parametrize("payload", [
    "peer", "duplicates", "empty", "decoded"])
def test_dense_json_fast_paths_match(codecs, monkeypatch, payload):
    """`DenseCrdt.to_json` / `merge_json` / `merge_records` through the C
    codec (the lane-direct export, the dense wire scan, the record
    columns) against the generic path and the JAX package's."""
    src = port.DenseCrdt("peer", 700, device="cpu",
                         wall_clock=FakeClock(start=1_700_000_000_500))
    src.put_batch(np.arange(1, 700, 5), -np.arange(1, 700, 5))
    src.delete_batch([6, 11])
    wire = {"peer": src.to_json(), "empty": "{}",
            "duplicates": '{"4":{"hlc":"%s","value":1},'
                          '"04":{"hlc":"%s","value":2}}'
                          % ((str(port.Hlc(1_700_000_000_600, 0, "q")),)
                             * 2),
            "decoded": src.to_json()}[payload]
    jax_c, port_c = dense_pair(np.random.default_rng(0))
    assert port_c.to_json() == jax_c.to_json()
    if payload == "decoded":
        recs = port_json.decode(wire, port.Hlc(0, 0, "x"), now_millis=1)
        port_c.merge_records(recs)
        jax_c.merge_records(jax_json.decode(wire, crdt_tpu.Hlc(0, 0, "x"),
                                            now_millis=1))
    else:
        port_c.merge_json(wire)
        jax_c.merge_json(wire)
    store_equal(jax_c, port_c)
    fast = port_c.to_json()
    assert fast == jax_c.to_json()
    _, slow_c = dense_pair(np.random.default_rng(0))
    monkeypatch.setattr(port_native, "load", lambda: None)
    if payload == "decoded":
        slow_c.merge_records(recs)
    else:
        slow_c.merge_json(wire)
    store_equal(port_c, slow_c)
    assert slow_c.to_json() == fast
