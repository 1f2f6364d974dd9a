"""The port's kernel probes (`crdt_tpu_torch.ops.probe`, P1 and P2) and
benchmark rows (`crdt_tpu_torch.bench`) held against the JAX package
on the same numpy inputs.

- Each probe's plain version against the JAX kernel body of
  ``benchmarks/probe_kernel.py`` run through ``pl.pallas_call(...,
  interpret=True)`` with the probe's own ``BlockSpec``s and aliases:
  all ten outputs bit for bit (integer lanes: tolerance 0), on split
  lanes with row ties, store ties, invalid and malformed sentinels
  (``hi == NEG_HI``, ``lo != 0``), ``lo`` carries into ``hi`` under the
  chunk offset, sums that wrap int32 (``hi``) and int16 (``node``), and
  a non-empty store whose stale records beat the early chunks only.
- `split_store` / `join_store` against the JAX pair.
- `bench.data`: dtypes and shares of the generated changesets, and the
  result line's keys.
- `bench.fanin.bench`, `bench.fanin.bench_distinct` and
  `bench.probe_kernel.run_batch_copy` count merges as the JAX functions
  do, given the same lanes.

On the CPU the wrappers take the plain versions; the CUDA kernels are
held against them on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import re
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench as jax_bench
from benchmarks import probe_kernel as jpk
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops import pallas_merge as jp
from crdt_tpu_torch.bench import data as tdata
from crdt_tpu_torch.bench import fanin as tfanin
from crdt_tpu_torch.bench import probe_kernel as tpk
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import probe
from crdt_tpu_torch.ops import split as ts

import torch_probe_cases as pc
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 8192                       # two (8, 512) tiles of the TPU grid
NEG_HI = ts.NEG_HI
I16_NEG = ts.I16_NEG
BASE = 1_700_000_000_000 << 16
CANON = BASE + (500 << 16)
NEWC = BASE + (0x9ABC << 16) + 0xFFFF   # newc_lo has its top bit set
SCALARS = probe.probe_scalars(CANON, 3, NEWC)

STORE_NP = dict(hi=np.int32, lo=np.uint32, node=np.int32, val_hi=np.int32,
                val_lo=np.uint32, tomb=np.int32, mod_hi=np.int32,
                mod_lo=np.uint32, mod_node=np.int32)


def split_lanes(rng, r, n=N):
    """Numpy split lanes that reach every rule the probes have: keys
    near one another (ties at every level), planted row ties, invalid
    and malformed sentinels, ``lo`` words that carry under the chunk
    offset, ``hi`` words across the whole int32 range (the sums wrap),
    node words near int16's top (the sums wrap) and int8 tombs of both
    signs."""
    hi = ((BASE >> 32) + rng.integers(0, 3, (r, n))).astype(np.int32)
    hi[:, ::3] = rng.integers(-2 ** 31, 2 ** 31, (r, (n + 2) // 3))
    hi[:, 5::97] = 2 ** 31 - 1                   # the carry wraps hi
    lo = rng.choice(np.array([0, 1 << 16, 0xFFFF0000, 0xFFFFFFFF],
                             np.uint32), (r, n))
    lo[:, 1::3] = rng.integers(0, 2 ** 32, (r, (n + 1) // 3))
    node = rng.integers(1, 9, (r, n)).astype(np.int16)
    node[:, ::4] = rng.integers(30_000, 2 ** 15, (r, n // 4))
    # Row 1 repeats row 0's key every 7th slot (row 0 keeps it).
    for a in (hi, lo, node):
        a[1, ::7] = a[0, ::7]
    invalid = rng.random((r, n)) < 0.2
    hi[invalid], lo[invalid], node[invalid] = NEG_HI, 0, I16_NEG
    bad = np.zeros((r, n), bool)
    bad[r - 1, 11::41] = True                     # malformed sentinels
    hi[bad], lo[bad] = NEG_HI, 9
    return ts.SplitChangeset(
        hi=hi, lo=lo, node=node,
        val_hi=rng.integers(-2 ** 31, 2 ** 31, (r, n)).astype(np.int32),
        val_lo=rng.integers(0, 2 ** 32, (r, n)).astype(np.uint32),
        tomb=rng.integers(-128, 128, (r, n)).astype(np.int8))


def narrow_lanes(cs):
    return ts.NarrowSplitChangeset(hi=cs.hi, lo=cs.lo, node=cs.node,
                                   val=cs.val_hi, tomb=cs.tomb)


def store_lanes(rng, cs, n=N):
    """A non-empty split store: empty slots, slots holding row 0's key
    (the store keeps exact ties), and stale records (node 0, every 10th
    slot from 2) just over 1 ms above every row's key, which beat
    chunks 0 and 1 of a replay and lose to chunk 2."""
    st = {f: rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n,
                          dtype=np.int64).astype(dt)
          for f, dt in STORE_NP.items()}
    empty = rng.random(n) < 0.3
    st["hi"][empty], st["lo"][empty] = NEG_HI, 0
    st["hi"][::10], st["lo"][::10] = cs.hi[0, ::10], cs.lo[0, ::10]
    st["node"][::10] = cs.node[0, ::10]
    key = (cs.hi.astype(np.int64) << 32) | cs.lo.astype(np.int64)
    stale = key.max(0) + (1 << 16) + 5
    pick = np.zeros(n, bool)
    pick[2::10] = True
    pick &= (cs.hi != NEG_HI).all(0) & (key.max(0) < 2 ** 62)
    st["hi"][pick] = (stale[pick] >> 32).astype(np.int32)
    st["lo"][pick] = (stale[pick] & 0xFFFFFFFF).astype(np.uint32)
    st["node"][pick] = 0
    return ts.SplitStore(**st)


def stale_slots(st):
    pick = np.zeros(len(st.hi), bool)
    pick[2::10] = st.node[2::10] == 0
    return pick


def to_torch(lanes):
    return type(lanes)(*(torch.from_numpy(np.array(x)) for x in lanes))


# --- the JAX bodies in interpret mode, as the probe builds their calls --


def jax_call(kernel, store, cs, *, n_chunks=None, chunk_rows=None,
             scalars=SCALARS):
    """``pl.pallas_call`` of a probe body with ``_variant_call``'s
    (``n_chunks=None``), ``_stream_call``'s or ``run_batch_copy``'s
    (``chunk_rows``) BlockSpecs, grid and aliases, in interpret mode."""
    i32 = jnp.int32
    r, n = cs.hi.shape
    rows = n // jp._LANE
    if n_chunks is None and chunk_rows is None:
        grid = (rows // jp._SB,)
        cs_map = lambda i: (i32(0), i32(i), i32(0))
        st_map = lambda i: (i32(i), i32(0))
        sc_map = lambda i: (i32(0),)
        block_rows = r
    else:
        grid = (rows // jp._SB, n_chunks or r // chunk_rows)
        cs_map = ((lambda i, c: (i32(0), i32(i), i32(0))) if n_chunks
                  else (lambda i, c: (c, i32(i), i32(0))))
        st_map = lambda i, c: (i32(i), i32(0))
        sc_map = lambda i, c: (i32(0),)
        block_rows = r if n_chunks else chunk_rows
        kernel = partial(kernel, n_chunks if n_chunks
                         else isinstance(cs, ts.NarrowSplitChangeset))
    cs_spec = pl.BlockSpec((block_rows, jp._SB, jp._LANE), cs_map,
                           memory_space=pltpu.VMEM)
    st_spec = pl.BlockSpec((jp._SB, jp._LANE), st_map,
                           memory_space=pltpu.VMEM)
    st2d = [jnp.asarray(x).reshape(rows, jp._LANE) for x in store]
    cs3d = [jnp.asarray(x).reshape(r, rows, jp._LANE) for x in cs]
    n_cs = len(cs3d)
    outs = pl.pallas_call(
        kernel, grid=grid,
        in_specs=([pl.BlockSpec((7,), sc_map, memory_space=pltpu.SMEM)]
                  + [cs_spec] * n_cs + [st_spec] * 9),
        out_specs=tuple([st_spec] * 10),
        out_shape=tuple([jax.ShapeDtypeStruct((rows, jp._LANE), x.dtype)
                         for x in st2d]
                        + [jax.ShapeDtypeStruct((rows, jp._LANE),
                                                jnp.int32)]),
        input_output_aliases={1 + n_cs + j: j for j in range(9)},
        interpret=True,
    )(jnp.asarray(scalars, jnp.int32), *cs3d, *st2d)
    return [np.asarray(o).reshape(n) for o in outs]


def assert_probe_equal(jouts, tout, where):
    tstore, twin = tout
    names = list(ts.SplitStore._fields) + ["win"]
    for name, j, t in zip(names, jouts, list(tstore) + [twin]):
        assert t.dtype == (torch.int32 if j.dtype == np.int32
                           else torch.uint32), (where, name, t.dtype)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{where} "
                                                           f"{name}")


P1_ROWS = 8
P2_ROWS = 32


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_join_matches_jax_body(seed):
    rng = np.random.default_rng(seed)
    cs = split_lanes(rng, P1_ROWS)
    st = store_lanes(rng, cs)
    jouts = jax_call(jpk._join_only_kernel, st, cs)
    tout = probe.probe_join(to_torch(st), to_torch(cs), SCALARS)
    assert_probe_equal(jouts, tout, "P1a")
    win = tout[1].numpy().astype(bool)
    assert win.any() and not win.all()
    assert not win[stale_slots(st)].any()       # the stale store wins


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_copy_matches_jax_body(seed):
    rng = np.random.default_rng(10 + seed)
    cs = split_lanes(rng, P1_ROWS)
    st = store_lanes(rng, cs)
    jouts = jax_call(jpk._copy_kernel, st, cs)
    tout = probe.probe_copy(to_torch(st), to_torch(cs), SCALARS)
    assert_probe_equal(jouts, tout, "P1b")
    wide = cs.hi.astype(np.int64).sum(0) + st.hi
    assert ((wide < -2 ** 31) | (wide >= 2 ** 31)).any()   # hi wrapped


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_stream_noguard_matches_jax_body(seed):
    rng = np.random.default_rng(20 + seed)
    cs = split_lanes(rng, P1_ROWS)
    st = store_lanes(rng, cs)
    jouts = jax_call(jpk._stream_noguard_kernel, st, cs, n_chunks=3)
    tout = probe.probe_stream_noguard(to_torch(st), to_torch(cs), SCALARS,
                                      n_chunks=3)
    assert_probe_equal(jouts, tout, "P1c")
    # A stale store record outlives chunks 0 and 1 and falls to chunk 2,
    # which stamps its mod lanes.
    stale = stale_slots(st)
    assert stale.sum() > 50
    assert (tout[1].numpy()[stale] == 1).all()
    assert (tout[0].mod_hi.numpy()[stale] == SCALARS[5]).all()
    two = probe.probe_stream_noguard(to_torch(st), to_torch(cs), SCALARS,
                                     n_chunks=2)
    assert (two[1].numpy()[stale] == 0).all()


@pytest.mark.parametrize("n_chunks", pc.CHUNKS)
@pytest.mark.parametrize("r", [3, 8, 13])
def test_probe_stream_noguard_closed_form_matches_chunk_walk_and_pallas(
        r, n_chunks):
    """`probe_stream_noguard_closed_reference` (what
    ``csrc/probe_stream_noguard.cu`` computes) against the chunk walk on
    the planted cases of `torch_probe_cases`, and against the JAX body in
    interpret mode at up to 3 chunks: all ten outputs, tolerance 0."""
    st, cs = pc.probe_case_lanes(r, n_chunks)
    args = (to_torch(st), to_torch(cs), pc.SCALARS, n_chunks)
    closed = probe.probe_stream_noguard_closed_reference(*args)
    where = f"P1c closed r={r} n_chunks={n_chunks}"
    walk = probe.probe_stream_noguard_reference(*args)
    assert_probe_equal([x.numpy() for x in list(walk[0]) + [walk[1]]],
                       closed, f"{where} vs walk")
    if n_chunks <= 5:
        jouts = jax_call(jpk._stream_noguard_kernel, st, cs,
                         n_chunks=n_chunks, scalars=pc.SCALARS)
        assert_probe_equal(jouts, closed, f"{where} vs pallas")
    out, win = closed
    for col, (won_any, won_last, row) in pc.expected(n_chunks).items():
        at = f"{where} column {col}"
        assert bool(win[col]) == won_any, at
        assert (int(out.mod_hi[col]) == pc.SCALARS[5]) == won_last, at
        if row >= 0:
            assert int(out.val_hi[col]) == int(cs.val_hi[row, col]), at
        else:
            assert int(out.val_hi[col]) == int(st.val_hi[col]), at
    # The random columns reach both forms: a wrapping column (walked)
    # and columns where a static entry or the last chunk wins.
    moving = (cs.hi != ts.NEG_HI) & (n_chunks > 1)
    off = (n_chunks - 1) << 16
    wraps = (moving & (cs.hi == pc.I32_MAX)
             & (cs.lo.astype(np.int64) + off > 0xFFFFFFFF)).any(0)
    assert wraps.any() == (n_chunks > 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["wide", "narrow"])
def test_probe_copy_batch_matches_jax_body(seed, form):
    rng = np.random.default_rng(30 + seed)
    cs = split_lanes(rng, P2_ROWS)
    st = store_lanes(rng, cs)
    if form == "narrow":
        cs = narrow_lanes(cs)
    jouts = jax_call(jpk._copy_batch_kernel, st, cs, chunk_rows=16)
    tout = probe.probe_copy_batch(to_torch(st), to_torch(cs), 16)
    assert_probe_equal(jouts, tout, f"P2 {form}")
    groups = cs.node.astype(np.int64).reshape(2, 16, N).sum(1)
    assert ((groups < -2 ** 15) | (groups >= 2 ** 15)).any()  # int16 wrap
    # Grouping matters: one group of 32 rows gives another node lane.
    whole = probe.probe_copy_batch(to_torch(st), to_torch(cs), 32)
    assert not torch.equal(whole[0].node, tout[0].node)


def test_probe_wrappers_refuse_bad_shapes_and_count_nothing_on_cpu():
    rng = np.random.default_rng(5)
    cs = to_torch(split_lanes(rng, 4, 256))
    st = to_torch(store_lanes(rng, split_lanes(rng, 4, 256), 256))
    obs_device.reset()
    for fn in (probe.probe_join, probe.probe_copy):
        fn(st, cs, SCALARS)
    probe.probe_stream_noguard(st, cs, SCALARS, 2)
    with pytest.raises(ValueError, match="whole groups"):
        probe.probe_copy_batch(st, cs, 16)
    with pytest.raises(ValueError, match="n_chunks"):
        probe.probe_stream_noguard(st, cs, SCALARS, 0)
    assert obs_device.launches() == dict.fromkeys(obs_device.KERNELS, 0)
    with pytest.raises(ValueError, match="at least one row"):
        probe._check("probe_copy", st, type(cs)(*(x[:0] for x in cs)))
    with pytest.raises(ValueError, match="lane lo"):
        probe._check("probe_copy", st, cs._replace(lo=cs.lo.long()))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_store_round_trip_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    n = 300
    occ = rng.random(n) < 0.6
    lanes = dict(lt=np.where(occ, BASE + rng.integers(0, 1 << 40, n), 0),
                 node=rng.integers(0, 9, n).astype(np.int32),
                 val=rng.integers(-2 ** 63, 2 ** 63 - 1, n),
                 mod_lt=rng.integers(-2 ** 63, 2 ** 63 - 1, n),
                 mod_node=rng.integers(0, 9, n).astype(np.int32),
                 occupied=occ, tomb=rng.random(n) < 0.3)
    jstore = jd.DenseStore(**{k: jnp.asarray(v) for k, v in lanes.items()})
    js = jp.split_store(jstore)
    tst = ts.split_store(td.store_from_numpy(lanes))
    for f in ts.SplitStore._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
        assert getattr(tst, f).dtype == ts.SPLIT_STORE_DTYPES[f]
    jback, tback = jp.join_store(js), ts.join_store(tst)
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(getattr(tback, f).numpy(),
                                      np.asarray(getattr(jback, f)),
                                      err_msg=f)


# --- bench.data ---------------------------------------------------------


@pytest.mark.parametrize("maker,kw,tomb,spread", [
    ("make_changeset", {}, 0.3, 1000),
    ("make_changeset", {"tomb_ratio": 0.5}, 0.5, 1000),
    ("make_changeset", {"millis_spread": 1, "counter_spread": 2}, 0.3, 1),
    ("make_changeset_fast", {}, 77 / 256, 1000)])
def test_make_changeset_shape_and_shares(maker, kw, tomb, spread):
    """Dtypes as the wide changeset's; fill, tombstone and writer shares
    within 0.01 of their targets at 40,960 entries (5 standard
    deviations); millis and counters inside their spreads."""
    cs = getattr(tdata, maker)(5, 8192, seed=3, device="cpu", **kw)
    for f, dt in td.CHANGESET_DTYPES.items():
        assert getattr(cs, f).dtype == dt and getattr(cs, f).shape == (
            5, 8192), f
    fill = 0.8 if maker == "make_changeset" else 205 / 256
    assert abs(cs.valid.float().mean().item() - fill) < 0.01
    assert abs(cs.tomb.float().mean().item() - tomb) < 0.01
    counts = torch.bincount(cs.node.reshape(-1).long(), minlength=9)
    assert counts[0] == 0 and ((counts[1:] / cs.node.numel() - 1 / 8)
                               .abs() < 0.01).all()
    millis = (cs.lt >> 16) - tdata._MILLIS
    assert millis.min() >= 0 and millis.max() < spread
    assert (cs.lt & 0xFFFF).max() < (kw.get("counter_spread", 4))
    assert torch.equal(cs.val, cs.lt)
    again = getattr(tdata, maker)(5, 8192, seed=3, device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(cs, again))


def test_make_changeset_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.make_changeset(2, 16, seed=0)


def test_result_dict_matches_jax():
    for args in (("m", 123_456, 0.5), ("m", 7, 3.0, "cuda-split", "H100")):
        assert tdata.result_dict(*args) == jax_bench.result_dict(*args)
    assert tdata.CONFIGS == jax_bench.CONFIGS
    assert tdata._MILLIS == jax_bench._MILLIS


# --- the rows count merges as the JAX functions do ----------------------


def wide_np(seed, rows, n):
    rng = np.random.default_rng(seed)
    lt = BASE + rng.integers(0, 1 << 26, (rows, n))
    return dict(lt=lt, node=rng.integers(1, 9, (rows, n)).astype(np.int32),
                val=lt, tomb=rng.random((rows, n)) < 0.3,
                valid=rng.random((rows, n)) < 0.8)


def feed(monkeypatch, module, lanes, to):
    """Make ``module.make_changeset`` hand out ``lanes`` (``to`` builds
    the package's changeset from them)."""
    monkeypatch.setattr(module, "make_changeset",
                        lambda rc, n, seed=0, **kw: to(lanes))


def jax_cs(lanes):
    return jd.DenseChangeset(**{k: jnp.asarray(v) for k, v in lanes.items()})


def torch_cs(lanes):
    return td.DenseChangeset(**{k: torch.tensor(v) for k, v in lanes.items()})


def jax_merges(monkeypatch):
    """Patch ``bench.result_dict`` to record the merges it is given."""
    seen = []
    real = jax_bench.result_dict
    monkeypatch.setattr(jax_bench, "result_dict",
                        lambda metric, merges, secs, **kw: seen.append(
                            merges) or real(metric, merges, secs, **kw))
    return seen


@pytest.mark.parametrize("value_width", [64, 32])
def test_bench_distinct_counts_merges_as_jax(monkeypatch, value_width):
    lanes = wide_np(7, 32, N)
    feed(monkeypatch, jax_bench, lanes, jax_cs)
    feed(monkeypatch, tfanin, lanes, torch_cs)
    seen = jax_merges(monkeypatch)
    jout = jax_bench.bench_distinct(N, 32, loops=2, interpret=True,
                                    value_width=value_width)
    tout = tfanin.bench_distinct(N, 32, loops=2, value_width=value_width,
                                 device="cpu")
    assert tout["merges"] == seen[0] == 2 * int(lanes["valid"].sum())
    assert tout["metric"] == jout["metric"] and tout["loops"] == 2
    assert tout["platform"] == "cpu" and tout["path"] == "plain"


def test_bench_stream_counts_merges_as_jax(monkeypatch):
    lanes = wide_np(8, 8, N)
    feed(monkeypatch, jax_bench, lanes, jax_cs)
    feed(monkeypatch, tfanin, lanes, torch_cs)
    seen = jax_merges(monkeypatch)
    jout = jax_bench.bench(N, 24, 8, repeats=2, path="xla")
    tout = tfanin.bench(N, 24, 8, repeats=2, device="cpu")
    assert tout["merges"] == seen[0] == 2 * 3 * int(lanes["valid"].sum())
    assert tout["metric"] == jout["metric"] and tout["repeats"] == 2


class StepTime:
    """``time.perf_counter`` stand-in: 0 then 1e-9 s, over and over, so
    the probe's printed rate is its merge count."""

    def __init__(self):
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return 0.0 if self.calls % 2 else 1e-9


@pytest.mark.parametrize("value_width", [64, 32])
def test_run_batch_copy_counts_merges_as_jax(monkeypatch, capsys,
                                             value_width):
    lanes = wide_np(9, 32, N)
    feed(monkeypatch, jpk, lanes, jax_cs)
    feed(monkeypatch, tpk, lanes, torch_cs)
    monkeypatch.setattr(jpk, "time", StepTime())
    monkeypatch.setattr(jpk.pl, "pallas_call",
                        partial(pl.pallas_call, interpret=True))
    jpk.run_batch_copy(N, 32, loops=2, value_width=value_width, repeats=1)
    jline = capsys.readouterr().out
    tout = tpk.run_batch_copy(N, 32, loops=2, value_width=value_width,
                              repeats=1, device="cpu")
    tline = capsys.readouterr().out
    jfields, tfields = jline.split(), tline.split()
    assert tfields[0] == jfields[0] and tfields[-1] == "[cpu]"
    assert round(float(jfields[3])) == tout["merges"] \
        == 2 * int(lanes["valid"].sum())
    assert re.fullmatch(r"copy-batch(-valref)?", tout["variant"])


@pytest.mark.parametrize("name", tpk.VARIANTS)
def test_run_variant_on_the_cpu(name, capsys):
    out = tpk.run_variant(name, 4096, 16, 8, repeats=1, device="cpu")
    assert out["n_chunks"] == 2 and out["merges"] > 0
    line = capsys.readouterr().out
    assert line.split()[0] == name and line.rstrip().endswith("[cpu]")


def test_probe_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tpk, "run_named", lambda *a: ran.append(a))
    assert tpk.main(["--variants", "copy,copy-batch"]) == 2
    assert not ran and "no CUDA device" in capsys.readouterr().err
    assert tpk.main(["--variants", "copy,warp"]) == 2
