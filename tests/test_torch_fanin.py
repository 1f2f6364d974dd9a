"""The port's batch fan-in (`crdt_tpu_torch.ops.fanin_kernel`) held
against the JAX package, bit for bit (integer lanes: tolerance 0), on
the same numpy inputs:

- `pallas_fanin_batch` in interpret mode — the Pallas kernel K1 that
  the port's CUDA kernel replaces — on occupied-slot lanes, ``win``,
  ``new_canonical`` and both superset flags;
- `ops.dense.fanin_step`, the XLA fold with exact guards, on every
  lane;
- `model_fanin_batch` / `pipelined_model_step` in interpret mode,
  including the value_width=32 masking.

On the CPU the port's wrapper runs the kernel's plain version; the
CUDA kernel itself is held against that plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops import merge as jm
from crdt_tpu.ops import pallas_merge as jp
from crdt_tpu.testing import assert_dense_stores_equal
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import fanin_kernel as tk
from crdt_tpu_torch.ops import merge as tm
from torch_threads import cap_torch_threads

cap_torch_threads()

N = 2 * 4096          # two TPU tiles: the smallest the Pallas side takes
R = 16                # two chunks of 8 rows on the Pallas side
MILLIS = 1_700_000_000_000
WALL = MILLIS + 10_000
LOCAL = 0
BASE = MILLIS << SHIFT


def make_inputs(seed, case="plain", r=R):
    """Store and changeset lanes with ties between rows, ties with the
    store, tombstones, empty slots and invalid entries. ``case`` adds a
    local-node record above canonical ("dup") or a record past the
    drift threshold ("drift"); "plain" puts one record exactly AT the
    drift threshold, which must not trip."""
    rng = np.random.default_rng(seed)

    def lts(shape):
        # 4 millis x 3 counters: (lt, node) ties are common.
        return (BASE + (rng.integers(0, 4, shape) << SHIFT)
                + rng.integers(0, 3, shape))

    occ = rng.random(N) < 0.5
    store = dict(
        lt=np.where(occ, lts(N), 0),
        node=np.where(occ, rng.integers(0, 6, N), 0).astype(np.int32),
        val=np.where(occ, rng.integers(-2 ** 31, 2 ** 31, N), 0),
        mod_lt=np.where(occ, lts(N) + (5 << SHIFT), 0),
        mod_node=np.where(occ, rng.integers(0, 6, N), 0).astype(np.int32),
        occupied=occ,
        tomb=occ & (rng.random(N) < 0.3))
    cs = dict(
        lt=lts((r, N)),
        node=rng.integers(0, 6, (r, N)).astype(np.int32),
        val=rng.integers(-2 ** 31, 2 ** 31, (r, N)),
        tomb=rng.random((r, N)) < 0.3,
        valid=rng.random((r, N)) < 0.7)
    # Exact (lt, node) ties between rows, with differing payloads.
    cols = rng.choice(N, 500, replace=False)
    for a, b in ((0, 3), (2, r - 1)):
        cs["lt"][b, cols] = cs["lt"][a, cols]
        cs["node"][b, cols] = cs["node"][a, cols]
        cs["valid"][a, cols] = True
        cs["valid"][b, cols] = True
    # Exact ties with occupied store slots: local must keep them.
    tied = np.nonzero(occ)[0][:300]
    cs["lt"][1, tied] = store["lt"][tied]
    cs["node"][1, tied] = store["node"][tied]
    cs["valid"][1, tied] = True
    canonical = BASE + (10 << SHIFT)      # above every record
    if case == "dup":
        canonical = BASE + (1 << SHIFT)   # local-node records above it
    thresh = ((WALL + MAX_DRIFT) << SHIFT) | MAX_COUNTER
    cs["valid"][r - 1, 7] = True
    cs["node"][r - 1, 7] = 5
    cs["lt"][r - 1, 7] = thresh + 1 if case == "drift" else thresh
    return store, cs, canonical


def jax_lanes(d, cls):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_cs(d):
    return td.DenseChangeset(**{k: torch.tensor(v) for k, v in d.items()})


def assert_lanes_equal(a, b, where):
    for f in td.DenseStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{where}: {f}")


CASES = [(0, "plain"), (1, "dup"), (2, "drift")]


@pytest.mark.parametrize("seed,case", CASES)
def test_fanin_batch_matches_pallas_kernel(seed, case):
    store, cs, canonical = make_inputs(seed, case)
    jstore, jres = jp.pallas_fanin_batch(
        jp.split_store(jax_lanes(store, jd.DenseStore)),
        jp.split_changeset(jax_lanes(cs, jd.DenseChangeset)),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL),
        chunk_rows=8, interpret=True)
    jstore = jp.join_store(jstore)
    for fn in (tk.fanin_batch, tk.fanin_batch_reference):
        tstore, tres = fn(td.store_from_numpy(store), torch_cs(cs),
                          canonical, LOCAL, WALL)
        assert_dense_stores_equal(jstore, tstore, where=fn.__name__)
        np.testing.assert_array_equal(np.asarray(jres.win),
                                      tres.win.numpy())
        assert int(jres.new_canonical) == int(tres.new_canonical)
        assert bool(jres.any_dup) == bool(tres.any_dup)
        assert bool(jres.any_drift) == bool(tres.any_drift)
    assert bool(tres.any_dup) == (case == "dup")
    assert bool(tres.any_drift) == (case == "drift")


@pytest.mark.parametrize("seed,case", CASES)
def test_fanin_batch_matches_xla_fold(seed, case):
    store, cs, canonical = make_inputs(seed, case)
    jstore, jres = jd.fanin_step(
        jax_lanes(store, jd.DenseStore), jax_lanes(cs, jd.DenseChangeset),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL))
    tstore, tres = tk.fanin_batch(td.store_from_numpy(store), torch_cs(cs),
                                  canonical, LOCAL, WALL)
    assert_lanes_equal(jstore, tstore, "fanin_batch vs fanin_step")
    np.testing.assert_array_equal(np.asarray(jres.win), tres.win.numpy())
    assert int(jres.new_canonical) == int(tres.new_canonical)
    assert int(tres.basemax) == int(np.where(cs["valid"], cs["lt"],
                                             td._NEG).max())
    # The batch flags are a superset of the exact guards.
    if bool(jres.any_bad):
        assert bool(tres.any_dup | tres.any_drift)


@pytest.mark.parametrize("seed,case", CASES)
def test_fanin_step_oracle_matches_jax(seed, case):
    """The port's exact-guard fold equals the JAX fold in every lane and
    every `FaninResult` field, first-offender diagnostics included."""
    store, cs, canonical = make_inputs(seed, case)
    jstore, jres = jd.fanin_step(
        jax_lanes(store, jd.DenseStore), jax_lanes(cs, jd.DenseChangeset),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL))
    tstore, tres = td.fanin_step(td.store_from_numpy(store), torch_cs(cs),
                                 canonical, LOCAL, WALL)
    assert_lanes_equal(jstore, tstore, "fanin_step")
    for f in td.FaninResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy(), err_msg=f)
    assert bool(tres.any_bad) == (case != "plain")


def test_fanin_batch_without_valid_rows_keeps_store_and_clock():
    store, cs, canonical = make_inputs(3)
    cs["valid"][:] = False
    tstore, tres = tk.fanin_batch(td.store_from_numpy(store), torch_cs(cs),
                                  canonical, LOCAL, WALL)
    assert_lanes_equal(td.store_from_numpy(store), tstore, "no rows")
    assert int(tres.basemax) == td._NEG
    assert int(tres.new_canonical) == canonical
    assert not tres.win.any()


@pytest.mark.parametrize("seed,case", [(4, "plain"), (5, "dup")])
def test_model_fanin_batch_value_width_32(seed, case):
    store, cs, canonical = make_inputs(seed, case, r=8)
    big = np.random.default_rng(seed).choice(N, 40, replace=False)
    cs["val"][2, big] = 2 ** 33          # past int32: masked, flagged
    cs["val"][5, big] = -(2 ** 31) - 1
    cs["valid"][2, big] = True
    jstore, jres, jseen, jovf = jp.model_fanin_batch(
        jax_lanes(store, jd.DenseStore), jax_lanes(cs, jd.DenseChangeset),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL),
        chunk_rows=8, interpret=True, value_width=32)
    tstore, tres, tseen, tovf = tk.model_fanin_batch(
        td.store_from_numpy(store), torch_cs(cs), canonical, LOCAL, WALL,
        value_width=32)
    assert_dense_stores_equal(jstore, tstore, where="model_fanin_batch")
    np.testing.assert_array_equal(np.asarray(jres.win), tres.win.numpy())
    assert int(jres.new_canonical) == int(tres.new_canonical)
    assert bool(jres.any_dup) == bool(tres.any_dup)
    assert bool(jres.any_drift) == bool(tres.any_drift)
    assert int(jseen) == int(tseen)
    assert bool(jovf) and bool(tovf)


def test_pipelined_model_step_matches_jax():
    """Two coarse pipelined steps, the second tripping the dup flag:
    threaded clock, accumulated flags and first-flag index agree."""
    store, cs, _ = make_inputs(6, r=8)
    _, cs2, _ = make_inputs(7, r=8)
    cs["valid"][7, 7] = cs2["valid"][7, 7] = False   # no drift-edge row
    jstate = (jnp.int64(BASE + (10 << SHIFT)), jnp.asarray(False),
              jnp.asarray(False), jnp.asarray(False), jnp.asarray(False),
              jnp.int32(-1))
    tstate = (torch.tensor(BASE + (10 << SHIFT)), torch.tensor(False),
              torch.tensor(False), torch.tensor(False), torch.tensor(False),
              torch.tensor(-1, dtype=torch.int32))
    jstore = jax_lanes(store, jd.DenseStore)
    tstore = td.store_from_numpy(store)
    cs2["node"][0, :50] = LOCAL
    cs2["valid"][0, :50] = True
    # Above the clock threaded out of step 0 (its send bump to WALL+1).
    cs2["lt"][0, :50] = (WALL + 5) << SHIFT
    for i, c in enumerate((cs, cs2)):
        jout = jp.pipelined_model_step(
            jstore, jax_lanes(c, jd.DenseChangeset), *jstate,
            jnp.int32(LOCAL), jnp.int64(WALL + 2 * i),
            jnp.int64(WALL + 2 * i + 1), jnp.int32(i), chunk_rows=8,
            interpret=True)
        tout = tk.pipelined_model_step(
            tstore, torch_cs(c), *tstate, LOCAL, WALL + 2 * i,
            WALL + 2 * i + 1, i)
        jstore, tstore = jout[0], tout[0]
        jstate, tstate = jout[1:7], tout[1:7]
        assert_dense_stores_equal(jstore, tstore, where=f"step {i}")
        for j, (a, b) in enumerate(zip(jout[1:], tout[1:])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"step {i} output {j}")
    assert int(tstate[5]) == 1 and bool(tstate[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_recv_guards_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lt = BASE + (rng.integers(0, 200_000, (4, 64)) << SHIFT)
    node = rng.integers(0, 3, (4, 64)).astype(np.int32)
    valid = rng.random((4, 64)) < 0.6
    canonical = BASE + (int(rng.integers(0, 100_000)) << SHIFT)
    wall = MILLIS + int(rng.integers(0, 120_000))
    jout = jm.recv_guards(jnp.asarray(lt), jnp.asarray(node),
                          jnp.asarray(valid), jnp.int64(canonical),
                          jnp.int32(LOCAL), jnp.int64(wall))
    tout = tm.recv_guards(torch.tensor(lt), torch.tensor(node),
                          torch.tensor(valid), canonical, LOCAL, wall)
    for a, b in zip(jout, tout):
        assert int(a) == int(b)


@pytest.mark.parametrize("lt_ms,counter,wall", [
    (MILLIS, 5, MILLIS - 1), (MILLIS, MAX_COUNTER, MILLIS),
    (MILLIS, 3, MILLIS + 7), (MILLIS + MAX_DRIFT + 1, 0, MILLIS)])
def test_send_step_matches_jax(lt_ms, counter, wall):
    lt = (lt_ms << SHIFT) + counter
    jout = jm.send_step(jnp.int64(lt), jnp.int64(wall))
    tout = tm.send_step(torch.tensor(lt), wall)
    assert [int(x) for x in jout] == [int(x) for x in tout]


def test_cpu_wrapper_launches_no_kernel():
    """On CPU tensors the wrapper takes the plain version: the kernel's
    launch counter does not move."""
    store, cs, canonical = make_inputs(8, r=4)
    obs_device.reset()
    tk.fanin_batch(td.store_from_numpy(store), torch_cs(cs), canonical,
                   LOCAL, WALL)
    assert obs_device.launches() == {"fanin_batch": 0, "ingest_scatter": 0,
                                     "fanin_split": 0, "fanin_stream": 0,
                                     "fanin_batch_sharded": 0,
                                     "probe_join": 0, "probe_copy": 0,
                                     "probe_stream_noguard": 0,
                                     "probe_copy_batch": 0}
