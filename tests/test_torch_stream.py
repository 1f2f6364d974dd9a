"""The port's stream replay (`crdt_tpu_torch.ops.stream_kernel`, K3)
held against the JAX package bit for bit (integer lanes: tolerance 0),
on the same numpy inputs:

- `pallas_fanin_stream` / `pallas_fanin_step` in interpret mode — the
  Pallas kernel that ``csrc/fanin_stream.cu`` replaces — in both guard
  modes, on every store lane, ``win``, ``new_canonical`` and the flags
  (the JAX side takes the same lanes split by `split_store` /
  `split_changeset`);
- ``n_chunks`` sequential exact folds (`ops.dense.fanin_step` in each
  package) on lanes and the threaded clock, as
  ``tests/test_pallas_merge.py`` holds the Pallas kernel;
- the closed form over the chunks that ``csrc/fanin_stream.cu``
  computes, rendered in plain torch (`fanin_stream_closed_reference`),
  against the chunk walk `fanin_stream_reference` and the Pallas kernel
  in interpret mode, on planted inputs (`torch_stream_cases`) in both
  guard modes, 1 to 128 chunks and 1 to 13 rows.

On the CPU `fanin_stream` runs the plain version; the CUDA kernel is
held against it on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crdt_tpu.hlc import MAX_DRIFT, SHIFT
from crdt_tpu.ops import dense as jd
from crdt_tpu.ops import pallas_merge as jp
from crdt_tpu_torch.ops import dense as td
from crdt_tpu_torch.ops import stream_kernel as sk

from test_torch_fanin import (BASE, LOCAL, N, WALL, assert_lanes_equal,
                              jax_lanes, make_inputs, torch_cs)
from torch_stream_cases import (AHEAD, CLOSED_CASES, EMPTY_COL, FAR_AHEAD,
                                ROW_TIE, TIE0, TIE_LAST, closed_inputs,
                                exact_flags)
from torch_threads import cap_torch_threads

cap_torch_threads()


def jax_stream(store, cs, canonical, n_chunks, guards, wall=WALL):
    st, res = jp.pallas_fanin_stream(
        jp.split_store(jax_lanes(store, jd.DenseStore)),
        jp.split_changeset(jax_lanes(cs, jd.DenseChangeset)),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(wall),
        n_chunks=n_chunks, guards=guards, interpret=True)
    return jp.join_store(st), res


def assert_stream_equal(jout, tout, where):
    (jstore, jres), (tstore, tres) = jout, tout
    assert_lanes_equal(jstore, tstore, where)
    np.testing.assert_array_equal(np.asarray(jres.win), tres.win.numpy(),
                                  err_msg=where)
    assert int(jres.new_canonical) == int(tres.new_canonical), where
    assert bool(jres.any_dup) == bool(tres.any_dup), where
    assert bool(jres.any_drift) == bool(tres.any_drift), where


STREAM_CASES = [(0, "plain", 1, "exact"), (1, "dup", 3, "exact"),
                (2, "drift", 2, "exact"), (3, "dup", 4, "fast"),
                (4, "plain", 3, "fast"), (5, "drift", 4, "fast"),
                (6, "dup", 2, "fast")]


@pytest.mark.parametrize("seed,case,n_chunks,guards", STREAM_CASES)
def test_fanin_stream_matches_pallas(seed, case, n_chunks, guards):
    store, cs, canonical = make_inputs(seed, case, r=8)
    tout = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs),
                           canonical, LOCAL, WALL, n_chunks=n_chunks,
                           guards=guards)
    assert_stream_equal(jax_stream(store, cs, canonical, n_chunks, guards),
                        tout, f"{case}/{guards}")
    if guards == "exact":
        # make_inputs puts one record AT the drift threshold: from chunk
        # 1 on it is a millisecond past it.
        assert bool(tout[1].any_dup) == (case == "dup")
        assert bool(tout[1].any_drift) == (case == "drift" or n_chunks > 1)
    assert bool(tout[1].win.any())


def shielded_inputs():
    """One column: row 0 a larger non-local record, row 1 a local-node
    record above the canonical, shielded by row 0 in every chunk."""
    store, cs, _ = make_inputs(7, r=4)
    cs = {k: v[:2].copy() for k, v in cs.items()}
    cs["valid"][:] = False
    cs["valid"][:, 11] = True
    cs["node"][:, 11] = (3, LOCAL)
    cs["lt"][:, 11] = (BASE + (5 << SHIFT), BASE + 1)
    return store, cs, BASE


@pytest.mark.parametrize("guards", ["exact", "fast"])
@pytest.mark.parametrize("n_chunks", [1, 4])
def test_exact_guards_shield_what_fast_guards_flag(guards, n_chunks):
    store, cs, canonical = shielded_inputs()
    tout = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs),
                           canonical, LOCAL, WALL, n_chunks=n_chunks,
                           guards=guards)
    assert_stream_equal(jax_stream(store, cs, canonical, n_chunks, guards),
                        tout, guards)
    assert bool(tout[1].any_dup) == (guards == "fast")
    assert not bool(tout[1].any_drift)


def test_fanin_step_matches_pallas_step():
    store, cs, canonical = make_inputs(8, "dup")
    jst, jres = jp.pallas_fanin_step(
        jp.split_store(jax_lanes(store, jd.DenseStore)),
        jp.split_changeset(jax_lanes(cs, jd.DenseChangeset)),
        jnp.int64(canonical), jnp.int32(LOCAL), jnp.int64(WALL),
        interpret=True)
    tout = sk.fanin_step(td.store_from_numpy(store), torch_cs(cs), canonical,
                         LOCAL, WALL)
    assert_stream_equal((jp.join_store(jst), jres), tout, "step")
    one = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs),
                          canonical, LOCAL, WALL, n_chunks=1)
    for a, b in zip(list(tout[0]) + list(tout[1]),
                    list(one[0]) + list(one[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(2))
def test_stream_matches_sequential_folds(seed):
    """n_chunks exact folds with every lt advanced c ms in chunk c and
    the canonical threaded: the store lanes and clock of the stream, in
    both packages' `fanin_step`."""
    n_chunks = 3
    store, cs, canonical = make_inputs(10 + seed, r=4)
    cs["valid"][3, 7] = False                # keep the drift edge out
    jst, jcanon = jax_lanes(store, jd.DenseStore), jnp.int64(canonical)
    tst, tcanon = td.store_from_numpy(store), canonical
    win = torch.zeros(N, dtype=torch.bool)
    for c in range(n_chunks):
        cs_c = dict(cs, lt=cs["lt"] + (c << SHIFT))
        jst, jres = jd.fanin_step(jst, jax_lanes(cs_c, jd.DenseChangeset),
                                  jcanon, jnp.int32(LOCAL), jnp.int64(WALL))
        tst, tres = td.fanin_step(tst, torch_cs(cs_c), tcanon, LOCAL, WALL)
        jcanon, tcanon = jres.new_canonical, tres.new_canonical
        win |= tres.win
    for guards in ("exact", "fast"):
        sst, sres = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs),
                                    canonical, LOCAL, WALL,
                                    n_chunks=n_chunks, guards=guards)
        assert_lanes_equal(jst, sst, f"stream vs JAX folds ({guards})")
        assert_lanes_equal(tst, sst, f"stream vs port folds ({guards})")
        assert int(sres.new_canonical) == int(jcanon) == int(tcanon)
        assert torch.equal(sres.win, win)


def test_stream_offsets_do_not_resurrect_invalid():
    store, cs, _ = make_inputs(11, r=4)
    cs = {k: v[:1].copy() for k, v in cs.items()}
    store = {k: np.zeros_like(v) for k, v in store.items()}
    cs["valid"][:] = False
    cs["valid"][0, 0] = True
    cs["val"][0, 0] = 42
    tst, tres = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs), 0,
                                LOCAL, WALL, n_chunks=4)
    assert int(tst.occupied.sum()) == 1 == int(tres.win.sum())
    assert int(tst.val[0]) == 42
    assert int(tst.lt[0]) == int(cs["lt"][0, 0]) + (3 << SHIFT)


def test_stream_drift_boundary_and_argument_checks():
    store, cs, _ = make_inputs(12, r=4)
    cs = {k: v[:1].copy() for k, v in cs.items()}
    cs["valid"][:] = False
    cs["valid"][0, 5] = True
    cs["node"][0, 5] = 3
    wall = 1_700_000_000_000
    for guards in ("exact", "fast"):
        for ms, counter, n_chunks, want in ((MAX_DRIFT, 3, 1, False),
                                            (MAX_DRIFT + 1, 0, 1, True),
                                            (MAX_DRIFT - 1, 9, 2, False),
                                            (MAX_DRIFT, 9, 2, True)):
            cs["lt"][0, 5] = ((wall + ms) << SHIFT) + counter
            tout = sk.fanin_stream(td.store_from_numpy(store), torch_cs(cs),
                                   0, LOCAL, wall, n_chunks=n_chunks,
                                   guards=guards)
            assert bool(tout[1].any_drift) == want
            assert_stream_equal(jax_stream(store, cs, 0, n_chunks, guards,
                                           wall=wall), tout, guards)
    args = (td.store_from_numpy(store), torch_cs(cs), 0, LOCAL, wall)
    for kw in (dict(n_chunks=0), dict(n_chunks=1 << 15),
               dict(n_chunks=2, guards="bogus")):
        with pytest.raises(ValueError):
            sk.fanin_stream(*args, **kw)


# --- the closed form over the chunks --------------------------------------


@pytest.mark.parametrize("guards", ["exact", "fast"])
@pytest.mark.parametrize("n_chunks", [1, 2, 5, 128])
@pytest.mark.parametrize("r", [1, 8, 13])
@pytest.mark.parametrize("case", CLOSED_CASES)
def test_closed_form_matches_chunk_walk_and_pallas(case, r, n_chunks,
                                                   guards):
    """`fanin_stream_closed_reference` (what ``csrc/fanin_stream.cu``
    computes) against the chunk walk `fanin_stream_reference` and the
    Pallas kernel in interpret mode: every store lane, win, the
    canonical and both flags, tolerance 0."""
    store, cs, canonical = closed_inputs(case, r, n_chunks)
    args = (td.store_from_numpy(store), torch_cs(cs), canonical, LOCAL,
            WALL)
    closed = sk.fanin_stream_closed_reference(*args, n_chunks=n_chunks,
                                              guards=guards)
    walk = sk.fanin_stream_reference(*args, n_chunks=n_chunks,
                                     guards=guards)
    where = f"{case}/r={r}/n_chunks={n_chunks}/{guards}"
    assert_stream_equal((walk[0], walk[1]), closed, f"walk: {where}")
    assert_stream_equal(jax_stream(store, cs, canonical, n_chunks, guards),
                        closed, f"pallas: {where}")
    st, res = closed
    got = (bool(res.any_dup), bool(res.any_drift))
    if guards == "exact":
        assert got == exact_flags(case, n_chunks), where
    elif case == "dup_near_at" and r > 1 and n_chunks > 1:
        assert got == (True, False), where    # the shielded entry flags
    if case == "empty":
        assert not bool(res.win.any())
        return
    assert bool(res.win[AHEAD]) == (n_chunks >= 5)
    assert not bool(res.win[FAR_AHEAD] | res.win[TIE_LAST]
                    | res.win[EMPTY_COL])
    assert bool(res.win[TIE0]) == (n_chunks > 1)
    assert int(st.val[ROW_TIE]) == 111 and bool(res.win[ROW_TIE])
    assert int(st.mod_lt[ROW_TIE]) == int(res.new_canonical)
