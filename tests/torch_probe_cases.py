"""Planted inputs for probe P1c's closed form over the chunks
(`crdt_tpu_torch.ops.probe.probe_stream_noguard_closed_reference` and
``csrc/probe_stream_noguard.cu``), shared by the CPU parity tests
(``test_torch_probe.py``, against the chunk walk and the Pallas body)
and the card tests (``test_torch_cuda.py``, the kernel against the
chunk walk). Imports neither jax nor the JAX package.

Terms: an entry whose ``hi`` is NEG_HI is static (chunk c never moves
it); any other entry moves, its key ``hi:lo`` advanced by ``c << 16``
in chunk c. S is the static entries' max, M the moving entries' max at
the last chunk."""

import numpy as np

from crdt_tpu_torch.ops.probe import probe_scalars
from crdt_tpu_torch.ops.split import I16_NEG, NEG_HI, SplitChangeset, \
    SplitStore

I32_MAX = 2 ** 31 - 1
BASE = 1_700_000_000_000 << 16
H = BASE >> 32                   # the generated entries' hi words: H..H+2
SCALARS = probe_scalars(BASE + (5 << 16), 3, BASE + (0x9ABC << 16) + 0xFFFF)
# Planted columns, one case each.
(STATIC_WINS, MALFORMED_TIE, M_TIES_S, M_TIES_STORE, S_TIES_STORE, WRAP,
 NO_CARRY, ROW_TIE, NO_WIN, STALE) = range(11, 21)
CHUNKS = [1, 2, 3, 128]


def expected(n_chunks):
    """Per planted column, ``(win, last chunk won, winning row or -1)``."""
    one = n_chunks == 1
    return {STATIC_WINS: (True, one, 1), MALFORMED_TIE: (True, one, 0),
            M_TIES_S: (True, one, 2), M_TIES_STORE: (False, False, -1),
            S_TIES_STORE: (False, False, -1),
            WRAP: (True, one, 1), NO_CARRY: (True, True, 1),
            ROW_TIE: (True, True, 0), NO_WIN: (False, False, -1),
            STALE: (n_chunks >= 3, n_chunks >= 3, 0 if n_chunks >= 3
                    else -1)}


def probe_case_lanes(r, n_chunks, n=4096):
    """A split store and ``[r, n]`` split lanes (numpy, ``r >= 3``) from
    a seed, with keys close together (ties at every level), whole-range
    ``hi`` words every 3rd slot, ``hi == INT32_MAX`` every 97th (its
    carry wraps), invalid entries and malformed sentinels (hi = NEG_HI,
    lo != 0); and these cases planted in their own columns (the
    column's other entries invalid, each row's payload its own):

    - STATIC_WINS: a malformed sentinel beats the empty store; a moving
      entry stays below it (win, but the last chunk does not);
    - MALFORMED_TIE: rows 0 and 2 hold one malformed sentinel key with
      other payloads (row 0's lands);
    - M_TIES_S: row 0 moves from NEG_HI - 1 and carries onto NEG_HI at
      the last chunk, equal to row 2's static key, lo and node (S was
      reached first: row 2's lands, the last chunk does not win);
    - M_TIES_STORE: the store slot equals M (the store keeps it);
      S_TIES_STORE: the store slot equals S, a malformed sentinel, with
      a moving entry below both (the store keeps it);
    - WRAP: row 1 at hi = INT32_MAX wraps halfway through the chunks
      (the best is its last key before the wrap); NO_CARRY: row 1 at
      hi = INT32_MAX with a carry that never comes (M wins);
    - ROW_TIE: rows 0 and r - 1 tie on the column max with other
      payloads (row 0's lands);
    - NO_WIN: the store slot 10 hi-words above every entry;
    - STALE: the store 1 ms and 5 counters above row 0, so chunks 0 and
      1 lose and chunk 2 wins.

    Returns ``(store, cs)`` as `SplitStore` / `SplitChangeset` of numpy
    arrays."""
    rng = np.random.default_rng(100 * r + n_chunks)
    off = (n_chunks - 1) << 16
    hi = (H + rng.integers(0, 3, (r, n))).astype(np.int32)
    hi[:, ::3] = rng.integers(-2 ** 31, 2 ** 31, (r, len(hi[0, ::3])))
    hi[:, 5::97] = I32_MAX
    lo = rng.choice(np.array([0, 1 << 16, 0xFFFF0000, 0xFFFFFFFF],
                             np.uint32), (r, n))
    lo[:, 1::3] = rng.integers(0, 2 ** 32, (r, len(lo[0, 1::3])))
    node = rng.integers(1, 9, (r, n)).astype(np.int16)
    node[:, ::4] = rng.integers(30_000, 2 ** 15, (r, len(node[0, ::4])))
    for a in (hi, lo, node):
        a[1, ::7] = a[0, ::7]
    invalid = rng.random((r, n)) < 0.2
    hi[invalid], lo[invalid], node[invalid] = NEG_HI, 0, I16_NEG
    hi[r - 1, 11::41], lo[r - 1, 11::41] = NEG_HI, 9
    vhi = rng.integers(-2 ** 31, 2 ** 31, (r, n)).astype(np.int32)
    vlo = rng.integers(0, 2 ** 32, (r, n)).astype(np.uint32)
    tomb = rng.integers(-128, 128, (r, n)).astype(np.int8)
    st = {f: rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
          for f in SplitStore._fields}
    for f in ("lo", "val_lo", "mod_lo"):
        st[f] = st[f].view(np.uint32)
    empty = rng.random(n) < 0.3
    st["hi"][empty], st["lo"][empty] = NEG_HI, 0

    planted = np.arange(STATIC_WINS, STALE + 1)
    hi[:, planted], lo[:, planted], node[:, planted] = NEG_HI, 0, I16_NEG
    for col in planted:
        vhi[:, col] = 1000 * np.arange(r) + col
        st["hi"][col], st["lo"][col], st["node"][col] = NEG_HI, 0, 0

    def put(row, col, h, l, nd):
        hi[row, col], lo[row, col], node[row, col] = h, l, nd

    put(1, STATIC_WINS, NEG_HI, 1000, 5)
    put(0, STATIC_WINS, NEG_HI - 1, 5, 2)
    put(0, MALFORMED_TIE, NEG_HI, 9, 3)
    put(2, MALFORMED_TIE, NEG_HI, 9, 3)
    x = (off >> 1) + 7                    # below off: the add carries
    put(2, M_TIES_S, NEG_HI, x, 4)
    put(0, M_TIES_S, NEG_HI - 1, (x - off) % 2 ** 32, 4)
    put(0, M_TIES_STORE, H + 1, 77, 6)
    put(1, M_TIES_STORE, H, 99, 8)
    st["hi"][M_TIES_STORE], st["lo"][M_TIES_STORE] = H + 1, 77 + off
    st["node"][M_TIES_STORE] = 6
    put(1, S_TIES_STORE, NEG_HI, 9, 3)
    put(0, S_TIES_STORE, NEG_HI - 1, 5, 2)
    st["lo"][S_TIES_STORE], st["node"][S_TIES_STORE] = 9, 3
    put(1, WRAP, I32_MAX, 0xFFFFFFFF - (off >> 1), 1)
    put(0, WRAP, H, 5, 2)
    put(1, NO_CARRY, I32_MAX, 5, 1)
    put(0, NO_CARRY, H + 2, 5, 2)
    for row in (0, r - 1):
        put(row, ROW_TIE, H + 3, 0x1234, 2)
    put(1, ROW_TIE, H + 3, 0x1233, 2)
    put(0, NO_WIN, H + 2, 0xFFFFFFFF, 9)
    st["hi"][NO_WIN] = H + 10
    put(0, STALE, H + 1, 100, 7)
    st["hi"][STALE], st["lo"][STALE] = H + 1, 100 + (1 << 16) + 5
    return (SplitStore(**st),
            SplitChangeset(hi=hi, lo=lo, node=node, val_hi=vhi, val_lo=vlo,
                           tomb=tomb))
