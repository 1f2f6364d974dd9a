"""Planted inputs for the stream replay's closed form over the chunks
(`crdt_tpu_torch.ops.stream_kernel.fanin_stream_closed_reference` and
``csrc/fanin_stream.cu``), shared by the CPU parity tests
(``test_torch_stream.py``, against the chunk walk and the Pallas kernel)
and the card tests (``test_torch_cuda.py``, the kernel against the chunk
walk). Imports neither jax nor the JAX package."""

import numpy as np

from crdt_tpu_torch.hlc import MAX_DRIFT, SHIFT

MILLIS = 1_700_000_000_000
WALL = MILLIS + 10_000
LOCAL = 0
BASE = MILLIS << SHIFT
NEAR = 1 << SHIFT                    # basemax - 2^16: the c >= 1 window
TOP = BASE + (5 << SHIFT)            # a non-local column max; canon0
THRESH = ((WALL + MAX_DRIFT) << SHIFT) | 0xFFFF
# Planted slots (columns).
AHEAD, FAR_AHEAD, TIE0, TIE_LAST, ROW_TIE, EMPTY_COL = 11, 12, 13, 14, 15, 16
TOP_COL, X_COL, SHIELD_COL = 21, 22, 23
CLOSED_CASES = ["dup_canon_at", "dup_canon_above", "dup_near_at",
                "dup_near_above", "drift_at", "drift_above", "empty"]


def closed_inputs(case, r, n_chunks, n=4096):
    """Store and ``[r, n]`` changeset from a seed (``n = 4096``: one TPU
    tile), with the cases the closed form must get right planted in
    their own columns:

    - AHEAD: the store slot 3 ms ahead of its column's (lt, node), so
      chunks 0-3 lose (chunk 3 ties, and local wins) and chunk 4 is the
      first to win; FAR_AHEAD: 200 ms ahead, so no chunk wins;
    - TIE0 / TIE_LAST: the store slot equal to its column's max at chunk
      0 / at the last chunk: local wins that tie;
    - ROW_TIE: rows 0 and r-1 tie on the column max with other payloads;
    - SHIELD_COL: a local-node entry 1 ms less one counter below TOP,
      shielded by a larger non-local entry in an earlier row;
    - EMPTY_COL: no valid entry;
    - TOP_COL: TOP, non-local, the max of every generated record; the
      canonical is TOP, so no generated record reaches the slow path;
    - X_COL: the boundary entry of ``case`` as the last row: a local
      entry at canon0 ("dup_canon_*") or at basemax - 2^16 ("dup_near_*"),
      or a non-local one at thresh - off ("drift_*"), exactly ("_at") or
      one above ("_above").

    "empty" has no valid entry at all. Returns ``(store, cs,
    canonical)`` as numpy lanes and an int."""
    rng = np.random.default_rng(1000 * r + n_chunks)

    def lts(shape):
        return (BASE + (rng.integers(0, 4, shape) << SHIFT)
                + rng.integers(0, 3, shape))

    occ = rng.random(n) < 0.5
    store = dict(
        lt=np.where(occ, lts(n), 0),
        node=np.where(occ, rng.integers(0, 6, n), 0).astype(np.int32),
        val=rng.integers(-2 ** 62, 2 ** 62, n),
        mod_lt=np.where(occ, lts(n) + (5 << SHIFT), 0),
        mod_node=np.where(occ, rng.integers(0, 6, n), 0).astype(np.int32),
        occupied=occ, tomb=occ & (rng.random(n) < 0.3))
    cs = dict(lt=lts((r, n)),
              node=rng.integers(0, 6, (r, n)).astype(np.int32),
              val=rng.integers(-2 ** 62, 2 ** 62, (r, n)),
              tomb=rng.random((r, n)) < 0.3,
              valid=rng.random((r, n)) < 0.7)
    if case == "empty":
        cs["valid"][:] = False
        return store, cs, TOP
    off = (n_chunks - 1) << SHIFT
    cs["valid"][:, [AHEAD, FAR_AHEAD, TIE0, TIE_LAST]] = True
    for col, ahead in ((AHEAD, 3 << SHIFT), (FAR_AHEAD, 200 << SHIFT),
                       (TIE0, 0), (TIE_LAST, off)):
        best = max(zip(cs["lt"][:, col], cs["node"][:, col]))
        store["lt"][col], store["node"][col] = best[0] + ahead, best[1]
        store["occupied"][col] = True
    cs["valid"][:, ROW_TIE] = True
    cs["lt"][[0, r - 1], ROW_TIE] = BASE + (3 << SHIFT) + 5
    cs["node"][[0, r - 1], ROW_TIE] = 2
    cs["val"][[0, r - 1], ROW_TIE] = (111, 222) if r > 1 else 111
    store["occupied"][ROW_TIE] = False
    store["lt"][ROW_TIE] = store["node"][ROW_TIE] = 0
    cs["valid"][:, EMPTY_COL] = False
    cs["valid"][:, TOP_COL] = False
    cs["valid"][0, TOP_COL], cs["node"][0, TOP_COL] = True, 3
    cs["lt"][0, TOP_COL] = TOP
    if r > 1:
        cs["valid"][:2, SHIELD_COL] = True
        cs["node"][:2, SHIELD_COL] = (4, LOCAL)
        cs["lt"][:2, SHIELD_COL] = (TOP - NEAR + 2, TOP - NEAR + 1)
    kind, at = case.rsplit("_", 1)
    x = {"dup_canon": TOP, "dup_near": TOP - NEAR,
         "drift": THRESH - off}[kind] + (at == "above")
    cs["valid"][:, X_COL] = False
    cs["valid"][r - 1, X_COL] = True
    cs["node"][r - 1, X_COL] = 5 if kind == "drift" else LOCAL
    cs["lt"][r - 1, X_COL] = x
    return store, cs, TOP


def exact_flags(case, n_chunks):
    """(any_dup, any_drift) the exact guards owe ``case``."""
    more = n_chunks > 1
    return {"dup_canon_at": (more, False), "dup_canon_above": (True, False),
            "dup_near_at": (False, False), "dup_near_above": (more, False),
            "drift_at": (False, False), "drift_above": (False, True),
            "empty": (False, False)}[case]
