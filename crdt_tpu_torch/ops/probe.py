"""The kernel probes on the card: wrappers and plain versions.

Port of the four kernel bodies of ``benchmarks/probe_kernel.py``, the
variants that split the fan-in kernel's time into its parts:

- `probe_join` (P1a, ``_join_only_kernel`` ``:42``, variant "nojoin"):
  the fan-in join with no guards, no basemax and no flags;
- `probe_copy` (P1b, ``_copy_kernel`` ``:82``, variant "copy"): a pure
  copy with one add per lane, at the join's layout;
- `probe_stream_noguard` (P1c, ``_stream_noguard_kernel`` ``:107``,
  variant "stream-noguard"): the stream replay's chunk loop with every
  guard removed;
- `probe_copy_batch` (P2, ``_copy_batch_kernel`` ``:278``, variants
  "copy-batch" and "copy-batch-valref"): a pure copy at the
  distinct-batch geometry, summing each group of ``chunk_rows`` rows.

Each reads a split changeset (`ops.split`: `SplitChangeset`, or for
P2 also `NarrowSplitChangeset`, ``[R, N]``) and a `SplitStore` of N
slots, and writes a fresh `SplitStore` and an int32 ``win`` lane — the
probe's ten outputs. The bodies are probes, not merges: what they
write (sums that wrap in the lane's own type, the last row's lanes,
the grouping of rows) is what the JAX bodies write, bit for bit, so
the port's numbers stand beside the same function. ``scalars`` are the
seven int32 words of ``probe_kernel.py:237-240``, ``[canon_hi,
canon_lo, local_node, canon_hi, canon_lo, newc_hi, newc_lo]``
(`probe_scalars`); the bodies read ``local_node``, ``newc_hi`` and
``newc_lo``.

Each wrapper launches its hand-written kernel (``csrc/probe_*.cu``)
for CUDA tensors, counted in `obs.device`, and takes its plain version
(``*_reference``) for CPU tensors; it never falls back from one to the
other. The TPU bodies needed ``N % 4096 == 0``; the kernels take any N
and any R >= 1 (P2: R a multiple of ``chunk_rows``).

Torch has no add, compare or select on uint32 (the CPU build has none;
the CUDA build no ``where``), so the plain versions carry uint32 words
as int32 views (the same bits) and compare ``lo`` widened to int64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import _build
from ..hlc import SHIFT
from ..obs import device as _obs_device
from .dense import check_lanes
from .split import (NEG_HI, SPLIT_DTYPES, SPLIT_STORE_DTYPES,
                    NarrowSplitChangeset, SplitStore)

Probe = Tuple[SplitStore, torch.Tensor]

CHUNK_ROWS = 16      # P2's row group: the distinct batch's chunk_rows
_U32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    """The int32 of the low 32 bits of ``x``."""
    x &= _U32
    return x - (1 << 32) if x >= 1 << 31 else x


def probe_scalars(canonical_lt: int, local_node: int = 0,
                  new_canonical: int = None) -> Tuple[int, ...]:
    """The seven scalar words of ``probe_kernel.py:237-240``;
    ``new_canonical`` defaults to ``canonical_lt``, as there."""
    newc = canonical_lt if new_canonical is None else new_canonical
    c_hi, c_lo = _i32(canonical_lt >> 32), _i32(canonical_lt)
    return (c_hi, c_lo, int(local_node), c_hi, c_lo, _i32(newc >> 32),
            _i32(newc))


# --- plain versions ----------------------------------------------------


def _lo64(lo: torch.Tensor) -> torch.Tensor:
    return lo.long() & _U32


def _lex_gt(a_hi, a_lo, a_node, b_hi, b_lo, b_node) -> torch.Tensor:
    """Strict (hi signed, lo unsigned, node) greater-than; ``lo`` words
    as int64."""
    return (a_hi > b_hi) | ((a_hi == b_hi) & (
        (a_lo > b_lo) | ((a_lo == b_lo) & (a_node > b_node))))


def _i32v(x: torch.Tensor) -> torch.Tensor:
    """A uint32 lane's bits as int32 (a view)."""
    return x.view(torch.int32)


def _add_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 + uint32, wrapping: the add of the int32 views."""
    return (_i32v(a) + _i32v(b)).view(torch.uint32)


def _stamp_mods(store: SplitStore, win: torch.Tensor,
                scalars: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """``win ? (newc_hi, newc_lo, local_node) : store's`` mod lanes."""
    return (torch.where(win, scalars[5], store.mod_hi),
            torch.where(win, scalars[6], _i32v(store.mod_lo)
                        ).view(torch.uint32),
            torch.where(win, scalars[2], store.mod_node))


def _fold_rows(cs, hi_of, best, win):
    """Fold every row into ``best = (hi, lo (int64), node, vhi, vlo
    (int32 view), tomb)`` by the strict lex compare; ``hi_of(r)`` gives
    row r's ``(hi, lo)`` key words. Returns the new best and ``win | any
    gt``."""
    b_hi, b_lo, b_node, b_vhi, b_vlo, b_tomb = best
    for r in range(cs.hi.shape[0]):
        hi, lo = hi_of(r)
        node = cs.node[r].to(torch.int32)
        gt = _lex_gt(hi, lo, node, b_hi, b_lo, b_node)
        b_hi = torch.where(gt, hi, b_hi)
        b_lo = torch.where(gt, lo, b_lo)
        b_node = torch.where(gt, node, b_node)
        b_vhi = torch.where(gt, cs.val_hi[r], b_vhi)
        b_vlo = torch.where(gt, _i32v(cs.val_lo[r]), b_vlo)
        b_tomb = torch.where(gt, cs.tomb[r].to(torch.int32), b_tomb)
        win = win | gt
    return (b_hi, b_lo, b_node, b_vhi, b_vlo, b_tomb), win


def _store_best(store: SplitStore):
    return (store.hi, _lo64(store.lo), store.node, store.val_hi,
            _i32v(store.val_lo), store.tomb)


def _finish(best, mods, win_lane) -> Probe:
    hi, lo, node, vhi, vlo, tomb = best
    return SplitStore(hi, lo.to(torch.uint32), node, vhi,
                      vlo.view(torch.uint32), tomb, *mods), win_lane


def probe_join_reference(store: SplitStore, cs, scalars: Sequence[int]
                         ) -> Probe:
    """P1a: the rows folded into the store slot by the strict lex
    compare, each new best carrying its row's payload; mod lanes
    stamped where any row won; ``win`` as int32."""
    win = torch.zeros_like(store.hi, dtype=torch.bool)
    best, win = _fold_rows(cs, lambda r: (cs.hi[r], _lo64(cs.lo[r])),
                           _store_best(store), win)
    return _finish(best, _stamp_mods(store, win, scalars),
                   win.to(torch.int32))


def probe_copy_reference(store: SplitStore, cs, scalars: Sequence[int]
                         ) -> Probe:
    """P1b: ``hi``/``lo`` plus the wrapping sum of every row's word
    (no carry between the words); ``node``, ``val_hi``, ``val_lo`` and
    ``tomb`` plus the LAST row's; mod lanes copied; ``win`` the last
    row's node, sign-extended."""
    last = cs.hi.shape[0] - 1
    a_hi, a_lo = cs.hi[0], cs.lo[0]
    for r in range(1, last + 1):
        a_hi = a_hi + cs.hi[r]
        a_lo = _add_u32(a_lo, cs.lo[r])
    node = cs.node[last].to(torch.int32)
    out = SplitStore(
        store.hi + a_hi, _add_u32(store.lo, a_lo), store.node + node,
        store.val_hi + cs.val_hi[last], _add_u32(store.val_lo,
                                                 cs.val_lo[last]),
        store.tomb + cs.tomb[last].to(torch.int32), store.mod_hi.clone(),
        store.mod_lo.clone(), store.mod_node.clone())
    return out, node


def _shifted_key(cs, off: int, r: int):
    """Row r's key advanced by ``off`` in ``lo`` (a sentinel ``hi ==
    NEG_HI`` stays put), with the carry into ``hi``; ``lo`` as int64."""
    hi0, lo0 = cs.hi[r], _lo64(cs.lo[r])
    lo = (lo0 + torch.where(hi0 == NEG_HI, 0, off)) & _U32
    return hi0 + (lo < lo0).to(torch.int32), lo


def probe_stream_noguard_reference(store: SplitStore, cs,
                                   scalars: Sequence[int], n_chunks: int
                                   ) -> Probe:
    """P1c: chunk c advances every entry whose ``hi`` is not NEG_HI by
    ``c << 16`` in ``lo``, with the carry into ``hi``, and folds the
    rows as P1a into the running best (the store slot, then the last
    chunk's result). ``win`` is the OR over chunks; the mod lanes are
    stamped where the LAST chunk won."""
    _check_chunks(n_chunks)
    best = _store_best(store)
    win_any = won = torch.zeros_like(store.hi, dtype=torch.bool)
    for c in range(n_chunks):
        best, won = _fold_rows(
            cs, functools.partial(_shifted_key, cs, (c << SHIFT) & _U32),
            best, torch.zeros_like(store.hi, dtype=torch.bool))
        win_any = win_any | won
    return _finish(best, _stamp_mods(store, won, scalars),
                   win_any.to(torch.int32))


_I64_MIN = torch.iinfo(torch.int64).min
_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 key ``hi << 32 | lo`` (hi signed, lo unsigned): its
    order is the lex order of ``(hi, lo)``."""
    return (hi.long() << 32) | _lo64(lo)


def _key_gt(a_key, a_node, b_key, b_node) -> torch.Tensor:
    """Strict lex ``(key, node)`` greater-than on int64 keys."""
    return (a_key > b_key) | ((a_key == b_key) & (a_node > b_node))


def _column_max(key, node, rows):
    """Per column, the strict lex ``(key, node)`` max over the entries
    where ``rows`` is set, the lowest row keeping ties: ``(key, node,
    row)``, ``row == -1`` where no entry is set."""
    r = key.shape[0]
    top = torch.where(rows, key, _I64_MIN).amax(0)
    cand = rows & (key == top)
    top_node = torch.where(cand, node, _I32_MIN).amax(0)
    cand = cand & (node == top_node)
    at = torch.arange(r, device=key.device)[:, None]
    row = torch.where(cand, at, r).amin(0)
    return top, top_node, torch.where(row < r, row, -1)


def probe_stream_noguard_closed_reference(store: SplitStore, cs,
                                          scalars: Sequence[int],
                                          n_chunks: int) -> Probe:
    """P1c in closed form over the chunks, the form
    ``csrc/probe_stream_noguard.cu`` computes; the tests hold it
    against the chunk walk `probe_stream_noguard_reference`.

    With more than one chunk, an entry whose ``hi`` is not NEG_HI
    (moving) has the 64-bit key ``hi:lo`` advanced by ``c << 16`` in
    chunk c; one whose ``hi`` is NEG_HI (static) never moves. Unless a
    moving key wraps (``hi == INT32_MAX`` and ``lo`` carries), the
    moving entries keep their order and rise every chunk, so the best
    after the last chunk is the first-reached max of the store slot,
    S (the static entries' max, reached in chunk 0) and M (the moving
    entries' max at chunk 0 advanced by the last offset, reached in the
    last chunk); an exact tie goes to the earlier visit. ``win`` is
    "the best is an entry"; the last chunk won iff M beats the max of
    the store and S. One chunk is P1a's join: every entry is counted
    with M and the offset is 0. A column holding a moving entry that
    wraps is walked chunk by chunk, as the kernel walks it."""
    _check_chunks(n_chunks)
    off = (n_chunks - 1) << SHIFT
    key = _key64(cs.hi, cs.lo)
    node = cs.node.to(torch.int32)
    moving = (cs.hi != NEG_HI) | (n_chunks == 1)
    wrap = (moving & (cs.hi == _I32_MAX) & (_lo64(cs.lo) + off > _U32)
            ).any(0)
    b_key, b_node = _key64(store.hi, store.lo), store.node
    b_row = torch.full_like(b_node, -1, dtype=torch.int64)
    s_key, s_node, s_row = _column_max(key, node, ~moving)
    gt = (s_row >= 0) & _key_gt(s_key, s_node, b_key, b_node)
    b_key, b_node = torch.where(gt, s_key, b_key), torch.where(gt, s_node,
                                                                b_node)
    b_row = torch.where(gt, s_row, b_row)
    m_key, m_node, m_row = _column_max(key, node, moving)
    m_key = m_key + off
    won = (m_row >= 0) & _key_gt(m_key, m_node, b_key, b_node)
    b_key, b_node = torch.where(won, m_key, b_key), torch.where(won, m_node,
                                                                 b_node)
    b_row = torch.where(won, m_row, b_row)
    win = b_row >= 0
    at = b_row.clamp(min=0)[None]
    pick = lambda lane: lane.gather(0, at)[0]
    best = (b_key >> 32).to(torch.int32), b_key & _U32, b_node, \
        torch.where(win, pick(cs.val_hi), store.val_hi), \
        torch.where(win, pick(_i32v(cs.val_lo)), _i32v(store.val_lo)), \
        torch.where(win, pick(cs.tomb).to(torch.int32), store.tomb)
    out = _finish(best, _stamp_mods(store, won, scalars),
                  win.to(torch.int32))
    if bool(wrap.any()):
        cols = torch.nonzero(wrap).reshape(-1)
        walked = probe_stream_noguard_reference(
            SplitStore(*(lane[cols] for lane in store)),
            type(cs)(*(lane[:, cols] for lane in cs)), scalars, n_chunks)
        for lane, part in zip(list(out[0]) + [out[1]],
                              list(walked[0]) + [walked[1]]):
            lane.view(torch.int32)[cols] = part.view(torch.int32)
    return out


def probe_copy_batch_reference(store: SplitStore, cs,
                               chunk_rows: int = CHUNK_ROWS) -> Probe:
    """P2: per group of ``chunk_rows`` rows, each lane's sum in its own
    wire type (``node`` an int16 sum that wraps, ``tomb`` an int32 sum
    of the int8 words); the store plus the groups' sums, ``node``
    widened per group. Narrow lanes add ``a_v >> 31`` to ``val_hi`` and
    ``a_v``'s bits to ``val_lo`` per group. Mod lanes copied; ``win``
    the last group's node sum, sign-extended."""
    narrow = isinstance(cs, NarrowSplitChangeset)
    _check_groups(cs.hi.shape[0], chunk_rows)
    hi, lo, node = store.hi, store.lo, store.node
    vhi, vlo, tomb = store.val_hi, store.val_lo, store.tomb
    for c0 in range(0, cs.hi.shape[0], chunk_rows):
        a_hi, a_lo, a_node = cs.hi[c0], cs.lo[c0], cs.node[c0]
        a_tomb = cs.tomb[c0].to(torch.int32)
        a_vhi = cs.val[c0] if narrow else cs.val_hi[c0]
        a_vlo = None if narrow else cs.val_lo[c0]
        for r in range(c0 + 1, c0 + chunk_rows):
            a_hi = a_hi + cs.hi[r]
            a_lo = _add_u32(a_lo, cs.lo[r])
            a_node = a_node + cs.node[r]
            a_tomb = a_tomb + cs.tomb[r].to(torch.int32)
            if narrow:
                a_vhi = a_vhi + cs.val[r]
            else:
                a_vhi = a_vhi + cs.val_hi[r]
                a_vlo = _add_u32(a_vlo, cs.val_lo[r])
        hi, lo = hi + a_hi, _add_u32(lo, a_lo)
        node = node + a_node.to(torch.int32)
        tomb = tomb + a_tomb
        if narrow:
            vhi = vhi + (a_vhi >> 31)
            vlo = _add_u32(vlo, a_vhi.view(torch.uint32))
        else:
            vhi, vlo = vhi + a_vhi, _add_u32(vlo, a_vlo)
    out = SplitStore(hi, lo, node, vhi, vlo, tomb, store.mod_hi.clone(),
                     store.mod_lo.clone(), store.mod_node.clone())
    return out, a_node.to(torch.int32)


# --- kernel wrappers ---------------------------------------------------


def _check_chunks(n_chunks: int) -> None:
    if not 0 < n_chunks < (1 << 15):     # c << 16 must fit int32
        raise ValueError(f"n_chunks={n_chunks} out of range [1, 2^15)")


def _check_groups(r: int, chunk_rows: int) -> None:
    if chunk_rows < 1 or r < chunk_rows or r % chunk_rows:
        raise ValueError(f"probe_copy_batch: {r} rows are not whole groups "
                         f"of chunk_rows={chunk_rows}")


def _check(kernel: str, store: SplitStore, cs) -> Tuple[int, int]:
    """Refuse what a probe kernel does not take; returns ``(r, n)``."""
    dev = store.hi.device
    n = store.hi.shape[0]
    r = cs.hi.shape[0]
    if r < 1:
        raise ValueError(f"{kernel}: the changeset needs at least one row")
    check_lanes(kernel, store._asdict(), SPLIT_STORE_DTYPES, (n,), dev)
    check_lanes(kernel, cs._asdict(), SPLIT_DTYPES, (r, n), dev)
    return r, n


_VP = ctypes.c_void_p


@functools.cache
def _launcher(name: str):
    args = {"probe_join": [ctypes.c_int] * 3,
            "probe_copy": [],
            "probe_stream_noguard": [ctypes.c_int] * 4,
            "probe_copy_batch": [ctypes.c_int] * 2}[name]
    return _build.load(name, f"crdt_{name}",
                       [ctypes.POINTER(_VP), ctypes.c_int64, ctypes.c_int]
                       + args + [_VP])


def _launch(name: str, store: SplitStore, cs, *args: int) -> Probe:
    """Allocate the ten outputs and launch ``csrc/<name>.cu`` on the
    current stream of the lanes' device."""
    r, n = _check(name, store, cs)
    out = SplitStore(*(torch.empty_like(lane) for lane in store))
    win = torch.empty_like(store.hi)
    lanes = [*store, *cs, *out, win]
    if isinstance(cs, NarrowSplitChangeset):
        lanes.insert(9 + 4, None)            # no val_lo lane
    dev = store.hi.device
    with torch.cuda.device(dev):
        rc = _launcher(name)(
            (_VP * len(lanes))(*(0 if x is None else x.data_ptr()
                                 for x in lanes)),
            n, r, *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _obs_device.note_launch(name)
    return out, win


def _scalar_args(scalars: Sequence[int]) -> Tuple[int, int, int]:
    if len(scalars) != 7:
        raise ValueError("probe scalars: expected 7 int32 words")
    return int(scalars[2]), int(scalars[5]), int(scalars[6])


def probe_join(store: SplitStore, cs, scalars: Sequence[int]) -> Probe:
    """P1a (see `probe_join_reference`): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not store.hi.is_cuda:
        return probe_join_reference(store, cs, scalars)
    return _launch("probe_join", store, cs, *_scalar_args(scalars))


def probe_copy(store: SplitStore, cs, scalars: Sequence[int]) -> Probe:
    """P1b (see `probe_copy_reference`)."""
    if not store.hi.is_cuda:
        return probe_copy_reference(store, cs, scalars)
    return _launch("probe_copy", store, cs)


def probe_stream_noguard(store: SplitStore, cs, scalars: Sequence[int],
                         n_chunks: int) -> Probe:
    """P1c (see `probe_stream_noguard_reference`)."""
    if not store.hi.is_cuda:
        return probe_stream_noguard_reference(store, cs, scalars, n_chunks)
    _check_chunks(n_chunks)
    return _launch("probe_stream_noguard", store, cs,
                   *_scalar_args(scalars), n_chunks)


def probe_copy_batch(store: SplitStore, cs,
                     chunk_rows: int = CHUNK_ROWS) -> Probe:
    """P2 (see `probe_copy_batch_reference`), wide or narrow lanes."""
    if not store.hi.is_cuda:
        return probe_copy_batch_reference(store, cs, chunk_rows)
    _check_groups(cs.hi.shape[0], chunk_rows)
    return _launch("probe_copy_batch", store, cs, chunk_rows,
                   int(isinstance(cs, NarrowSplitChangeset)))
