"""The stream replay on the card: kernel wrapper and plain version.

Port of `pallas_fanin_stream` / `pallas_fanin_step`
(``crdt_tpu/ops/pallas_merge.py:555-682``), the kernel behind
``bench.py``'s default mode: ONE ``[R, N]`` changeset merged
``n_chunks`` times, chunk ``c`` with every valid lt advanced by ``c``
ms (``c << 16``) and the canonical clock threaded through — the
steady-state write stream. Store lanes, ``win`` and ``new_canonical``
equal ``n_chunks`` sequential `ops.dense.fanin_step` folds; ``win`` is
the OR over chunks, and each winner's ``mod_lt`` is the canonical of
the last chunk it won.

``guards`` picks how the recv-guard flags are made (store lanes,
canonical and ``win`` are the same either way):

- ``"exact"``: column-local shielded guards in the kernel — per column
  a running max over its rows, reset every chunk to the chunk's seed
  (``canon0``, then the previous chunk's canonical). A superset of the
  r-major flags of a plain fold, so the plain version here does the
  same column-local pass and never calls `fanin_step`.
- ``"fast"``: no per-row guard work; closed-form superset flags from
  the changeset's max local-node lt and its basemax.

The TPU kernel took split lanes, ``n_slots % TILE == 0`` and a VMEM-
resident store block, and walked the rows once per chunk. The Hopper
kernel (``csrc/fanin_stream.cu``) takes the wide
`DenseStore`/`DenseChangeset` for any ``n_slots`` and R, and computes
the chunks in closed form: one pass over the changeset and one small
pass over the slots, whatever ``n_chunks``, in both guard modes; the
stamp, the canonical and the flags come out of the launch, with no
other device work. `fanin_stream` launches it for CUDA tensors and
takes `fanin_stream_reference`, the chunk walk, for CPU tensors;
`fanin_stream_closed_reference` renders the closed form in plain torch
for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple, Union

import torch

from .. import _build
from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from ..obs import device as _obs_device
from .dense import (CHANGESET_DTYPES, STORE_DTYPES, _NEG, DenseChangeset,
                    DenseStore, check_lanes, lex_fold, reduce_replicas)

Scalar = Union[int, torch.Tensor]


class StreamResult(NamedTuple):
    new_canonical: torch.Tensor  # int64 scalar after the last chunk
    win: torch.Tensor            # bool[N], adopted in some chunk
    any_dup: torch.Tensor        # bool
    any_drift: torch.Tensor      # bool


def _check_args(n_chunks: int, guards: str) -> None:
    if not 0 < n_chunks < (1 << 15):     # c << 16 must fit int32
        raise ValueError(f"n_chunks={n_chunks} out of range [1, 2^15)")
    if guards not in ("exact", "fast"):
        raise ValueError(f"unknown guards mode {guards!r}")


def _basemax(cs: DenseChangeset) -> torch.Tensor:
    masked = torch.where(cs.valid, cs.lt, _NEG)
    if masked.numel():
        return masked.amax()
    return torch.full((), _NEG, dtype=torch.int64, device=cs.lt.device)


def _max_local_lt(cs: DenseChangeset, local_node: int) -> torch.Tensor:
    """Max lt over the changeset's valid local-node records (the
    closed-form dup-candidate bound); ``_NEG`` when there are none."""
    return _basemax(cs._replace(valid=cs.valid & (cs.node == local_node)))


def _thresh(wall_millis: int) -> int:
    return ((wall_millis + MAX_DRIFT) << SHIFT) | MAX_COUNTER


def fanin_stream_reference(store: DenseStore, cs: DenseChangeset,
                           canonical_lt: Scalar, local_node: int,
                           wall_millis: int, *, n_chunks: int,
                           guards: str = "exact"
                           ) -> Tuple[DenseStore, StreamResult]:
    """Plain torch version of `fanin_stream`: the chunks folded one by
    one, with the column-local guard pass (a ``cummax`` over rows per
    chunk) in exact mode."""
    _check_args(n_chunks, guards)
    dev = store.lt.device
    canon0 = torch.as_tensor(canonical_lt, dtype=torch.int64, device=dev)
    basemax = _basemax(cs)
    thresh = _thresh(wall_millis)
    lt, node, val, tomb = (torch.where(store.occupied, store.lt, _NEG),
                           store.node, store.val, store.tomb)
    mod_lt, mod_node = store.mod_lt, store.mod_node
    win = torch.zeros_like(store.occupied)
    dup = drift = torch.zeros((), dtype=torch.bool, device=dev)
    seed = canon0
    for c in range(n_chunks):
        off = c << SHIFT
        nc = torch.maximum(canon0, basemax + off)
        cs_c = cs._replace(lt=cs.lt + off)
        if guards == "exact":
            masked = torch.where(cs.valid, cs_c.lt, _NEG)
            before = torch.cat([torch.full_like(masked[:1], _NEG),
                                torch.cummax(masked, 0).values[:-1]])
            slow = cs.valid & (cs_c.lt > torch.maximum(before, seed))
            d = slow & (cs.node == local_node)
            dup = dup | d.any()
            drift = drift | (slow & ~d & (cs_c.lt > thresh)).any()
        lt, node, val, tomb, won = lex_fold(cs_c, lt, node, val, tomb)
        mod_lt = mod_lt.masked_fill(won, nc)
        mod_node = mod_node.masked_fill(won, local_node)
        win = win | won
        seed = nc
    new_store = DenseStore(
        lt=torch.where(win, lt, store.lt), node=node, val=val,
        mod_lt=mod_lt, mod_node=mod_node, occupied=store.occupied | win,
        tomb=tomb)
    if guards == "fast":
        dup, drift = _fast_flags(cs, canon0, basemax, local_node,
                                 wall_millis, n_chunks)
    final = torch.maximum(canon0, basemax + ((n_chunks - 1) << SHIFT))
    return new_store, StreamResult(final, win, dup, drift)


def _fast_flags(cs, canon0, basemax, local_node, wall_millis, n_chunks):
    """Closed-form superset flags (`pallas_merge.py:653-666`). A chunk-c
    dup candidate is a local-node record above the threaded canonical
    nc_{c-1} = max(canon0, basemax + (c-1) << 16); with m_loc the max
    local-node lt, "some c" is the c = 0 test, plus for c >= 1 a
    c-independent bound against basemax and the last chunk's test
    against canon0. Drift is the last chunk's ceiling vs the wall."""
    final_off = (n_chunks - 1) << SHIFT
    m_loc = _max_local_lt(cs, local_node)
    dup = m_loc > canon0
    if n_chunks > 1:
        dup = dup | ((m_loc > basemax - (1 << SHIFT))
                     & (m_loc + final_off > canon0))
    return dup, basemax + final_off > _thresh(wall_millis)


_NONE = torch.iinfo(torch.int64).min


def fanin_stream_closed_reference(store: DenseStore, cs: DenseChangeset,
                                  canonical_lt: Scalar, local_node: int,
                                  wall_millis: int, *, n_chunks: int,
                                  guards: str = "exact"
                                  ) -> Tuple[DenseStore, StreamResult]:
    """Plain torch rendering of the closed form the kernel computes (the
    derivation is in ``csrc/fanin_stream.cu``): each column's winner
    found once and tested at the last chunk against the store, and the
    exact flags from the maxima of the local and the other prefix
    records. The tests hold it against `fanin_stream_reference`."""
    _check_args(n_chunks, guards)
    dev = store.lt.device
    canon0 = torch.as_tensor(canonical_lt, dtype=torch.int64, device=dev)
    basemax = _basemax(cs)
    off = (n_chunks - 1) << SHIFT
    final = torch.maximum(canon0, basemax + off)
    top, node, val, tomb, _ = reduce_replicas(cs)
    has = cs.valid.any(0)
    s_lt = torch.where(store.occupied, store.lt, _NEG)
    win = has & ((top + off > s_lt)
                 | ((top + off == s_lt) & (node > store.node)))
    new_store = DenseStore(
        lt=torch.where(win, top + off, store.lt),
        node=torch.where(win, node, store.node),
        val=torch.where(win, val, store.val),
        mod_lt=store.mod_lt.masked_fill(win, final),
        mod_node=store.mod_node.masked_fill(win, local_node),
        occupied=store.occupied | win,
        tomb=torch.where(win, tomb, store.tomb))
    if guards == "fast":
        dup, drift = _fast_flags(cs, canon0, basemax, local_node,
                                 wall_millis, n_chunks)
        return new_store, StreamResult(final, win, dup, drift)
    masked = torch.where(cs.valid, cs.lt, _NONE)
    before = torch.cat([torch.full_like(masked[:1], _NONE),
                        torch.cummax(masked, 0).values[:-1]])
    prefix = cs.valid & (cs.lt > before)
    is_local = cs.node == local_node
    thresh = _thresh(wall_millis)

    def any_slow(x: torch.Tensor, bound: int = _NONE) -> torch.Tensor:
        """Some chunk puts a prefix record of lt ``x`` on the slow path
        above ``bound`` (monotone in ``x``)."""
        slow = (x > canon0) & (x > bound)
        if n_chunks > 1:
            slow = slow | ((x > basemax - (1 << SHIFT)) & (x + off > canon0)
                           & (x + off > bound))
        return slow

    d = torch.where(prefix & is_local, cs.lt, _NONE)
    f = torch.where(prefix & ~is_local, cs.lt, _NONE)
    d, f = ((x.amax() if x.numel() else torch.tensor(_NONE, device=dev))
            for x in (d, f))
    dup = (d != _NONE) & any_slow(d)
    drift = (f != _NONE) & any_slow(f, thresh)
    return new_store, StreamResult(final, win, dup, drift)


_VP = ctypes.c_void_p


@functools.cache
def _launcher():
    return _build.load("fanin_stream", "crdt_fanin_stream",
                       [ctypes.POINTER(_VP), _VP, ctypes.POINTER(_VP), _VP,
                        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP])


def _fanin_stream_cuda(store: DenseStore, cs: DenseChangeset,
                       canonical_lt: Scalar, local_node: int,
                       wall_millis: int, *, n_chunks: int,
                       guards: str = "exact"
                       ) -> Tuple[DenseStore, StreamResult]:
    """Check the lanes, allocate the outputs and launch
    ``csrc/fanin_stream.cu``: its pass, its stamp and its flags, with
    no other device work and no host sync."""
    _check_args(n_chunks, guards)
    dev = store.lt.device
    n = store.n_slots
    check_lanes("fanin_stream", store._asdict(), STORE_DTYPES, (n,), dev)
    check_lanes("fanin_stream", cs._asdict(), CHANGESET_DTYPES,
                (cs.lt.shape[0], n), dev)
    canon0 = torch.as_tensor(canonical_lt, dtype=torch.int64, device=dev)
    if canon0.dim() != 0:
        raise ValueError("fanin_stream: canonical must be a scalar")
    out = DenseStore(*(torch.empty_like(lane) for lane in store))
    flag = functools.partial(torch.empty, (), dtype=torch.bool, device=dev)
    res = StreamResult(torch.empty((), dtype=torch.int64, device=dev),
                       torch.empty_like(store.occupied), flag(), flag())
    scratch = torch.empty(3, dtype=torch.int64, device=dev)
    launch_stream(store, cs, out, res, scratch, canon0, local_node,
                  _thresh(wall_millis), n_chunks, guards == "exact")
    return out, res


def launch_stream(store: DenseStore, cs: DenseChangeset, out: DenseStore,
                  res: StreamResult, scratch: torch.Tensor,
                  canon0: torch.Tensor, local_node: int, thresh: int,
                  n_chunks: int, exact: bool) -> None:
    """The kernels' launch alone, on the current stream: the pass into
    ``out`` and ``res.win``, the stamp of ``out.mod_lt`` and the scalars
    of ``res`` (all checked and allocated by the caller; ``scratch``
    holds three int64 words, zeroed by the launch)."""
    lanes = [store.lt, store.node, store.val, store.tomb, store.mod_lt,
             store.mod_node, store.occupied, *cs, out.lt, out.node, out.val,
             out.tomb, out.mod_lt, out.mod_node, out.occupied, res.win]
    scalars = (res.new_canonical, res.any_dup, res.any_drift)
    dev = store.lt.device
    with torch.cuda.device(dev):
        rc = _launcher()(
            (_VP * len(lanes))(*(x.data_ptr() for x in lanes)),
            scratch.data_ptr(), (_VP * 3)(*(x.data_ptr() for x in scalars)),
            canon0.data_ptr(), int(local_node), thresh, store.n_slots,
            cs.lt.shape[0], n_chunks, int(exact),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fanin_stream kernel launch failed: CUDA error "
                           f"{rc}")
    _obs_device.note_launch("fanin_stream")


def fanin_stream(store: DenseStore, cs: DenseChangeset,
                 canonical_lt: Scalar, local_node: int, wall_millis: int,
                 *, n_chunks: int, guards: str = "exact"
                 ) -> Tuple[DenseStore, StreamResult]:
    """``n_chunks`` replays of ``cs`` into a fresh copy of ``store`` in
    one call (see the module docstring): the hand kernel for CUDA
    tensors, the plain version for CPU tensors."""
    fn = _fanin_stream_cuda if store.lt.is_cuda else fanin_stream_reference
    return fn(store, cs, canonical_lt, local_node, wall_millis,
              n_chunks=n_chunks, guards=guards)


def fanin_step(store: DenseStore, cs: DenseChangeset, canonical_lt: Scalar,
               local_node: int, wall_millis: int
               ) -> Tuple[DenseStore, StreamResult]:
    """One merge with exact column-local guards: the ``n_chunks=1``
    case of `fanin_stream`."""
    return fanin_stream(store, cs, canonical_lt, local_node, wall_millis,
                        n_chunks=1)
