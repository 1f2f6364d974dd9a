"""The fan-in merge's tail: what ends a merge after its join.

`merge_tail` takes one merge's join (`fanin_kernel.FaninJoin`, from K1
or K1s) or a merge that its own step already stamped (`Stamped`: the
typed fold, the sharded model), and ends it:

- the stamp: the winners' ``modified`` lanes take the final canonical
  and the local ordinal (`fanin_kernel._stamp`);
- inside a ``pipelined()`` window, the window's step (`PipeState`: the
  recv flags, the value-ref overflow, the first flagged merge, the send
  bump with the merge's second wall read, the send flags) and the
  replica's lazy ``seen`` and adopted counts (`utils.stats.MergeStats`);
- outside a window, the lazy ``seen`` count and the four scalars the
  merge's one readback reads: ``[recv flags, adopted count, new
  canonical, value-ref overflow]``.

A join on CUDA lanes ends in ONE launch of the fan-in tail kernel (K1t,
``csrc/fanin_batch.cu``), counted as ``fanin_tail``, except in an exact
window, whose guard pass (`ops.merge.recv_guards`) stays eager. K1t
writes every scalar into a fresh int64 buffer of `WORDS` words (the
indices below); the window's state and the lazy counts become views of
it, so the next merge's K1t reads them where this one wrote them and
nothing is copied to the host. The plain version, `_stamp` then
`plain_step`, ends every other merge: CPU lanes, exact windows, stamped
merges.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from ..obs import device as _obs_device
from .dense import DenseStore
from .fanin_kernel import FaninJoin, flag_view
from .merge import recv_guards, send_step

# K1t's words (``csrc/fanin_batch.cu`` `Word`): the merge's own, then
# the window's, then two of scratch.
RECV, ADOPTED, NEW_CANONICAL, VAL_OVERFLOW, SEEN_SUM, ADOPTED_SUM = range(6)
CANONICAL, ANY_BAD, OVERFLOW, DRIFT, VAL_OVERFLOW_ALL, FIRST_FLAG = \
    range(6, 12)
WORDS = 14

GuardLanes = Callable[[], Tuple[torch.Tensor, ...]]


def _flag(name: str) -> property:
    """A window flag of `PipeState`, read and written through its views
    of the words K1t last wrote (`PipeState._unpack`)."""
    slot = "_" + name

    def get(self):
        self._unpack()
        return getattr(self, slot)

    def put(self, value):
        self._unpack()
        setattr(self, slot, value)

    return property(get, put)


class PipeState:
    """Device-resident clock state threaded across a pipelined window,
    and the window's bookkeeping of each merge: `absorb` takes in its
    result, `send_bump` ends it; or K1t does both, and `take` keeps its
    fresh words, in which the flags then live until an eager step or
    the fence reads them. Nothing leaves the device."""

    __slots__ = ("canonical", "_any_bad", "_overflow", "_drift",
                 "_val_overflow", "_first_flag_idx", "_words", "merges",
                 "exact", "value_width", "ex_have", "ex_dup", "ex_lt",
                 "ex_wall")

    any_bad = _flag("any_bad")
    overflow = _flag("overflow")
    drift = _flag("drift")
    val_overflow = _flag("val_overflow")
    first_flag_idx = _flag("first_flag_idx")

    def __init__(self, canonical_lt: int, device: torch.device,
                 exact: bool = False, value_width: int = 64):
        self._words = None
        self.canonical = torch.tensor(canonical_lt, dtype=torch.int64,
                                      device=device)
        false = torch.zeros((), dtype=torch.bool, device=device)
        zero = torch.zeros((), dtype=torch.int64, device=device)
        self.any_bad = self.overflow = self.drift = false
        self.val_overflow = false
        # Index (0-based, window order) of the first merge that set ANY
        # flag — the flush names it so a re-run can start there.
        self.first_flag_idx = torch.tensor(-1, dtype=torch.int32,
                                           device=device)
        self.merges = 0
        # Exact mode: the first offender's own fields, in sequential
        # visit order (one recv_guards pass per merge, seeded with the
        # threaded canonical). ex_wall is the OFFENDING merge's wall
        # read, so a payload never pairs one merge's record with
        # another's wall.
        self.exact = exact
        # Only a value_width=32 replica masks values out of a merge.
        self.value_width = value_width
        self.ex_have = self.ex_dup = false
        self.ex_lt = self.ex_wall = zero

    def _note(self, flags: torch.Tensor) -> None:
        """Attribute freshly raised flags to the merge in progress."""
        self.first_flag_idx = torch.where(
            (self.first_flag_idx < 0) & flags, self.merges,
            self.first_flag_idx)

    def absorb(self, res, val_overflow: torch.Tensor,
               guard_lanes: GuardLanes, local_node: int,
               wall: int) -> None:
        """Take in one merge's result ahead of its send bump: its recv
        flags (the kernel's superset flags, or in an exact window one
        guard pass over ``guard_lanes()``'s ``(lt, node, valid)``,
        seeded with the threaded canonical and the merge's ``wall``),
        its value-ref overflow, and its merged canonical."""
        if self.exact:
            g_lt, g_node, g_valid = guard_lanes()
            recv, first_bad, first_is_dup, _ = recv_guards(
                g_lt, g_node, g_valid, self.canonical, local_node, wall)
            newly = ~self.ex_have & recv
            self.ex_dup = torch.where(newly, first_is_dup, self.ex_dup)
            self.ex_lt = torch.where(newly, g_lt.reshape(-1)[first_bad],
                                     self.ex_lt)
            self.ex_wall = torch.where(newly, wall, self.ex_wall)
            self.ex_have = self.ex_have | recv
        else:
            recv = res.any_dup | res.any_drift
        flags = recv
        if self.value_width == 32:
            self.val_overflow = self.val_overflow | val_overflow
            flags = flags | val_overflow
        self._note(flags)
        self.any_bad = self.any_bad | recv
        self.canonical = res.new_canonical

    def send_bump(self, wall: int) -> None:
        """End the merge in progress (a merge of nothing has only this):
        the final crdt.dart:93 send bump, its flags accumulated for the
        flush."""
        self.canonical, overflow, drift = send_step(self.canonical, wall)
        self._note(overflow | drift)
        self.overflow = self.overflow | overflow
        self.drift = self.drift | drift
        self.merges += 1

    def take(self, words: torch.Tensor) -> None:
        """End the merge in progress with the step K1t ran into the
        fresh ``words``: the clock becomes a view of them, and the flags
        live in them."""
        self._words = words
        self.canonical = words[CANONICAL]
        self.merges += 1

    def flag_ptrs(self) -> Tuple[int, ...]:
        """The addresses K1t reads the flags at: ``any_bad``,
        ``overflow``, ``drift``, ``val_overflow`` (bools) and
        ``first_flag_idx`` (an int32); in the words K1t last wrote, the
        low byte or low half of each word."""
        if self._words is None:
            return tuple(t.data_ptr() for t in (
                self._any_bad, self._overflow, self._drift,
                self._val_overflow, self._first_flag_idx))
        base = self._words.data_ptr()
        return tuple(base + 8 * w for w in (ANY_BAD, OVERFLOW, DRIFT,
                                            VAL_OVERFLOW_ALL, FIRST_FLAG))

    def _unpack(self) -> None:
        """Give each flag a tensor of its own again, views of the words
        K1t last wrote, for an eager step or the fence."""
        words, self._words = self._words, None
        if words is None:
            return
        flags = flag_view(words)
        self._any_bad, self._overflow, self._drift, self._val_overflow = (
            flags[w] for w in (ANY_BAD, OVERFLOW, DRIFT, VAL_OVERFLOW_ALL))
        self._first_flag_idx = words.view(torch.int32)[2 * FIRST_FLAG]


class Stamped(NamedTuple):
    """A merge its own step already stamped (the typed fold, the
    sharded model): ``(new_store, result, seen, val_overflow)``."""
    new_store: object
    res: object
    seen: torch.Tensor
    val_overflow: Optional[torch.Tensor]


def plain_step(res, seen: torch.Tensor,
               val_overflow: Optional[torch.Tensor], local_node: int,
               wall: int, pipe: Optional[PipeState], stats,
               send_wall: Callable[[], int], guard_lanes: GuardLanes
               ) -> Optional[torch.Tensor]:
    """A stamped merge's step in eager ops: in a window the window's
    step and the lazy counts (returns None), else the lazy ``seen``
    count and the readback's four scalars."""
    stats.add_seen_lazy(seen)
    if pipe is not None:
        pipe.absorb(res, val_overflow, guard_lanes, local_node, wall)
        pipe.send_bump(send_wall())
        stats.add_adopted_lazy(res.win.sum())
        return None
    if val_overflow is None:
        val_overflow = torch.zeros_like(res.any_dup)
    return torch.stack([(res.any_dup | res.any_drift).long(),
                        res.win.sum(), res.new_canonical,
                        val_overflow.long()])


def _takes_kernel(j: FaninJoin, pipe: Optional[PipeState]) -> bool:
    """K1t ends a join on CUDA lanes, outside an exact window."""
    return j.store.lt.is_cuda and (pipe is None or not pipe.exact)


def merge_tail(merged, local_node: int, wall: int,
               pipe: Optional[PipeState], stats,
               send_wall: Callable[[], int], guard_lanes: GuardLanes):
    """End one merge (see the module docstring): ``(new_store, win,
    scalars)``, ``scalars`` an int64 vector whose first four entries
    are the readback's outside a window. ``send_wall`` is the merge's
    second wall read, taken only inside a window."""
    if isinstance(merged, FaninJoin):
        if _takes_kernel(merged, pipe):
            return fanin_tail(merged, local_node, wall, pipe, stats,
                              send_wall)
        merged = Stamped(*merged.stamp(local_node, wall), merged.seen,
                         merged.val_overflow)
    return merged.new_store, merged.res.win, plain_step(
        merged.res, merged.seen, merged.val_overflow, local_node, wall,
        pipe, stats, send_wall, guard_lanes)


_VP = ctypes.c_void_p


@functools.cache
def _launcher():
    return _build.load("fanin_batch", "crdt_fanin_tail",
                       [ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_int64),
                        _VP])


def _launch(ptrs, dims, dev: torch.device) -> None:
    """One K1t launch on ``dev``'s current stream."""
    with torch.cuda.device(dev):
        rc = _launcher()((_VP * len(ptrs))(*ptrs),
                         (ctypes.c_int64 * len(dims))(*dims),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fanin_tail kernel launch failed: CUDA error "
                           f"{rc}")
    _obs_device.note_launch("fanin_tail")


def _ptr(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.data_ptr()


def fanin_tail(j: FaninJoin, local_node: int, wall: int,
               pipe: Optional[PipeState], stats,
               send_wall: Callable[[], int]):
    """`merge_tail` of a join on CUDA lanes, in one K1t launch."""
    store = j.store
    dev = store.lt.device
    mod_lt = torch.empty_like(store.mod_lt)
    mod_node = torch.empty_like(store.mod_node)
    words = torch.empty(WORDS, dtype=torch.int64, device=dev)
    lt, node, val, tomb, occupied, win, basemax, any_dup = j.outs
    seen_sum, adopted_sum = stats.device_pending(dev)
    if pipe is None:
        # Outside a window the adopted count goes to the host with the
        # readback, once the guards let the merge land.
        adopted_sum, flags, send, idx = None, (0,) * 5, 0, 0
    else:
        flags, send, idx = pipe.flag_ptrs(), send_wall(), pipe.merges
    thresh = ((wall + MAX_DRIFT) << SHIFT) | MAX_COUNTER
    _launch([*(_ptr(x) for x in (
        store.mod_lt, store.mod_node, win, mod_lt, mod_node, j.canonical,
        basemax, any_dup, j.seen, j.val_overflow, seen_sum, adopted_sum)),
        *flags, words.data_ptr()],
        (store.n_slots, thresh, send, idx, local_node, int(pipe is not None)),
        dev)
    if pipe is None:
        stats.carry(words[SEEN_SUM])
    else:
        stats.carry(words[SEEN_SUM], words[ADOPTED_SUM])
        pipe.take(words)
    new_store = DenseStore(lt=lt, node=node, val=val, mod_lt=mod_lt,
                           mod_node=mod_node, occupied=occupied, tomb=tomb)
    return new_store, win, words
