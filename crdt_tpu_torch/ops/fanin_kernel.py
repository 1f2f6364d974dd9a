"""The batch fan-in merge on the card: kernel wrapper, plain version,
and the model layer's merge step built on them.

Port of the batch entry of ``crdt_tpu/ops/pallas_merge.py``
(`pallas_fanin_batch`, `model_fanin_batch`). The TPU kernel carried its
lanes split into hi/lo int32 words, narrowed node/tomb wire lanes,
padded to 4096-slot tiles and walked rows in ``chunk_rows`` grid steps
with VMEM-resident accumulators; none of that carries over. The Hopper
kernel (``csrc/fanin_batch.cu``) reads the int64/int32/bool lanes as
they are, for any ``n_slots`` and any R.

Contract of `fanin_batch` (that of `pallas_fanin_batch`): store lanes,
``win`` and ``new_canonical`` equal ONE `ops.dense.fanin_step` of the
whole batch bit for bit; the guard flags are the closed-form SUPERSET
flags — ``any_dup``: some valid local-node record above the pre-merge
canonical; ``any_drift``: ``basemax`` past the drift threshold. The
model layer recomputes the exact guards when one trips.

The pre-split entry (K1s: `fanin_split`, `model_fanin_split`;
``csrc/fanin_split.cu``) is the same merge fed the JAX peers' split
wire lanes (`ops.split`) as they arrive, with the ``node_map`` remap and
the value-width masking in the kernel: the port of
`_model_fanin_split_jit`. It never widens the lanes in memory first.

A step here ends at the merge itself (mask, join, stamp): a
``pipelined()`` window's flags, first flagged merge and send bump are
the model's (`models.dense_crdt._PipeState`).

The sharded step (K1p, `parallel.fanin`) runs the same kernel on every
mesh position's block, a column block of the changeset read in place
through its row stride: one launch per device over all of its blocks
(`fanin_cuda_many`), counted as ``fanin_batch_sharded``.

Each wrapper takes the kernel for CUDA tensors and its plain version
(`fanin_join_reference`, `fanin_split_join_reference`) for CPU
tensors, and never falls back from one to the other.

The batch entry's stages are spans (`obs.trace.span`, live only while
the tracer is on or a profiler records): ``crdt_tpu_torch.fanin.mask``
(`mask_value_width`), ``crdt_tpu_torch.fanin.join`` (the join: the
kernel's checks, allocations and launch, or the plain version) and
``crdt_tpu_torch.fanin.stamp`` (`_stamp`; a ``pipelined()`` window
opens it again around its own step and send bump).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

from .. import _build
from ..hlc import MAX_COUNTER, MAX_DRIFT, SHIFT
from ..obs import device as _obs_device
from ..obs.trace import span
from .dense import (CHANGESET_DTYPES, STORE_DTYPES, _NEG, DenseChangeset,
                    DenseStore, check_lanes, check_rows, reduce_replicas)
from .split import (I16_NEG, NEG_HI, SPLIT_DTYPES, NarrowSplitChangeset,
                    flat_lanes, join64)

_obs_device.register("pallas.model_fanin_batch", "pallas.model_fanin_split")

Scalar = Union[int, torch.Tensor]
Join = Tuple[torch.Tensor, ...]

MASK_SPAN = "crdt_tpu_torch.fanin.mask"
JOIN_SPAN = "crdt_tpu_torch.fanin.join"
STAMP_SPAN = "crdt_tpu_torch.fanin.stamp"


class BatchResult(NamedTuple):
    new_canonical: torch.Tensor  # int64 scalar (pre final-send-bump)
    win: torch.Tensor            # bool[N] adopted mask
    basemax: torch.Tensor        # int64 max valid lt (_NEG when none)
    any_dup: torch.Tensor        # bool superset duplicate-node flag
    any_drift: torch.Tensor      # bool superset drift flag


def fanin_join_reference(store: DenseStore, cs: DenseChangeset,
                         canonical: torch.Tensor, local_node: int) -> Join:
    """Plain torch version of the kernel's own outputs: ``(lt, node,
    val, tomb, occupied, win, basemax, any_dup, seen)``, ``seen`` the
    valid records. The rows reduce among themselves (lowest row keeps
    ties), then the winner meets the local slot strictly (local keeps
    ties)."""
    b_lt, b_node, b_val, b_tomb, _ = reduce_replicas(cs)
    s_lt = torch.where(store.occupied, store.lt, _NEG)
    win = (b_lt > s_lt) | ((b_lt == s_lt) & (b_node > store.node))
    masked = torch.where(cs.valid, cs.lt, _NEG)
    basemax = (masked.amax() if masked.numel()
               else torch.full((), _NEG, dtype=torch.int64,
                               device=cs.lt.device))
    any_dup = (cs.valid & (cs.node == local_node)
               & (cs.lt > canonical)).any()
    return (torch.where(win, b_lt, store.lt),
            torch.where(win, b_node, store.node),
            torch.where(win, b_val, store.val),
            torch.where(win, b_tomb, store.tomb),
            store.occupied | win, win, basemax, any_dup, cs.valid.sum())


_VP = ctypes.c_void_p


@functools.cache
def _launcher():
    return _build.load("fanin_batch", "crdt_fanin_batch",
                       [ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, _VP, ctypes.c_int, _VP])


MAX_ENTRIES = 16     # merges per launch: the kernel's parameter table


def fanin_cuda_many(stores: Sequence[DenseStore],
                    css: Sequence[DenseChangeset], canonical: torch.Tensor,
                    local_node: int, count_as: str = "fanin_batch"
                    ) -> List[Join]:
    """The kernel's own outputs (`fanin_join_reference`'s tuple) for
    several merges on one device: one launch per `MAX_ENTRIES` merges,
    each counted under ``count_as``. A changeset may be a key shard's
    column block of wider lanes (contiguous rows at one row stride),
    read in place. Each call fills fresh scalars: a caller may keep a
    merge's ``seen`` unread past the next call."""
    dev = canonical.device
    if canonical.dtype != torch.int64 or canonical.dim() != 0:
        raise ValueError("fanin_batch: canonical must be an int64 scalar "
                         f"tensor on {dev}")
    m = len(stores)
    basemax = torch.full((m,), _NEG, dtype=torch.int64, device=dev)
    dup, seen = torch.zeros((2, m), dtype=torch.int64, device=dev)
    outs, todo = [], []
    for j, (store, cs) in enumerate(zip(stores, css)):
        n = store.n_slots
        r = cs.lt.shape[0]
        check_lanes("fanin_batch", store._asdict(), STORE_DTYPES, (n,), dev)
        ld = check_rows("fanin_batch", cs._asdict(), CHANGESET_DTYPES,
                        (r, n), dev)
        out = [torch.empty_like(store.lt), torch.empty_like(store.node),
               torch.empty_like(store.val), torch.empty_like(store.tomb),
               torch.empty_like(store.occupied),
               torch.empty_like(store.occupied)]
        outs.append(out)
        if n:
            todo.append(([store.lt, store.node, store.val, store.tomb,
                          store.occupied, *cs, *out, basemax[j], dup[j],
                          seen[j]],
                         (n, r, ld)))
    # The launch goes to the current device: make it the lanes' one.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g in range(0, len(todo), MAX_ENTRIES):
            group = todo[g:g + MAX_ENTRIES]
            lanes = [x.data_ptr() for ptrs, _ in group for x in ptrs]
            dims = [d for _, ds in group for d in ds]
            rc = _launcher()(
                (_VP * len(lanes))(*lanes),
                (ctypes.c_int64 * len(dims))(*dims), len(group),
                canonical.data_ptr(), int(local_node), stream)
            if rc:
                raise RuntimeError(f"fanin_batch kernel launch failed: "
                                   f"CUDA error {rc}")
            _obs_device.note_launch(count_as)
    any_dup = dup != 0
    return [(*out, basemax[j], any_dup[j], seen[j])
            for j, out in enumerate(outs)]


def _stamp(store: DenseStore, outs: Join, canonical: torch.Tensor,
           local_node: int, wall_millis: int
           ) -> Tuple[DenseStore, BatchResult]:
    """Post-pass (outside the kernel on the TPU too): the union-final
    canonical comes from the kernel's own basemax, and only then can the
    winners' modified lanes be stamped. The stamp is a select on the
    device: a fill with the 0-dim ``new_canonical`` would read it back
    to the host (torch's CUDA ``masked_fill`` takes its value as a host
    scalar), a sync a pipelined window promises not to make."""
    lt, node, val, tomb, occupied, win, basemax, any_dup = outs
    new_canonical = torch.maximum(canonical, basemax)
    thresh = ((wall_millis + MAX_DRIFT) << SHIFT) | MAX_COUNTER
    new_store = DenseStore(
        lt=lt, node=node, val=val,
        mod_lt=torch.where(win, new_canonical, store.mod_lt),
        mod_node=torch.where(win, local_node, store.mod_node),
        occupied=occupied, tomb=tomb)
    return new_store, BatchResult(new_canonical, win, basemax, any_dup,
                                  basemax > thresh)


def _join(store: DenseStore, cs: DenseChangeset, canonical_lt: Scalar,
          local_node: int, plain: bool) -> Tuple[torch.Tensor, Join]:
    """The canonical as a device scalar and the join's own outputs."""
    canonical = torch.as_tensor(canonical_lt, dtype=torch.int64,
                                device=store.lt.device)
    with span(JOIN_SPAN):
        if plain:
            outs = fanin_join_reference(store, cs, canonical, local_node)
        else:
            outs = fanin_cuda_many([store], [cs], canonical,
                                   local_node)[0]
    return canonical, outs


def _fanin(store: DenseStore, cs: DenseChangeset, canonical_lt: Scalar,
           local_node: int, wall_millis: int, plain: bool):
    """The join and `_stamp`: ``(new_store, BatchResult, seen)``."""
    canonical, (*outs, seen) = _join(store, cs, canonical_lt, local_node,
                                     plain)
    with span(STAMP_SPAN):
        new_store, res = _stamp(store, outs, canonical, local_node,
                                wall_millis)
    return new_store, res, seen


def fanin_batch(store: DenseStore, cs: DenseChangeset,
                canonical_lt: Scalar, local_node: int, wall_millis: int
                ) -> Tuple[DenseStore, BatchResult]:
    """ONE logical merge of ``cs`` into a fresh copy of ``store``: the
    hand kernel for CUDA tensors, the plain version for CPU tensors.
    See the module docstring for the contract."""
    return _fanin(store, cs, canonical_lt, local_node, wall_millis,
                  plain=not store.lt.is_cuda)[:2]


def fanin_batch_reference(store: DenseStore, cs: DenseChangeset,
                          canonical_lt: Scalar, local_node: int,
                          wall_millis: int
                          ) -> Tuple[DenseStore, BatchResult]:
    """`fanin_batch` through the plain version on any device — what the
    kernel is held against on the card."""
    return _fanin(store, cs, canonical_lt, local_node, wall_millis,
                  plain=True)[:2]


def _ledger_name(store: DenseStore, pallas_name: str) -> str:
    """The ledger name of one model-level merge: the Pallas entry the
    hand kernel replaces for CUDA lanes, the XLA fold's
    (``dense.fanin_step``) for the plain route."""
    return pallas_name if store.lt.is_cuda else "dense.fanin_step"


def mask_value_width(cs: DenseChangeset, value_width: int):
    """The model layer's checks ahead of a merge: with ``value_width=32``
    records whose value does not fit int32 are masked INVALID, never
    truncated, and ``val_overflow`` says so. Returns ``(cs,
    val_overflow)``."""
    with span(MASK_SPAN):
        if value_width == 32:
            fits = (cs.val >= -(2 ** 31)) & (cs.val < 2 ** 31)
            val_overflow = (cs.valid & ~fits).any()
            cs = cs._replace(valid=cs.valid & fits)
        else:
            val_overflow = torch.zeros((), dtype=torch.bool,
                                       device=cs.valid.device)
        return cs, val_overflow


def model_fanin_batch(store: DenseStore, cs: DenseChangeset,
                      canonical_lt: Scalar, local_node: int,
                      wall_millis: int, *, value_width: int = 64):
    """The model layer's merge step: `mask_value_width` and
    `fanin_batch`. Returns ``(new_store, BatchResult, seen,
    val_overflow)``, ``seen`` the join's count of the valid records
    left after the masking."""
    with _obs_device.record(_ledger_name(store, "pallas.model_fanin_batch"),
                            dim=cs.valid.shape[0]):
        cs, val_overflow = mask_value_width(cs, value_width)
        return (*_fanin(store, cs, canonical_lt, local_node, wall_millis,
                        plain=not store.lt.is_cuda), val_overflow)


# --- K1s: the pre-split entry, fed the JAX peers' wire lanes ----------


def fanin_split_join_reference(store: DenseStore, scs,
                               node_map: torch.Tensor,
                               canonical: torch.Tensor, local_node: int,
                               check_fit: bool) -> Join:
    """Plain torch version of the split kernel's own outputs: ``(lt,
    node, val, tomb, occupied, win, basemax, any_dup, seen,
    val_overflow)`` for ``[R, N]`` split lanes and an int32
    ``node_map``. Every entry takes part as its key arrives; invalid
    entries carry the sentinel key, which loses to everything real."""
    dev = store.lt.device
    hi, lo, nd = scs.hi.long(), scs.lo.long(), scs.node.long()
    node = torch.where(nd == I16_NEG, I16_NEG, node_map.long()[
        nd.clamp(0, node_map.shape[0] - 1)])
    if isinstance(scs, NarrowSplitChangeset):
        val = scs.val.long()
    else:
        val = join64(scs.val_hi, scs.val_lo)
    val_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if check_fit:
        # value_width=32 taking wide lanes: val_hi must be the sign fill
        # of val_lo, else the entry is masked on all three key lanes (a
        # half-masked hi = NEG_HI with lo != 0 would beat an empty slot).
        vlo = scs.val_lo.long()
        fits = scs.val_hi.long() == torch.where(vlo >= 2 ** 31, -1, 0)
        val_overflow = ((hi != NEG_HI) & ~fits).any()
        hi = torch.where(fits, hi, NEG_HI)
        lo = torch.where(fits, lo, 0)
        node = torch.where(fits, node, I16_NEG)
    lt = (hi << 32) | lo
    node = node.to(torch.int32)
    b_lt = torch.where(store.occupied, store.lt, _NEG)
    b_node, b_val, b_tomb = store.node, store.val, store.tomb
    win = torch.zeros_like(store.occupied)
    for r in range(lt.shape[0]):
        better = (lt[r] > b_lt) | ((lt[r] == b_lt) & (node[r] > b_node))
        b_lt = torch.where(better, lt[r], b_lt)
        b_node = torch.where(better, node[r], b_node)
        b_val = torch.where(better, val[r], b_val)
        b_tomb = torch.where(better, scs.tomb[r] != 0, b_tomb)
        win = win | better
    neg = torch.full((), _NEG, dtype=torch.int64, device=dev)
    basemax = torch.maximum(lt.amax(), neg) if lt.numel() else neg
    any_dup = ((node == local_node) & (lt > canonical)).any()
    # A winning malformed sentinel (hi = NEG_HI, lo != 0) lands as the
    # Pallas kernel's split-store round trip lands it: unoccupied, lt 0.
    real = (b_lt >> 32) != NEG_HI
    return (torch.where(win, torch.where(real, b_lt, 0), store.lt),
            torch.where(win, b_node, store.node), b_val, b_tomb,
            torch.where(win, real, store.occupied), win, basemax, any_dup,
            (hi != NEG_HI).sum(), val_overflow)


@functools.cache
def _split_launcher():
    return _build.load("fanin_split", "crdt_fanin_split",
                       [ctypes.POINTER(_VP), _VP, ctypes.c_int, _VP,
                        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int, _VP])


MAX_MAP_LEN = 1 << 15   # peer ordinals are int16: no index reaches past


def _fanin_split_cuda(store: DenseStore, scs, node_map: torch.Tensor,
                      canonical: torch.Tensor, local_node: int,
                      check_fit: bool) -> Join:
    """Launch ``csrc/fanin_split.cu`` on the current stream."""
    dev = store.lt.device
    n = store.n_slots
    r = scs.hi.shape[0]
    check_lanes("fanin_split", store._asdict(), STORE_DTYPES, (n,), dev)
    check_lanes("fanin_split", scs._asdict(), SPLIT_DTYPES, (r, n), dev)
    if node_map.device != dev or node_map.dtype != torch.int32 \
            or node_map.dim() != 1 or not node_map.is_contiguous() \
            or not 1 <= node_map.shape[0] <= MAX_MAP_LEN:
        raise ValueError(f"fanin_split: node_map must be a contiguous "
                         f"int32 vector of 1..{MAX_MAP_LEN} entries on "
                         f"{dev}")
    if canonical.device != dev or canonical.dtype != torch.int64 \
            or canonical.dim() != 0:
        raise ValueError("fanin_split: canonical must be an int64 scalar "
                         f"tensor on {dev}")
    narrow = isinstance(scs, NarrowSplitChangeset)
    out = [torch.empty_like(store.lt), torch.empty_like(store.node),
           torch.empty_like(store.val), torch.empty_like(store.tomb),
           torch.empty_like(store.occupied),
           torch.empty_like(store.occupied)]
    basemax = torch.full((), _NEG, dtype=torch.int64, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    seen = torch.zeros((), dtype=torch.int64, device=dev)
    if n:
        lanes = [store.lt, store.node, store.val, store.tomb,
                 store.occupied, scs.hi, scs.lo, scs.node,
                 scs.val if narrow else scs.val_hi,
                 None if narrow else scs.val_lo, scs.tomb, *out, basemax,
                 flags, seen]
        ptrs = (_VP * len(lanes))(*(0 if x is None else x.data_ptr()
                                    for x in lanes))
        with torch.cuda.device(dev):
            rc = _split_launcher()(
                ptrs, node_map.data_ptr(), node_map.shape[0],
                canonical.data_ptr(), int(local_node), n, r, int(narrow),
                int(check_fit), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"fanin_split kernel launch failed: CUDA "
                               f"error {rc}")
        _obs_device.note_launch("fanin_split")
    return (*out, basemax, flags[0] != 0, seen, flags[1] != 0)


def _fanin_split(join, store: DenseStore, scs, node_map: torch.Tensor,
                 canonical_lt: Scalar, local_node: int, wall_millis: int,
                 value_width: int):
    canonical = torch.as_tensor(canonical_lt, dtype=torch.int64,
                                device=store.lt.device)
    check_fit = value_width == 32 \
        and not isinstance(scs, NarrowSplitChangeset)
    *outs, seen, val_overflow = join(store, flat_lanes(scs), node_map,
                                     canonical, local_node, check_fit)
    new_store, res = _stamp(store, tuple(outs), canonical, local_node,
                            wall_millis)
    return new_store, res, seen, val_overflow


def fanin_split(store: DenseStore, scs, node_map: torch.Tensor,
                canonical_lt: Scalar, local_node: int, wall_millis: int, *,
                value_width: int = 64):
    """ONE logical merge of split wire lanes (2-D or tiled) into a
    fresh copy of ``store``: the hand kernel for CUDA tensors, the plain
    version for CPU tensors. ``node_map`` (int32) rewrites the peer's
    ordinals. Returns ``(new_store, BatchResult, seen, val_overflow)``;
    the flags are K1's superset flags."""
    join = _fanin_split_cuda if store.lt.is_cuda \
        else fanin_split_join_reference
    return _fanin_split(join, store, scs, node_map, canonical_lt,
                        local_node, wall_millis, value_width)


def fanin_split_reference(store: DenseStore, scs, node_map: torch.Tensor,
                          canonical_lt: Scalar, local_node: int,
                          wall_millis: int, *, value_width: int = 64):
    """`fanin_split` through the plain version on any device — what the
    kernel is held against on the card."""
    return _fanin_split(fanin_split_join_reference, store, scs, node_map,
                        canonical_lt, local_node, wall_millis, value_width)


def model_fanin_split(store: DenseStore, scs, node_map,
                      canonical_lt: Scalar, local_node: int,
                      wall_millis: int, *, value_width: int = 64):
    """The model layer's merge of a PRE-SPLIT changeset (2-D or tiled
    lanes, wide or narrow; `ops.split`): what `merge_split` runs. A
    value_width=32 replica taking WIDE lanes masks entries whose payload
    does not fit int32 (invalid, never truncated) and flags
    ``val_overflow``; narrow lanes fit by construction. Returns
    ``(new_store, BatchResult, seen, val_overflow)``."""
    with _obs_device.record(_ledger_name(store, "pallas.model_fanin_split"),
                            dim=scs.hi.shape[0]):
        node_map = torch.as_tensor(node_map).to(
            store.lt.device, torch.int32)[:MAX_MAP_LEN].contiguous()
        return fanin_split(store, scs, node_map, canonical_lt, local_node,
                           wall_millis, value_width=value_width)

