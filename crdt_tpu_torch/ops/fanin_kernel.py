"""The batch fan-in merge on the card: kernel wrapper, plain version,
and the model-layer steps built on them.

Port of the batch entry of ``crdt_tpu/ops/pallas_merge.py``
(`pallas_fanin_batch`, `model_fanin_batch`, `pipelined_model_step`).
The TPU kernel carried its lanes split into hi/lo int32 words, narrowed
node/tomb wire lanes, padded to 4096-slot tiles and walked rows in
``chunk_rows`` grid steps with VMEM-resident accumulators; none of that
carries over. The Hopper kernel (``csrc/fanin_batch.cu``) reads the
int64/int32/bool lanes as they are, for any ``n_slots`` and any R.

Contract of `fanin_batch` (that of `pallas_fanin_batch`): store lanes,
``win`` and ``new_canonical`` equal ONE `ops.dense.fanin_step` of the
whole batch bit for bit; the guard flags are the closed-form SUPERSET
flags — ``any_dup``: some valid local-node record above the pre-merge
canonical; ``any_drift``: ``basemax`` past the drift threshold. The
model layer recomputes the exact guards when one trips.

The wrapper takes the kernel for CUDA tensors and the plain version
(`fanin_join_reference`) for CPU tensors, and never falls back from
one to the other.
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
                    DenseStore, check_lanes, reduce_replicas)
from .merge import send_step

Scalar = Union[int, torch.Tensor]
Join = Tuple[torch.Tensor, ...]


class BatchResult(NamedTuple):
    new_canonical: torch.Tensor  # int64 scalar (pre final-send-bump)
    win: torch.Tensor            # bool[N] adopted mask
    basemax: torch.Tensor        # int64 max valid lt (_NEG when none)
    any_dup: torch.Tensor        # bool superset duplicate-node flag
    any_drift: torch.Tensor      # bool superset drift flag


def fanin_join_reference(store: DenseStore, cs: DenseChangeset,
                         canonical: torch.Tensor, local_node: int) -> Join:
    """Plain torch version of the kernel's own outputs: ``(lt, node,
    val, tomb, occupied, win, basemax, any_dup)``. The rows reduce
    among themselves (lowest row keeps ties), then the winner meets the
    local slot strictly (local keeps ties)."""
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
            store.occupied | win, win, basemax, any_dup)


_VP = ctypes.c_void_p


@functools.cache
def _launcher():
    return _build.load("fanin_batch", "crdt_fanin_batch",
                       [_VP] * 19 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int64, _VP])


def _fanin_cuda(store: DenseStore, cs: DenseChangeset,
                canonical: torch.Tensor, local_node: int) -> Join:
    """Launch ``csrc/fanin_batch.cu`` on the current stream."""
    dev = store.lt.device
    n = store.n_slots
    r = cs.lt.shape[0]
    check_lanes("fanin_batch", store._asdict(), STORE_DTYPES, (n,), dev)
    check_lanes("fanin_batch", cs._asdict(), CHANGESET_DTYPES, (r, n), dev)
    if canonical.device != dev or canonical.dtype != torch.int64 \
            or canonical.dim() != 0:
        raise ValueError("fanin_batch: canonical must be an int64 scalar "
                         f"tensor on {dev}")
    out = [torch.empty_like(store.lt), torch.empty_like(store.node),
           torch.empty_like(store.val), torch.empty_like(store.tomb),
           torch.empty_like(store.occupied),
           torch.empty_like(store.occupied)]
    basemax = torch.full((), _NEG, dtype=torch.int64, device=dev)
    dup = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        rc = _launcher()(
            store.lt.data_ptr(), store.node.data_ptr(),
            store.val.data_ptr(), store.tomb.data_ptr(),
            store.occupied.data_ptr(),
            *(lane.data_ptr() for lane in cs),
            *(o.data_ptr() for o in out),
            basemax.data_ptr(), dup.data_ptr(), canonical.data_ptr(),
            int(local_node), n, r,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"fanin_batch kernel launch failed: CUDA "
                               f"error {rc}")
        _obs_device.note_launch("fanin_batch")
    return (*out, basemax, dup != 0)


def _fanin(join, store: DenseStore, cs: DenseChangeset,
           canonical_lt: Scalar, local_node: int, wall_millis: int
           ) -> Tuple[DenseStore, BatchResult]:
    canonical = torch.as_tensor(canonical_lt, dtype=torch.int64,
                                device=store.lt.device)
    lt, node, val, tomb, occupied, win, basemax, any_dup = join(
        store, cs, canonical, local_node)
    # Post-pass (outside the kernel on the TPU too): the union-final
    # canonical comes from the kernel's own basemax, and only then can
    # the winners' modified lanes be stamped.
    new_canonical = torch.maximum(canonical, basemax)
    thresh = ((wall_millis + MAX_DRIFT) << SHIFT) | MAX_COUNTER
    new_store = DenseStore(
        lt=lt, node=node, val=val,
        mod_lt=store.mod_lt.masked_fill(win, new_canonical),
        mod_node=store.mod_node.masked_fill(win, local_node),
        occupied=occupied, tomb=tomb)
    return new_store, BatchResult(new_canonical, win, basemax, any_dup,
                                  basemax > thresh)


def fanin_batch(store: DenseStore, cs: DenseChangeset,
                canonical_lt: Scalar, local_node: int, wall_millis: int
                ) -> Tuple[DenseStore, BatchResult]:
    """ONE logical merge of ``cs`` into a fresh copy of ``store``: the
    hand kernel for CUDA tensors, the plain version for CPU tensors.
    See the module docstring for the contract."""
    join = _fanin_cuda if store.lt.is_cuda else fanin_join_reference
    return _fanin(join, store, cs, canonical_lt, local_node, wall_millis)


def fanin_batch_reference(store: DenseStore, cs: DenseChangeset,
                          canonical_lt: Scalar, local_node: int,
                          wall_millis: int
                          ) -> Tuple[DenseStore, BatchResult]:
    """`fanin_batch` through the plain version on any device — what the
    kernel is held against on the card."""
    return _fanin(fanin_join_reference, store, cs, canonical_lt,
                  local_node, wall_millis)


def model_fanin_batch(store: DenseStore, cs: DenseChangeset,
                      canonical_lt: Scalar, local_node: int,
                      wall_millis: int, *, value_width: int = 64):
    """The model layer's merge step: value-width masking, the ``seen``
    count and `fanin_batch`. With ``value_width=32`` records whose value
    does not fit int32 are masked INVALID, never truncated, and
    ``val_overflow`` says so. Returns ``(new_store, BatchResult, seen,
    val_overflow)``."""
    if value_width == 32:
        fits = (cs.val >= -(2 ** 31)) & (cs.val < 2 ** 31)
        val_overflow = (cs.valid & ~fits).any()
        cs = cs._replace(valid=cs.valid & fits)
    else:
        val_overflow = torch.zeros((), dtype=torch.bool,
                                   device=cs.valid.device)
    seen = cs.valid.sum()
    new_store, res = fanin_batch(store, cs, canonical_lt, local_node,
                                 wall_millis)
    return new_store, res, seen, val_overflow


def pipelined_model_step(store: DenseStore, cs: DenseChangeset,
                         canonical: torch.Tensor, any_bad: torch.Tensor,
                         overflow: torch.Tensor, drift: torch.Tensor,
                         val_ovf: torch.Tensor, first_idx: torch.Tensor,
                         local_node: int, wall_merge: int, wall_send: int,
                         merge_idx: int, *, value_width: int = 64):
    """One COARSE pipelined merge with no host synchronization: the
    model merge plus the window bookkeeping — flag OR-accumulation,
    first-flag attribution and the final send bump, all on device.
    ``wall_merge`` is the absorption-phase wall read, ``wall_send`` the
    send bump's. Returns ``(new_store, new_canonical, any_bad,
    overflow, drift, val_overflow, first_flag_idx, win_count, win,
    seen)``."""
    new_store, res, seen, voverflow = model_fanin_batch(
        store, cs, canonical, local_node, wall_merge,
        value_width=value_width)
    return _pipelined_tail(new_store, res, seen, voverflow, value_width,
                           any_bad, overflow, drift, val_ovf, first_idx,
                           merge_idx, wall_send)


def _pipelined_tail(new_store, res, seen, voverflow, value_width,
                    any_bad, overflow, drift, val_ovf, first_idx,
                    merge_idx, wall_send):
    recv_flag = res.any_dup | res.any_drift
    new_flags = recv_flag | voverflow if value_width == 32 else recv_flag
    first_idx = torch.where((first_idx < 0) & new_flags, merge_idx,
                            first_idx)
    new_lt, s_ovf, s_drift = send_step(res.new_canonical, wall_send)
    first_idx = torch.where((first_idx < 0) & (s_ovf | s_drift),
                            merge_idx, first_idx)
    return (new_store, new_lt, any_bad | recv_flag, overflow | s_ovf,
            drift | s_drift, val_ovf | voverflow, first_idx,
            res.win.sum().to(torch.int32), res.win, seen)
