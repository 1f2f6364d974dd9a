"""The ingest commit on the card: kernel wrapper for the write-combiner
flush. Port of ``crdt_tpu/ops/pallas_scatter.py``.

The TPU version regrouped each flush onto the 4096-slot tiles it
touched (``prepare_tile_updates``) because XLA serializes scatters on
a TPU, and padded the tile list with distinct untouched tiles for its
pipelined grid. Neither carries over: the Hopper kernel
(``csrc/ingest_scatter.cu``) is a direct scatter, one thread per row,
into the store lanes IN PLACE. The combiner hands it the rows in slot
order, the counterpart of the tile regrouping: a warp's stores then
land in neighbouring lines. The rows arrive padded to a power of two
with ``slot == n_slots`` sentinels, which write nothing, and their
slots are unique (the combiner's last-wins dedup); any order gives the
same lanes.

`ingest_scatter` takes the kernel for CUDA tensors and the plain
version (`ops.dense.ingest_scatter`, re-exported here as
`ingest_scatter_reference`) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..obs import device as _obs_device
from .dense import STORE_DTYPES, DenseStore, check_lanes
from .dense import ingest_scatter as ingest_scatter_reference

_VP = ctypes.c_void_p
_ROW_DTYPES = {"slots": torch.int64, "lt": torch.int64,
               "val": torch.int64, "tomb": torch.bool}


@functools.cache
def _launcher():
    return _build.load("ingest_scatter", "crdt_ingest_scatter",
                       [_VP] * 11 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int64, _VP])


def _ingest_cuda(store: DenseStore, slots: torch.Tensor, lt: torch.Tensor,
                 val: torch.Tensor, tomb: torch.Tensor, me: int
                 ) -> DenseStore:
    dev = store.lt.device
    n = store.n_slots
    rows = slots.shape[0]
    check_lanes("ingest_scatter", store._asdict(), STORE_DTYPES, (n,), dev)
    check_lanes("ingest_scatter",
                dict(slots=slots, lt=lt, val=val, tomb=tomb),
                _ROW_DTYPES, (rows,), dev)
    if rows:
        with torch.cuda.device(dev):
            rc = _launcher()(
                *(lane.data_ptr() for lane in store),
                slots.data_ptr(), lt.data_ptr(), val.data_ptr(),
                tomb.data_ptr(), int(me), n, rows,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"ingest_scatter kernel launch failed: "
                               f"CUDA error {rc}")
        _obs_device.note_launch("ingest_scatter")
    return store


def ingest_scatter(store: DenseStore, slots: torch.Tensor,
                   lt: torch.Tensor, val: torch.Tensor, tomb: torch.Tensor,
                   me: int) -> DenseStore:
    """Commit a deduped, sentinel-padded flush into ``store`` in place
    and return it: the hand kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if store.lt.is_cuda:
        return _ingest_cuda(store, slots, lt, val, tomb, me)
    return ingest_scatter_reference(store, slots, lt, val, tomb, me)
