"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The same hybrid-logical-clock LWW map, its dense replication loop
running on an NVIDIA H100: the store lanes live on the card, and the
hot operations — the fan-in merge, the ingest commit, the merge of the
JAX peers' split wire lanes and the stream replay — are hand-written
CUDA kernels (``csrc/``) built with ``nvcc`` at first use. Each kernel
has a plain torch version beside it, which the wrappers take for CPU
tensors and which the CPU tests hold against the JAX package.

The JAX package ``crdt_tpu`` is the reference; this package imports
nothing of it (not even its jax-free modules) and never imports jax.
"""

from .hlc import (ClockDriftException, DuplicateNodeException, Hlc,
                  MAX_COUNTER, MAX_DRIFT, OverflowException,
                  wall_clock_millis)
from .record import Record
from .crdt_json import CrdtJson, dart_str
from .watch import ChangeEvent, ChangeStream
from .ops.packing import PackedDelta
from .models.dense_crdt import (DenseCrdt, PipelinedGuardError,
                                ShardedDenseCrdt, sync_dense)
from . import parallel
from .checkpoint import load_dense, save_dense

__all__ = [
    "Hlc", "ClockDriftException", "DuplicateNodeException",
    "OverflowException", "MAX_COUNTER", "MAX_DRIFT", "wall_clock_millis",
    "Record", "CrdtJson", "dart_str", "ChangeEvent", "ChangeStream",
    "PackedDelta", "DenseCrdt", "PipelinedGuardError", "ShardedDenseCrdt",
    "sync_dense", "parallel", "load_dense", "save_dense",
]
