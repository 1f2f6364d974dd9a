"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The same hybrid-logical-clock LWW map, its dense replication loop
running on an NVIDIA H100: the store lanes live on the card, and the
hot operations — the fan-in merge, the ingest commit, the merge of the
JAX peers' split wire lanes and the stream replay — are hand-written
CUDA kernels (``csrc/``) built with ``nvcc`` at first use. Each kernel
has a plain torch version beside it, which the wrappers take for CPU
tensors and which the CPU tests hold against the JAX package.

Beside the dense models sit the record-map surface (the `Crdt` base,
the host `MapCrdt`, `KeyedDenseCrdt` over a dense model), typed slots
(`semantics`), the in-process sync rounds and the checkpoints.

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
from .crdt import Crdt
from .models.map_crdt import MapCrdt
from .models.dense_crdt import (DenseCrdt, PipelinedGuardError,
                                ShardedDenseCrdt, sync_dense)
from .models.keyed_dense import KeyedDenseCrdt
from . import parallel, semantics
from .sync import sync, sync_json, sync_merkle, sync_packed
from .checkpoint import (load_dense, load_gossip_state, load_json,
                         save_dense, save_gossip_state, save_json)

__all__ = [
    "Hlc", "ClockDriftException", "DuplicateNodeException",
    "OverflowException", "MAX_COUNTER", "MAX_DRIFT", "wall_clock_millis",
    "Record", "CrdtJson", "dart_str", "ChangeEvent", "ChangeStream",
    "PackedDelta", "Crdt", "MapCrdt", "DenseCrdt", "PipelinedGuardError",
    "ShardedDenseCrdt", "KeyedDenseCrdt", "sync_dense", "sync",
    "sync_json", "sync_packed", "sync_merkle", "parallel", "semantics",
    "load_dense", "save_dense", "load_json", "save_json",
    "load_gossip_state", "save_gossip_state",
]
