"""crdt_tpu_torch — the PyTorch/CUDA port of ``crdt_tpu``.

The same hybrid-logical-clock LWW map, its dense replication loop
running on an NVIDIA H100: the store lanes live on the card, and the
hot operations — the fan-in merge, the ingest commit, the merge of the
JAX peers' split wire lanes and the stream replay — are hand-written
CUDA kernels (``csrc/``) built with ``nvcc`` at first use. Each kernel
has a plain torch version beside it, which the wrappers take for CPU
tensors and which the CPU tests hold against the JAX package.

Beside the dense models sit the record-map surface (the `Crdt` base,
the host `MapCrdt`, the general-key `TpuMapCrdt` with its device
mirror, the durable `SqliteCrdt`, `KeyedDenseCrdt` over a dense model),
typed slots (`semantics`), the in-process sync rounds and the
checkpoints, the pod-local replica group joined in one call
(`collective`), the TCP wire (`net`: the JAX package's frames, byte for
byte), the resilient `gossip` runtime and the host observability the
wire serves (`obs`: the metrics registry, the trace ring, the dispatch
ledger and the fleet's SLO verdict), and the serving plane: the async
`ServeTier` front door over one replica, keyspace `routing`, the
`FederatedTier` that splits and merges partitions live, `ReplicaGroup`
failover with write-concern acks, and the `Autoscaler`.

The JAX package ``crdt_tpu`` is the reference; this package imports
nothing of it (not even its jax-free modules) and never imports jax.
"""

from .hlc import (ClockDriftException, DuplicateNodeException, Hlc,
                  MAX_COUNTER, MAX_DRIFT, OverflowException,
                  wall_clock_millis)
from .record import (KeyDecoder, KeyEncoder, NodeIdDecoder, Record,
                     ValueDecoder, ValueEncoder)
from .crdt_json import CrdtJson, dart_str
from .watch import ChangeEvent, ChangeStream
from .ops.packing import PackedDelta
from .crdt import Crdt
from .models.map_crdt import MapCrdt
from .models.tpu_map_crdt import TpuMapCrdt
from .models.dense_crdt import (DenseCrdt, PipelinedGuardError,
                                ShardedDenseCrdt, sync_dense)
from .models.keyed_dense import KeyedDenseCrdt
from .models.sqlite_crdt import SqliteCrdt
from . import parallel, semantics
from .sync import (sync, sync_collective, sync_json, sync_merkle,
                   sync_packed)
from .collective import CollectiveGroup, CollectiveJoinReport
from .net import (FrameCodec, PeerConnection, SyncError,
                  SyncProtocolError, SyncRedirectError, SyncServer,
                  SyncTransportError, WireTally, fetch_metrics,
                  sync_dense_over_conn, sync_dense_over_tcp,
                  sync_merkle_over_conn, sync_over_conn, sync_over_tcp,
                  sync_packed_over_conn)
from .obs import (MetricsRegistry, TraceRing, default_registry,
                  metrics_snapshot, tracer)
from .checkpoint import (load_dense, load_gossip_state, load_json,
                         save_dense, save_gossip_state, save_json)
from .gossip import (BreakerPolicy, CircuitBreaker, GossipNode, Peer,
                     RetryPolicy)
from .serve import ServeTier
from .routing import PartitionRouter, RoutingTable
from .federation import FederatedClient, FederatedTier
from .autoscale import Autoscaler
from .replication import ReplicaGroup, Replicator

__all__ = [
    "Hlc", "ClockDriftException", "DuplicateNodeException",
    "OverflowException", "MAX_COUNTER", "MAX_DRIFT", "wall_clock_millis",
    "Record", "KeyDecoder", "KeyEncoder", "NodeIdDecoder", "ValueDecoder",
    "ValueEncoder", "CrdtJson", "dart_str", "ChangeEvent", "ChangeStream",
    "PackedDelta", "Crdt", "MapCrdt", "TpuMapCrdt", "DenseCrdt",
    "PipelinedGuardError", "ShardedDenseCrdt", "KeyedDenseCrdt",
    "sync_dense", "SqliteCrdt", "sync", "sync_json", "sync_packed",
    "sync_merkle", "sync_collective", "CollectiveGroup",
    "CollectiveJoinReport", "parallel", "semantics",
    "load_dense", "save_dense", "load_json", "save_json",
    "load_gossip_state", "save_gossip_state",
    "SyncServer", "sync_dense_over_tcp", "sync_over_tcp",
    "PeerConnection", "FrameCodec",
    "sync_over_conn", "sync_dense_over_conn", "sync_packed_over_conn",
    "sync_merkle_over_conn",
    "SyncError", "SyncTransportError", "SyncProtocolError",
    "SyncRedirectError", "WireTally", "fetch_metrics",
    "GossipNode", "Peer", "RetryPolicy", "BreakerPolicy", "CircuitBreaker",
    "MetricsRegistry", "TraceRing", "default_registry",
    "metrics_snapshot", "tracer", "ServeTier",
    "RoutingTable", "PartitionRouter", "FederatedTier",
    "FederatedClient", "Autoscaler", "ReplicaGroup", "Replicator",
]
