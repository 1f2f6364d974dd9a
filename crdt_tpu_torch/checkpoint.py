"""Checkpoint and resume: the wire-format snapshot, the gossip
watermarks, and the columnar snapshot of a dense store.

Port of ``crdt_tpu/checkpoint.py``, every file in the same format, so
either package restores what the other saved:

- :func:`save_json` / :func:`load_json`: the reference's own checkpoint,
  its wire JSON (``toJson`` is the snapshot, construction from the
  records with ``refreshCanonicalTime`` the resume, crdt.dart:31-33,
  100-135);
- :func:`save_gossip_state` / :func:`load_gossip_state`: a gossip
  node's per-peer watermark table, so a restarted node resumes delta
  sync;
- :func:`save_dense` / :func:`load_dense`: one compressed npz of the
  seven lanes under their field names, the ``magic`` tag, for model
  snapshots the ``node_ids`` table the ordinal lanes index into and,
  where given, the Merkle digest tree with the cache key it was
  computed under (``digest_tree`` and ``digest_meta``), so a replica
  restored from it answers its first anti-entropy walk from the
  persisted tree.

Every completed save or load counts in the registry's
``crdt_tpu_checkpoints_total`` and, with the tracer on, emits an
HLC-stamped ``checkpoint`` event with its duration and size.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional, Type

import numpy as np

from .utils.devices import resolve_device
from .ops.dense import DenseStore, store_from_numpy, store_to_numpy
from .obs.trace import tracer as _tracer
from .record import KeyDecoder, KeyEncoder, ValueDecoder, ValueEncoder


def _note(action: str, path: str, start: float, hlc=None) -> None:
    """Account one completed checkpoint op: bump the process counter,
    and, when the tracer is on, emit an HLC-stamped ``checkpoint``
    event with its duration and on-disk size. Checkpoints are rare and
    already did file I/O, so this is never on a hot path."""
    from .obs.registry import default_registry
    default_registry().counter(
        "crdt_tpu_checkpoints_total",
        "checkpoint save/load operations by action").inc(action=action)
    ring = _tracer()
    if ring.enabled:
        fields = {"action": action, "path": path,
                  "dur_s": time.perf_counter() - start}
        try:
            fields["bytes"] = os.path.getsize(path)
        except OSError:
            pass
        ring.emit("checkpoint", hlc=hlc, **fields)


def save_json(crdt, path: str, key_encoder: Optional[KeyEncoder] = None,
              value_encoder: Optional[ValueEncoder] = None) -> None:
    """Snapshot through the wire format: the full state, tombstones
    included (crdt.dart:124-135), written atomically (to ``path +
    ".tmp"``, then renamed over ``path``). Any conformant backend can
    restore it."""
    start = time.perf_counter()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(crdt.to_json(key_encoder=key_encoder,
                             value_encoder=value_encoder))
    os.replace(tmp, path)
    _note("save_json", path, start, hlc=crdt.canonical_time)


def load_json(cls: Type, node_id: Any, path: str,
              key_decoder: Optional[KeyDecoder] = None,
              value_decoder: Optional[ValueDecoder] = None,
              wall_clock: Optional[Callable[[], int]] = None, **kwargs):
    """Restore a replica of ``cls`` (a backend built from ``seed``
    records, such as `MapCrdt`) from its own snapshot: the records
    seed the backend and the canonical clock rebuilds from their max
    logical time (crdt.dart:31-33, 114-121). Not a merge: merging
    records you authored into a fresh replica with the same node id
    trips the duplicate-node guard by design (hlc.dart:88-90). To take
    in ANOTHER replica's snapshot, call ``merge_json``."""
    from . import crdt_json
    from .hlc import Hlc

    start = time.perf_counter()
    with open(path) as f:
        records = crdt_json.decode(
            f.read(), Hlc.zero(node_id), key_decoder=key_decoder,
            value_decoder=value_decoder,
            now_millis=wall_clock() if wall_clock else None)
    crdt = cls(node_id, seed=records, wall_clock=wall_clock, **kwargs)
    _note("load_json", path, start, hlc=crdt.canonical_time)
    return crdt


_GOSSIP_STATE_MAGIC = "crdt_tpu/gossip-state@1"


def save_gossip_state(path: str, node_id: Any, watermarks: dict) -> None:
    """The durable per-peer watermark table of a gossip node (``{peer
    name: Hlc}``), written atomically, so a crash mid-write leaves the
    previous state. The watermarks are all a restarted node needs to
    resume DELTA sync; the replica itself persists through
    :func:`save_json` or :func:`save_dense`. ``node_id`` is recorded so
    a state file restored onto another node is refused."""
    start = time.perf_counter()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"magic": _GOSSIP_STATE_MAGIC,
                   "node_id": str(node_id),
                   "watermarks": {str(name): str(hlc)
                                  for name, hlc in watermarks.items()
                                  if hlc is not None}}, f)
    os.replace(tmp, path)
    _note("save_gossip_state", path, start)


def load_gossip_state(path: str, node_id: Any) -> dict:
    """A watermark table saved by :func:`save_gossip_state`; ``{}`` when
    the file does not exist (a cold start). Raises ``ValueError`` on a
    foreign file or another node's state: resuming from someone else's
    watermarks would skip records."""
    from .hlc import Hlc

    if not os.path.exists(path):
        return {}
    with open(path) as f:
        state = json.load(f)
    if not isinstance(state, dict) \
            or state.get("magic") != _GOSSIP_STATE_MAGIC:
        raise ValueError(f"not a gossip state file: {path}")
    if state.get("node_id") != str(node_id):
        raise ValueError(
            f"{path} holds watermarks for node "
            f"{state.get('node_id')!r}, not {node_id!r}")
    return {name: Hlc.parse(mark)
            for name, mark in state.get("watermarks", {}).items()}

_DENSE_MAGIC_V1 = "crdt_tpu/dense-store@1"
_DENSE_MAGIC = "crdt_tpu/dense-store@2"


def save_dense(store: DenseStore, path: str,
               node_ids: Optional[list] = None,
               digest: Optional[tuple] = None) -> None:
    """Write the lanes (and the node-id table when given) atomically:
    to ``path + ".tmp"``, then renamed over ``path``. ``digest`` is
    ``(DigestTree, logical_time, sem_version)``: the tree and the key
    it was computed under, which `load_dense_digest` hands back. The
    root-first levels have widths 1, 2, 4, ..., so one flat uint64
    concatenation round-trips them."""
    start = time.perf_counter()
    tmp = path + ".tmp"
    extra = ({} if node_ids is None
             else {"node_ids": np.array(json.dumps(list(node_ids)))})
    if digest is not None:
        tree, logical_time, sem_version = digest
        extra["digest_tree"] = np.concatenate(
            [np.asarray(lvl, np.uint64) for lvl in tree.levels])
        extra["digest_meta"] = np.array(json.dumps({
            "n_slots": int(tree.n_slots),
            "leaf_width": int(tree.leaf_width),
            "depth": int(tree.depth),
            "logical_time": int(logical_time),
            "sem_version": int(sem_version)}))
    with open(tmp, "wb") as f:
        np.savez_compressed(f, magic=np.array(_DENSE_MAGIC), **extra,
                            **store_to_numpy(store))
    os.replace(tmp, path)
    _note("save_dense", path, start)


def _validated_npz(z, path: str):
    if str(z["magic"]) not in (_DENSE_MAGIC, _DENSE_MAGIC_V1):
        raise ValueError(f"not a dense-store snapshot: {path}")
    return z


def load_dense_with_node_ids(path: str, device=None):
    """``(DenseStore on device, node_ids-or-None)``. ``None`` marks a
    lane-only snapshot whose ordinals only a caller holding the
    original table can interpret. ``device=None`` is the card, and
    raises without one unless the caller passes ``device="cpu"``, as
    every entry point of this package does."""
    device = resolve_device(device)
    start = time.perf_counter()
    with np.load(path) as z:
        _validated_npz(z, path)
        store = store_from_numpy(z, device)
        ids = (json.loads(str(z["node_ids"]))
               if "node_ids" in z else None)
    _note("load_dense", path, start)
    return store, ids


def load_dense(path: str, device=None) -> DenseStore:
    """The store of a snapshot, on ``device`` (None: the card)."""
    return load_dense_with_node_ids(path, device)[0]


def load_dense_digest(path: str) -> Optional[tuple]:
    """The persisted digest tree and its key, ``(DigestTree,
    logical_time, sem_version)``, or None for a snapshot saved without
    one. A malformed digest entry also answers None: the tree is a
    cache, so the right degradation is a rebuild on the first walk,
    never a failed restore."""
    from .ops.digest import DigestTree

    with np.load(path) as z:
        _validated_npz(z, path)
        if "digest_tree" not in z or "digest_meta" not in z:
            return None
        try:
            meta = json.loads(str(z["digest_meta"]))
            depth = int(meta["depth"])
            flat = np.asarray(z["digest_tree"], np.uint64)
            widths = [1 << lvl for lvl in range(depth)]
            if int(flat.shape[0]) != sum(widths):
                return None
            levels, off = [], 0
            for w in widths:
                levels.append(flat[off:off + w].copy())
                off += w
            tree = DigestTree(n_slots=int(meta["n_slots"]),
                              leaf_width=int(meta["leaf_width"]),
                              levels=tuple(levels))
            return (tree, int(meta["logical_time"]),
                    int(meta["sem_version"]))
        except (KeyError, TypeError, ValueError):
            return None
