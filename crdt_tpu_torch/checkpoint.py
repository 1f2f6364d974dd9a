"""Columnar snapshot of a dense store: one compressed npz.

The same file format as ``crdt_tpu/checkpoint.py`` (`save_dense`,
`load_dense_with_node_ids`, `load_dense_digest`): the seven lanes under
their field names, the ``magic`` tag, for model snapshots the
``node_ids`` table the ordinal lanes index into and, where given, the
Merkle digest tree with the cache key it was computed under
(``digest_tree`` and ``digest_meta``). A snapshot written by either
package loads in the other, digest tree included, so a replica restored
from it answers its first anti-entropy walk from the persisted tree.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .ops.dense import DenseStore, store_from_numpy, store_to_numpy

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


def _validated_npz(z, path: str):
    if str(z["magic"]) not in (_DENSE_MAGIC, _DENSE_MAGIC_V1):
        raise ValueError(f"not a dense-store snapshot: {path}")
    return z


def load_dense_with_node_ids(path: str, device="cpu"):
    """``(DenseStore on device, node_ids-or-None)``. ``None`` marks a
    lane-only snapshot whose ordinals only a caller holding the
    original table can interpret."""
    with np.load(path) as z:
        _validated_npz(z, path)
        store = store_from_numpy(z, device)
        ids = (json.loads(str(z["node_ids"]))
               if "node_ids" in z else None)
    return store, ids


def load_dense(path: str, device="cpu") -> DenseStore:
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
