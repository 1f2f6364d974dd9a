"""Columnar snapshot of a dense store: one compressed npz.

The same file format as ``crdt_tpu/checkpoint.py`` (`save_dense` /
`load_dense_with_node_ids`): the seven lanes under their field names,
the ``magic`` tag and, for model snapshots, the ``node_ids`` table the
ordinal lanes index into. A snapshot written by either package loads
in the other. The JAX package may add a persisted digest tree; it is a
cache, and this package ignores it (the digest path comes with a later
slice).
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
               node_ids: Optional[list] = None) -> None:
    """Write the lanes (and the node-id table when given) atomically:
    to ``path + ".tmp"``, then renamed over ``path``."""
    tmp = path + ".tmp"
    extra = ({} if node_ids is None
             else {"node_ids": np.array(json.dumps(list(node_ids)))})
    with open(tmp, "wb") as f:
        np.savez_compressed(f, magic=np.array(_DENSE_MAGIC), **extra,
                            **store_to_numpy(store))
    os.replace(tmp, path)


def load_dense_with_node_ids(path: str, device="cpu"):
    """``(DenseStore on device, node_ids-or-None)``. ``None`` marks a
    lane-only snapshot whose ordinals only a caller holding the
    original table can interpret."""
    with np.load(path) as z:
        if str(z["magic"]) not in (_DENSE_MAGIC, _DENSE_MAGIC_V1):
            raise ValueError(f"not a dense-store snapshot: {path}")
        store = store_from_numpy(z, device)
        ids = (json.loads(str(z["node_ids"]))
               if "node_ids" in z else None)
    return store, ids


def load_dense(path: str, device="cpu") -> DenseStore:
    return load_dense_with_node_ids(path, device)[0]
