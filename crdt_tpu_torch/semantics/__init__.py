"""crdt_tpu_torch.semantics — the per-lane CRDT types.

Port of ``crdt_tpu.semantics``: a registry of lane semantics, each with
a wire tag, a value codec and a type-canonical law value, and the
typed joins (`kernels`). Five semantics ship: ``lww`` (tag 0, the seed
behaviour), ``gcounter``, ``pncounter``, ``orset`` and ``mvreg``.

Models use them through `DenseCrdt.set_semantics` (a per-slot tag
column) and the typed ops (``counter_add``, ``orset_add``,
``mvreg_put``, ...); the packed wire form carries the tags only to
peers that ask for them (``pack_since(sem_mode="include")``). The JAX
package's ``law_targets()`` / ``audit_targets()`` build analysis
targets, which this package does not have yet.
"""

from __future__ import annotations

from .types import (LWW, GCOUNTER, PNCOUNTER, ORSET, MVREG,
                    SemanticsSpec, all_semantics, by_tag,
                    get_semantics, names, register)
from .kernels import (MVREG_K, MVREG_MAX, ORSET_MAX_LEN,
                      ORSET_UNIVERSE, SEM_GCOUNTER, SEM_LWW,
                      SEM_MVREG, SEM_ORSET, SEM_PNCOUNTER,
                      combine_wire_deltas, typed_fanin_step,
                      typed_join_lanes, typed_sparse_join_step,
                      typed_wire_join_step)

__all__ = [
    "SemanticsSpec", "register", "get_semantics", "by_tag",
    "all_semantics", "names",
    "LWW", "GCOUNTER", "PNCOUNTER", "ORSET", "MVREG",
    "SEM_LWW", "SEM_GCOUNTER", "SEM_PNCOUNTER", "SEM_ORSET",
    "SEM_MVREG", "ORSET_UNIVERSE", "ORSET_MAX_LEN", "MVREG_K",
    "MVREG_MAX",
    "typed_join_lanes", "typed_wire_join_step",
    "typed_sparse_join_step", "typed_fanin_step", "combine_wire_deltas",
]
