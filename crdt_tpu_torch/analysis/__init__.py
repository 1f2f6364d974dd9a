"""crdtlint: static + dynamic correctness tooling of the port.

Port of ``crdt_tpu.analysis``:

- `host_lint` — AST linter for host-layer race/discipline rules
- `concurrency` — whole-tree lock-order analyzer (declared
  `_CRDTLINT_LOCK_ORDER` contracts vs the observed acquisition graph)
  plus the runtime deadlock sanitizer (`make_lock`/`OrderedLock`)
- `lattice_laws` — seeded semilattice-law counterexample search, over
  the plain ops and the hand kernels
- `op_audit` — order-sensitivity hazards in the merge ops' aten
  streams (the JAX package's jaxpr audit)
- `sanitizer` — opt-in runtime lattice assertions (CRDT_TPU_SANITIZE=1)
- CLI: ``python -m crdt_tpu_torch.analysis`` (the CI gate)

This package is import-light on purpose: the sanitizer hook sits on
`crdt.Crdt.merge`'s path and the lock seam on every contract lock, so
importing `crdt_tpu_torch.analysis` (or `.sanitizer`) must not pull in
the analyzers. Analyzer names resolve lazily via ``__getattr__``.
"""

from __future__ import annotations

from . import sanitizer  # import-light: os + typing only
from .findings import Finding

_LAZY = {
    "lint_file": "host_lint", "lint_source": "host_lint",
    "lint_package": "host_lint",
    "LawTarget": "lattice_laws", "run_laws": "lattice_laws",
    "make_wire_join_target": "lattice_laws",
    "AuditTarget": "op_audit", "AuditReport": "op_audit",
    "audit_all": "op_audit",
    "LatticeViolation": "sanitizer",
    "analyze_source": "concurrency", "analyze_paths": "concurrency",
    "analyze_package": "concurrency",
    "make_lock": "concurrency", "OrderedLock": "concurrency",
}

__all__ = ["Finding", "sanitizer"] + sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        module = importlib.import_module("." + _LAZY[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
