"""crdtlint CLI: ``python -m crdt_tpu_torch.analysis``.

Port of ``crdt_tpu/analysis/cli.py``. The default run (no explicit
targets) audits the shipped tree — the CI gate: host-lint every package
file and analyze its lock order, run the semilattice law search over
the registered ops and the hand kernels, and audit every merge op's
aten stream for order-sensitivity hazards. Exit 0 means no findings.

The law and audit targets run on ``--device``: the CUDA card unless
``--device cpu`` is given, and without a card the run raises (the
port's device rule). On the card the kernel targets launch the hand
kernels; a kernel that fails to build or launch fails the run.

Explicit targets (``--lint PATH``, ``--law-fixture PATH``) run ONLY
what was named — how the self-test fixtures are exercised::

    python -m crdt_tpu_torch.analysis --device cpu \\
        --lint tests/fixtures/racy_gossip.py
    python -m crdt_tpu_torch.analysis --device cpu \\
        --law-fixture tests/torch_broken_merge.py

A law fixture is a Python file exposing ``LAW_TARGETS`` (a list of
``analysis.lattice_laws.LawTarget``, or a function of the device
returning one); on a law violation the CLI prints the violating input
(seed + batches) and exits nonzero.

``--json`` emits machine-readable output in the JAX CLI's layout: its
``jaxpr_reports`` key carries each audited op's golden report (hazards
+ relied-on contracts). The default run adds a ``gate`` key: the
device, the target and seed counts, the seconds of the lint, the law
search and the audit, and the hand-kernel launches each made.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time
from typing import List


def _load_law_fixture(path: str, device):
    spec = importlib.util.spec_from_file_location(
        "crdtlint_law_fixture_" + os.path.basename(path).replace(
            ".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    targets = getattr(module, "LAW_TARGETS", None)
    if callable(targets):
        targets = targets(device)
    if not targets:
        raise SystemExit(
            f"law fixture {path} defines no LAW_TARGETS list")
    return list(targets)


def _registry_completeness(specs=None) -> List:
    """The semantics-registry CI gate: every registered lane semantics
    must declare BOTH a law target and an audit target — registering is
    what puts a type under CI, so a spec missing either would ship an
    unverified join. One finding per missing factory."""
    from .findings import Finding
    if specs is None:
        from ..semantics import all_semantics
        specs = all_semantics()
    out = []
    for spec in specs:
        where = f"semantics {spec.name!r} (tag {spec.tag})"
        if spec.law_target is None:
            out.append(Finding(
                rule="semantics-missing-law-target",
                path="crdt_tpu_torch/semantics/types.py", line=0,
                message=f"{where} registers no law target",
                detail="declare law_target so the seeded semilattice "
                       "search covers this join (see "
                       "types._typed_law_target)"))
        if spec.audit_target is None:
            out.append(Finding(
                rule="semantics-missing-audit-target",
                path="crdt_tpu_torch/semantics/types.py", line=0,
                message=f"{where} registers no audit target",
                detail="declare audit_target so the op audit covers "
                       "this join (see types._typed_audit_target)"))
    return out


# Fast-path ops the default run must find in the op-audit registry:
# the fused merge+repack step, the ingest commit and the pod-local
# collective join.
_FASTPATH_REQUIRED = (
    "dense.merge_repack_step",
    "pallas.ingest_scatter_tiles[interpret]",
    "parallel.collective_join[member2]",
)


def _fastpath_completeness(target_names) -> List:
    """The fast-path CI gate: an unregistered fast-path op fails the
    default run. (The collective join needs no second card here: its
    mesh repeats one device.)"""
    from .findings import Finding
    names = set(target_names)
    return [Finding(
        rule="fastpath-kernel-unregistered",
        path="crdt_tpu_torch/analysis/op_audit.py", line=0,
        message=f"fast-path kernel {req!r} is not a registered "
                "op-audit target",
        detail="add it to builtin_targets() so the audit covers the "
               "fused/zero-copy dispatch path")
        for req in _FASTPATH_REQUIRED if req not in names]


# Merkle anti-entropy ops the default run must find in the op-audit
# registry: the digest reduction and the range-pack mask.
_MERKLE_REQUIRED = (
    "digest.digest_tree_levels",
    "dense.range_delta_mask",
)


def _merkle_completeness(target_names) -> List:
    """The merkle CI gate: an unregistered anti-entropy op fails the
    default run."""
    from .findings import Finding
    names = set(target_names)
    return [Finding(
        rule="merkle-kernel-unregistered",
        path="crdt_tpu_torch/analysis/op_audit.py", line=0,
        message=f"merkle anti-entropy kernel {req!r} is not a "
                "registered op-audit target",
        detail="add it to builtin_targets() so the audit covers the "
               "digest-reduction/range-pack dispatch path")
        for req in _MERKLE_REQUIRED if req not in names]


# Device entry points the default run must find registered with the
# dispatch ledger (obs.device), under the JAX package's names.
_LEDGER_REQUIRED = (
    "dense.fanin_step", "dense.fanin_stream", "dense.sparse_fanin_step",
    "dense.wire_join_step", "dense.merge_repack_step",
    "dense.delta_mask", "dense.range_delta_mask",
    "dense.max_logical_time", "dense.put_scatter",
    "dense.record_scatter", "dense.delete_scatter",
    "dense.ingest_scatter",
    "digest.digest_tree_device",
    "pallas.ingest_scatter_tiles",
    "pallas.model_fanin_batch", "pallas.model_fanin_split",
    "pallas.pallas_fanin_stream",
    "semantics.typed_wire_join_step", "semantics.typed_sparse_join_step",
    "semantics.typed_fanin_step",
    "parallel.sharded_fanin", "parallel.sharded_pallas_fanin",
    "parallel.sharded_ingest", "parallel.sharded_digest",
    "parallel.sharded_delta_mask", "parallel.sharded_max_logical_time",
    "parallel.collective_join",
    "dense.gc_purge", "dense.compact_remap", "parallel.sharded_compact",
)

# The launch counters (`obs.device.KERNELS`) of the hand kernels a
# merge path launches, and the call counters (`obs.device.OPS`) of the
# plain ops no kernel replaces: what a run reads to prove its path went
# through them.
_COUNTERS_REQUIRED = (
    "fanin_batch", "fanin_batch_sharded", "fanin_split", "fanin_stream",
    "ingest_scatter",
    "digest_tree", "range_delta_mask", "gc_purge", "compact_remap",
    "typed_wire_join_step", "typed_sparse_join_step", "typed_fanin_step",
    "merge_step", "scatter_put", "max_logical_time", "delta_mask",
    "parallel.collective_join",
)


def _ledger_completeness(registered=None, counters=None) -> List:
    """The dispatch-ledger CI gate: every device entry point must have
    declared itself to the ledger at module import, and every hand
    kernel and plain op must have its counter in `obs.device` — an
    uninstrumented kernel dispatches invisibly and fails the default
    run."""
    from .findings import Finding
    if registered is None:
        # Importing the instrumented modules runs their register()
        # calls; nothing is dispatched.
        from .. import parallel  # noqa: F401
        from ..obs.device import default_ledger
        from ..ops import (dense, digest, fanin_kernel,  # noqa: F401
                           ingest_kernel, stream_kernel)
        from ..semantics import kernels  # noqa: F401
        registered = default_ledger().registered_kernels()
    if counters is None:
        from ..obs.device import KERNELS, OPS
        counters = set(KERNELS) | set(OPS)
    names, have = set(registered), set(counters)
    out = [Finding(
        rule="dispatch-ledger-unregistered",
        path="crdt_tpu_torch/obs/device.py", line=0,
        message=f"device entry point {req!r} is not registered with "
                "the dispatch ledger",
        detail="instrument its host wrapper with obs.device.record(...) "
               "and register the name at module import so dispatch "
               "counts and the zero-dispatch probes cover it")
        for req in _LEDGER_REQUIRED if req not in names]
    out.extend(Finding(
        rule="launch-counter-missing",
        path="crdt_tpu_torch/obs/device.py", line=0,
        message=f"kernel or op {req!r} has no launch counter in "
                "obs.device.KERNELS / OPS",
        detail="count it where it launches (note_launch / note_op) so a "
               "run can prove its path went through it")
        for req in _COUNTERS_REQUIRED if req not in have)
    return out


# Storage-plane ops the default run must find covered by BOTH
# verification surfaces: the op audit and the law search.
_GC_REQUIRED = (
    "dense.gc_purge",
    "dense.compact_remap",
)


def _gc_completeness(audit_names=None, law_names=None) -> List:
    """The storage-plane CI gate: epoch GC and online compaction must
    be registered with every verification surface that ran this
    invocation (pass ``None`` for one that did not run). A physically
    destructive op shipping without audit or law coverage is the one
    class of bug eventual consistency cannot repair."""
    from .findings import Finding
    out = []
    for req in _GC_REQUIRED:
        if audit_names is not None and req not in set(audit_names):
            out.append(Finding(
                rule="gc-kernel-unaudited",
                path="crdt_tpu_torch/analysis/op_audit.py", line=0,
                message=f"storage-plane kernel {req!r} is not a "
                        "registered op-audit target",
                detail="add it to builtin_targets() — a purge/remap "
                       "with an order-sensitivity hazard destroys state "
                       "unrecoverably"))
        if law_names is not None and req not in set(law_names):
            out.append(Finding(
                rule="gc-kernel-unlawed",
                path="crdt_tpu_torch/analysis/lattice_laws.py", line=0,
                message=f"storage-plane kernel {req!r} is not a "
                        "registered law-search target",
                detail="add it to builtin_targets() — purge + fence "
                       "must provably stay a semilattice or replicas "
                       "diverge permanently"))
    return out


def _launch_delta(before: dict) -> dict:
    from ..obs.device import launches
    return {k: v - before.get(k, 0) for k, v in launches().items()
            if v != before.get(k, 0)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m crdt_tpu_torch.analysis",
        description="crdtlint: op auditor, lattice-law search and "
                    "host-layer race/discipline linter")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON output")
    parser.add_argument("--lint", action="append", default=[],
                        metavar="PATH",
                        help="lint only this file/directory (repeat "
                             "to add more); disables the default "
                             "full-tree run")
    parser.add_argument("--law-fixture", action="append", default=[],
                        metavar="PATH",
                        help="run the law search over a fixture "
                             "module's LAW_TARGETS instead of the "
                             "builtin ops")
    parser.add_argument("--seeds", default="0,1,2",
                        help="comma-separated seeds for the law "
                             "counterexample search (default 0,1,2)")
    parser.add_argument("--skip-lint", action="store_true",
                        help="skip the host linter in the default run")
    parser.add_argument("--skip-laws", action="store_true",
                        help="skip the law search in the default run")
    parser.add_argument("--skip-jaxpr", action="store_true",
                        help="skip the op audit (the JAX package's jaxpr "
                             "audit) in the default run")
    parser.add_argument("--device", default=None,
                        help="device of the law and audit targets: the "
                             "CUDA card by default, 'cpu' for the plain "
                             "torch path")
    args = parser.parse_args(argv)

    from ..obs.device import launches
    from ..utils.devices import resolve_device
    from .findings import Finding, render_human, render_json
    device = resolve_device(args.device)
    findings: List[Finding] = []
    reports = []
    seeds = tuple(int(s) for s in args.seeds.split(",") if s.strip())
    explicit = bool(args.lint or args.law_fixture)
    gate = {"device": str(device), "seeds": list(seeds)}

    if args.lint:
        from .concurrency import analyze_paths
        from .host_lint import lint_file, lint_package
        for path in args.lint:
            if os.path.isdir(path):
                findings.extend(lint_package(path))
            else:
                findings.extend(lint_file(path))
        # one global lock graph across every --lint path
        findings.extend(analyze_paths(args.lint))

    if args.law_fixture:
        from .lattice_laws import run_laws
        for path in args.law_fixture:
            findings.extend(run_laws(_load_law_fixture(path, device),
                                     seeds=seeds))

    if not explicit:
        if not args.skip_lint:
            from .concurrency import analyze_package
            from .host_lint import lint_package
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
            t0 = time.perf_counter()
            findings.extend(lint_package(pkg_root))
            findings.extend(analyze_package(pkg_root))
            gate["lint_s"] = time.perf_counter() - t0
        if not args.skip_laws or not args.skip_jaxpr:
            # The registry gate guards exactly the law + audit
            # coverage surfaces, so it runs whenever either does.
            findings.extend(_registry_completeness())
        law_names = audit_names = None
        if not args.skip_laws:
            from .lattice_laws import builtin_targets, run_laws
            t0, before = time.perf_counter(), launches()
            law_targets = builtin_targets(device)
            law_names = tuple(t.name for t in law_targets)
            findings.extend(run_laws(law_targets, seeds=seeds))
            _sync(device)
            gate.update(laws_s=time.perf_counter() - t0,
                        law_targets=len(law_targets),
                        law_launches=_launch_delta(before))
        if not args.skip_jaxpr:
            from .op_audit import audit_all
            from .op_audit import builtin_targets as audit_targets
            t0, before = time.perf_counter(), launches()
            targets = audit_targets(device)
            names = tuple(t.name for t in targets)
            audit_names = names
            findings.extend(_fastpath_completeness(names))
            findings.extend(_merkle_completeness(names))
            findings.extend(_ledger_completeness())
            reports, audit_findings = audit_all(targets)
            findings.extend(audit_findings)
            _sync(device)
            gate.update(audit_s=time.perf_counter() - t0,
                        audit_targets=len(targets),
                        audit_launches=_launch_delta(before))
        if not args.skip_laws or not args.skip_jaxpr:
            findings.extend(_gc_completeness(audit_names, law_names))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if args.json:
        extra = {} if explicit else {"gate": gate}
        print(render_json(
            findings,
            jaxpr_reports=[r.golden() for r in reports], **extra))
    else:
        audited = (f" ({len(reports)} kernels audited)"
                   if reports else "")
        if findings:
            print(render_human(findings))
        else:
            print(f"crdtlint: clean{audited}")
    return 1 if findings else 0


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    sys.exit(main())
