"""Op audit: order-sensitivity hazards in the merge ops' aten streams.

The counterpart of ``crdt_tpu/analysis/jaxpr_audit.py``. That auditor
traces every registered merge/join op to its jaxpr and walks the
primitives; torch has no jaxpr, so each target here is ONE call of the
op on small seeded inputs under a ``TorchDispatchMode``
(``torch.utils._python_dispatch``) that records every aten op the call
dispatches, with its arguments. The hazard classes and their aten
spellings:

- ``scatter-duplicate-order`` — ``index_put`` / ``index_put_`` with
  ``accumulate=False`` and integer indices, and ``scatter`` /
  ``scatter_`` with a ``src`` or ``value``: duplicate indices pick an
  unspecified winner (on the card, whichever thread writes last). An
  ``index_put`` whose indices are all boolean masks cannot repeat an
  index and is not a scatter in this sense. Targets whose CALL
  CONTRACT guarantees unique slots declare ``unique_slots=True`` and
  the hazard is downgraded to a recorded *assumption* — it stays in the
  golden report so a contract change is a visible diff.
- ``nonassoc-float-reduce`` — ``sum``, ``cumsum``, ``cumprod``,
  ``mm``, ``addmm``, ``bmm``, ``index_add``, ``scatter_add`` or
  ``scatter_reduce`` on a floating dtype: float addition is not
  associative, so the result depends on reduction order. All CRDT
  lanes are int64/int32/bool.
- ``prng-in-merge`` — ``rand*``, ``randint``, ``randperm``,
  ``bernoulli``, ``normal``, ``uniform_``, ``exponential_`` or
  ``multinomial`` inside a merge: a join that draws randomness is not a
  function of its inputs.
- ``donated-invar`` — an in-place aten op that writes one of the
  call's input tensors (torch's counterpart of a donated buffer: the
  caller's old lanes are gone). Recorded as an assumption.

The Pallas-named targets call the hand-kernel wrappers. On CPU tensors
the wrappers take their plain versions, which the mode records like any
other op. On the card the kernel launch (a ``ctypes`` call) is
invisible to the mode; the report then records one assumption naming
the ``.cu`` source and the law target (`analysis.lattice_laws`) that
holds the kernel instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils.devices import resolve_device
from .findings import Finding

_SCATTERS = {"index_put", "index_put_", "scatter", "scatter_"}
_REDUCES = {"sum", "cumsum", "cumprod", "mm", "addmm", "bmm", "index_add",
            "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_"}
_PRNG = {"randint", "randperm", "bernoulli", "bernoulli_", "normal",
         "normal_", "uniform_", "exponential_", "multinomial"}


@dataclass
class AuditTarget:
    """One op under audit. ``build()`` returns ``(fn, args)``: the op
    and the inputs of the one call the audit records. ``kernel`` names
    the hand kernel's source and ``law`` the law target that holds it,
    for the targets whose wrapper launches one on the card."""

    name: str
    build: Callable[[], Tuple[Callable, tuple]]
    unique_slots: bool = False
    notes: str = ""
    kernel: Optional[str] = None
    law: Optional[str] = None


@dataclass
class AuditReport:
    target: str
    hazards: List[dict] = field(default_factory=list)
    assumptions: List[str] = field(default_factory=list)
    prim_counts: Dict[str, int] = field(default_factory=dict)

    def golden(self) -> dict:
        """The stable subset pinned as a golden: hazards and relied-on
        contracts only — op counts churn with torch versions."""
        return {"target": self.target, "hazards": self.hazards,
                "assumptions": sorted(self.assumptions)}


def _tensors(obj):
    """Every tensor in a (nested) argument: tuples, lists, dicts and
    named tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Recorder(TorchDispatchMode):
    """Records every aten op of one call into a report."""

    def __init__(self, report: AuditReport, unique_slots: bool,
                 inputs: set):
        super().__init__()
        self.report = report
        self.unique_slots = unique_slots
        self.inputs = inputs

    def _note(self, note: str) -> None:
        if note not in self.report.assumptions:
            self.report.assumptions.append(note)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        report = self.report
        report.prim_counts[name] = report.prim_counts.get(name, 0) + 1
        schema = func._schema
        bound = dict(zip((a.name for a in schema.arguments), args))
        bound.update(kwargs)

        if name in _SCATTERS and self._is_scatter(name, bound):
            if self.unique_slots:
                self._note(f"aten.{name} without accumulation is "
                           "order-safe only under the unique-slots call "
                           "contract")
            else:
                report.hazards.append({
                    "rule": "scatter-duplicate-order",
                    "prim": f"aten.{name}",
                    "detail": "duplicate indices pick an unspecified "
                              "(device-dependent) winner",
                })

        if name in _REDUCES and any(
                t.is_floating_point() for t in _tensors(list(args))):
            report.hazards.append({
                "rule": "nonassoc-float-reduce",
                "prim": f"aten.{name}",
                "detail": "floating-point reduction on the merge path: "
                          "float addition is not associative, result "
                          "depends on reduction order",
            })

        if name.startswith("rand") or name in _PRNG:
            report.hazards.append({
                "rule": "prng-in-merge",
                "prim": f"aten.{name}",
                "detail": "PRNG op inside a merge: the join is not a "
                          "function of its inputs",
            })

        written = [bound.get(a.name) for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if any(_storage(t) in self.inputs for w in written
               for t in _tensors(w)):
            self._note(f"aten.{name} writes an input tensor in place: "
                       "the caller must not reuse the written buffer as "
                       "the old state")
        return func(*args, **kwargs)

    @staticmethod
    def _is_scatter(name: str, bound: dict) -> bool:
        if name.startswith("index_put"):
            if bound.get("accumulate", False):
                return False
            return any(t.dtype not in (torch.bool, torch.uint8)
                       for t in _tensors(bound.get("indices", ())))
        return "src" in bound or "value" in bound


def audit_target(target: AuditTarget) -> AuditReport:
    fn, args = target.build()
    report = AuditReport(target=target.name)
    # (an empty tensor's storage has no address to match)
    inputs = {_storage(t) for t in _tensors(list(args))} - {0}
    from ..obs import device as obs_device
    before = sum(obs_device.launches().values())
    with _Recorder(report, target.unique_slots, inputs):
        fn(*args)
    if target.kernel is not None \
            and sum(obs_device.launches().values()) > before:
        report.assumptions.append(
            f"{target.kernel} launch is opaque to the op audit; the law "
            f"target {target.law} holds the kernel")
    return report


def audit_all(targets: Sequence[AuditTarget]
              ) -> Tuple[List[AuditReport], List[Finding]]:
    reports: List[AuditReport] = []
    findings: List[Finding] = []
    for target in targets:
        try:
            report = audit_target(target)
        except Exception as e:  # a target that fails to run at all
            findings.append(Finding(
                rule="audit-run-error", path=f"<audit:{target.name}>",
                line=0,
                message=f"target failed to run: {type(e).__name__}",
                detail=str(e)))
            continue
        reports.append(report)
        for hz in report.hazards:
            findings.append(Finding(
                rule=hz["rule"], path=f"<audit:{target.name}>", line=0,
                message=f"{hz['prim']}: {hz['detail']}"))
    return reports, findings


# --- builtin targets over the registered ops ---

_N = 64      # store width for scalar/dense targets
_M = 8       # changeset rows


def builtin_targets(device=None) -> List[AuditTarget]:
    """Audit targets over every registered merge/join op, under the JAX
    package's target names, with inputs on ``device`` (``None``: the
    CUDA card, a raise without one)."""
    from ..ops import dense as dense_ops
    from ..ops import digest as digest_ops
    from ..ops import merge as merge_ops
    from ..ops.fanin_kernel import model_fanin_batch
    from ..ops.ingest_kernel import ingest_scatter
    from ..ops.stream_kernel import fanin_step
    from ..parallel import collective as pc
    from ..parallel import fanin as pf
    from ..semantics import audit_targets as _semantics_audit_targets
    from ..semantics import kernels as sem_kernels

    device = resolve_device(device)

    def z(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def i64(*s):
        return z(torch.int64, *s)

    def i32(*s):
        return z(torch.int32, *s)

    def b8(*s):
        return z(torch.bool, *s)

    def dense_store(n=_N):
        return dense_ops.empty_dense_store(n, device)

    def dense_cs(rows=_M, n=_N):
        return dense_ops.DenseChangeset(
            lt=i64(rows, n), node=i32(rows, n), val=i64(rows, n),
            tomb=b8(rows, n), valid=b8(rows, n))

    def scalar_cs():
        return merge_ops.Changeset(slot=i32(_M), lt=i64(_M), node=i32(_M),
                                   tomb=b8(_M), valid=b8(_M))

    def slots(k=_M):
        return torch.arange(k, dtype=torch.int64, device=device)

    targets: List[AuditTarget] = []
    add = targets.append

    add(AuditTarget(
        name="merge.merge_step", unique_slots=True,
        notes="host key->slot dict cannot repeat a slot",
        build=lambda: (merge_ops.merge_step, (
            merge_ops.empty_store(_N, device), scalar_cs(), 0, 0, 0))))

    add(AuditTarget(
        name="merge.scatter_put", unique_slots=True,
        notes="host key->slot dict cannot repeat a slot",
        build=lambda: (merge_ops.scatter_put, (
            merge_ops.empty_store(_N, device), scalar_cs(), i64(_M),
            i32(_M)))))

    add(AuditTarget(
        name="dense.fanin_step",
        notes="elementwise fold; no scatter at all",
        build=lambda: (dense_ops.fanin_step, (
            dense_store(), dense_cs(), 0, 0, 0))))

    add(AuditTarget(
        name="dense.fanin_stream",
        notes="the plain chunk walk of the stream replay (two chunks)",
        build=lambda: (
            lambda s, c: _plain_fanin_stream(s, c, 2),
            (dense_store(), dense_cs()))))

    add(AuditTarget(
        name="dense.sparse_fanin_step", unique_slots=True,
        notes="dict-keyed delta cannot repeat a slot",
        build=lambda: (dense_ops.sparse_fanin_step, (
            dense_store(), slots(), i64(_M), i32(_M), i64(_M), b8(_M),
            b8(_M), 0, 0))))

    add(AuditTarget(
        name="dense.wire_join_step",
        notes="elementwise slot-aligned join; no gather, no scatter",
        build=lambda: (dense_ops.wire_join_step, (
            dense_store(), i64(_N), i32(_N), i64(_N), b8(_N), b8(_N),
            0, 0))))

    add(AuditTarget(
        name="dense.put_scatter", unique_slots=True,
        notes="dict-keyed batch cannot repeat a slot",
        build=lambda: (dense_ops.put_scatter, (
            dense_store(), slots(), i64(_M), 0, 0, b8(_M)))))

    add(AuditTarget(
        name="dense.record_scatter", unique_slots=True,
        notes="dict-keyed batch cannot repeat a slot",
        build=lambda: (dense_ops.record_scatter, (
            dense_store(), slots(), i64(_M), i32(_M), i64(_M), i64(_M),
            i32(_M), b8(_M)))))

    add(AuditTarget(
        name="dense.delete_scatter", unique_slots=True,
        notes="dict-keyed batch cannot repeat a slot",
        build=lambda: (dense_ops.delete_scatter, (
            dense_store(), slots(), 0, 0))))

    add(AuditTarget(
        name="dense.merge_repack_step", unique_slots=True,
        notes="fused gossip-relay join + next-pack delta mask; "
              "dict-keyed delta cannot repeat a slot",
        build=lambda: (dense_ops.merge_repack_step, (
            dense_store(), slots(), i64(_M), i32(_M), i64(_M), b8(_M),
            b8(_M), 0, 0, 0))))

    add(AuditTarget(
        name="digest.digest_tree_levels",
        notes="segment-tree digest: per-slot mix + leaf fold + every "
              "interior combine; read-only over the lanes",
        build=lambda: (digest_ops.digest_levels_from_lanes, (
            i64(_N), i64(_N), b8(_N), b8(_N), None, 8))))

    add(AuditTarget(
        name="dense.range_delta_mask",
        notes="slot-span-restricted delta mask feeding "
              "pack_since(ranges=...); elementwise, no scatter",
        build=lambda: (dense_ops.dense_range_delta_mask, (
            dense_store(), 0, i64(2), i64(2)))))

    add(AuditTarget(
        name="dense.gc_purge",
        notes="epoch tombstone purge: elementwise lane masking under "
              "one stability-floor predicate",
        build=lambda: (dense_ops.gc_purge, (dense_store(), 0))))

    add(AuditTarget(
        name="dense.compact_remap", unique_slots=True,
        notes="slot remap to span-dense prefixes: targets are a per-span "
              "survivor rank, bijective over occupied rows",
        build=lambda: (
            lambda s, lo, hi: dense_ops.compact_remap(s, lo, hi, None,
                                                      leaf_width=8),
            (dense_store(), torch.tensor([0, 32], device=device),
             torch.tensor([32, 64], device=device)))))

    add(AuditTarget(
        name="semantics.typed_sparse_join_step", unique_slots=True,
        notes="dict-keyed delta cannot repeat a slot",
        build=lambda: (sem_kernels.typed_sparse_join_step, (
            dense_store(), z(torch.int8, _M), slots(), i64(_M), i32(_M),
            i64(_M), b8(_M), b8(_M), 0, 0))))

    add(AuditTarget(
        name="semantics.typed_fanin_step",
        notes="elementwise typed fold; no scatter at all",
        build=lambda: (sem_kernels.typed_fanin_step, (
            dense_store(), z(torch.int8, _N), dense_cs(), 0, 0, 0))))

    targets.extend(_semantics_audit_targets(device))

    add(AuditTarget(
        name="pallas.pallas_fanin_step[interpret]",
        notes="K3's wrapper (one chunk): the plain chunk walk on CPU "
              "tensors, the kernel on the card",
        kernel="crdt_tpu_torch/csrc/fanin_stream.cu",
        law="pallas.pallas_fanin_step[exact]",
        build=lambda: (fanin_step, (dense_store(), dense_cs(2), 0, 0, 0))))

    add(AuditTarget(
        name="pallas.ingest_scatter_tiles[interpret]", unique_slots=True,
        notes="K2's wrapper; the combiner dedups slots before the commit",
        kernel="crdt_tpu_torch/csrc/ingest_scatter.cu",
        law="pallas.ingest_scatter_tiles",
        build=lambda: (ingest_scatter, (
            dense_store(), slots(), i64(_M), i64(_M), b8(_M), 0))))

    add(AuditTarget(
        name="parallel.pallas_fanin_block[per-shard]",
        notes="K1's wrapper at one key shard (R=16): the per-block body "
              "of the sharded step, between the combines",
        kernel="crdt_tpu_torch/csrc/fanin_batch.cu",
        law="parallel.pallas_fanin_block",
        build=lambda: (model_fanin_batch, (
            dense_store(), dense_cs(16), 0, 0, 0))))

    def sharded(reference: bool):
        mesh = pf.make_fanin_mesh(2, 4, devices=[device] * 8)
        step = pf.make_sharded_fanin(mesh, reference=reference)
        n = 4 * 16
        store = pf.shard_store(dense_store(n), mesh)
        cs = pf.shard_changeset(dense_cs(2 * 8, n), mesh)
        return step, (store, cs, 0, 0, 0)

    add(AuditTarget(
        name="parallel.sharded_fanin[mesh2x4]",
        notes="the sharded step's plain per-block join and combine",
        build=lambda: sharded(True)))

    add(AuditTarget(
        name="parallel.sharded_pallas_fanin[mesh2x4]",
        notes="the sharded step: K1 per block on the card, then the "
              "combine",
        kernel="crdt_tpu_torch/csrc/fanin_batch.cu",
        law="parallel.pallas_fanin_block",
        build=lambda: sharded(False)))

    def collective():
        mesh = pc.make_collective_mesh(2, devices=[device] * 2)
        # has_sem=True so the audit walks every typed join branch.
        step = pc.make_collective_join(mesh, True, 8)
        return step, ((dense_store(), dense_store()), z(torch.int8, _N),
                      i64(2), i32(2), 0)

    add(AuditTarget(
        name="parallel.collective_join[member2]",
        notes="pod-local group join: lex-max clock join + typed-"
              "semantics group joins + in-program digest leaves",
        build=collective))

    return targets


def _plain_fanin_stream(store, cs, n_chunks: int):
    """The stream replay's plain chunk walk: the JAX package's
    ``dense.fanin_stream`` (a scan over chunks) is this package's
    `ops.stream_kernel.fanin_stream_reference`."""
    from ..ops.stream_kernel import fanin_stream_reference
    return fanin_stream_reference(store, cs, 0, 0, 0, n_chunks=n_chunks)
