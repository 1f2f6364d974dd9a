"""Seeded counterexample search for the semilattice laws.

Port of ``crdt_tpu/analysis/lattice_laws.py``. The convergence
guarantee reduces to three properties of the join the merge ops
implement:

    idempotence     join(s, a) twice == once
    commutativity   join(join(s, a), b) == join(join(s, b), a)
    associativity   join over [a ++ b] == join over a, then over b

Each :class:`LawTarget` wraps one merge op and a way to combine deltas,
and ``run_laws`` drives seeded record batches through it, reporting the
violating input (seed, lanes, both results) when a law fails. The
builtin targets are the JAX package's, each over this package's plain
op of the same name, plus one target per hand kernel (K1, K1s, K3, K2
and K1p), named after the Pallas entries the JAX package's op audit
traces: a CUDA launch is opaque to any trace, so the laws, run on the
kernel itself, are what holds it. On CPU tensors those wrappers take
their plain versions; on the card they launch the kernels (the launch
counters of `obs.device` show it). Lanes stay on the target's device
and are compared there with ``torch.equal``; only a failure's detail
comes to the host.

Two scoping decisions keep the check honest rather than vacuous:

- **Compared lanes** are (lt, node, val, occupied, tomb) — the CRDT
  state. ``mod_lt``/``mod_node`` stamp local apply time and are
  order-dependent BY DESIGN (stamping is bookkeeping, not lattice
  state), so they are excluded.
- **Event uniqueness**: generated batches derive ``val``
  deterministically from ``(lt, node)``. Two replicas never emit
  different values for the same HLC stamp, so value disagreement under
  reordering is a real law violation, not generator noise. Without
  this, commutativity is unfalsifiable (ties broken either way are
  both "right").

Targets whose batch semantics forbid duplicate slots within one delta
(the scatter-based steps) set ``combine=None`` and are checked for
idempotence + commutativity only — associativity's concatenation
would manufacture exactly the duplicate-slot batches the call contract
excludes.

Every ``apply`` leaves its input store as it was (the in-place ops run
on a clone), so ``once`` and ``twice`` are two states, not one object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.devices import resolve_device
from .findings import Finding

# Lanes that ARE lattice state; mod_lt/mod_node are stamping
# bookkeeping and order-dependent by design.
_STATE_LANES = ("lt", "node", "val", "occupied", "tomb")

_LOCAL_NODE = 0          # generated events use nodes 1..4: never the
                         # local node, so recv-side self-echo guards
                         # cannot mask a law violation
_WALL = 1 << 30          # far future => drift guard never clamps


@dataclass
class LawTarget:
    """One merge step under law checking.

    ``apply(store, batch) -> store`` runs the op. ``fresh()`` builds an
    empty store. ``gen(rng) -> batch`` draws one randomized delta from a
    numpy ``default_rng``. ``combine(a, b) -> batch`` concatenates two
    deltas for the associativity check; None skips that law (per-call
    uniqueness contracts). ``extract(store) -> dict[lane, tensor or
    ndarray]`` pulls the compared lanes."""

    name: str
    fresh: Callable[[], object]
    gen: Callable[[object], object]
    apply: Callable[[object, object], object]
    extract: Callable[[object], dict]
    combine: Optional[Callable[[object, object], object]] = None
    notes: str = ""


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lane_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.device == b.device:
        return torch.equal(a, b)
    return np.array_equal(_host(a), _host(b))


def _stores_equal(a: dict, b: dict) -> bool:
    return all(_lane_equal(a[k], b[k]) for k in _STATE_LANES)


def _diff_detail(a: dict, b: dict, labels: Tuple[str, str]) -> str:
    lines: List[str] = []
    for k in _STATE_LANES:
        if _lane_equal(a[k], b[k]):
            continue
        av, bv = _host(a[k]), _host(b[k])
        idx = np.argwhere(av != bv)
        lines.append(f"lane '{k}' differs at {len(idx)} slot(s); "
                     f"first at {tuple(int(i) for i in idx[0])}: "
                     f"{labels[0]}={av[tuple(idx[0])]} "
                     f"{labels[1]}={bv[tuple(idx[0])]}")
    return "\n".join(lines)


def _batch_repr(batch: object) -> str:
    if isinstance(batch, dict):
        items = batch.items()
    elif hasattr(batch, "_asdict"):
        items = batch._asdict().items()
    elif hasattr(batch, "__dict__"):
        items = vars(batch).items()
    else:
        return repr(batch)
    lines = []
    for k, v in items:
        arr = _host(v)
        with np.printoptions(threshold=64, linewidth=100):
            lines.append(f"{k} = {arr!r}")
    return "\n".join(lines)


def check_target(target: LawTarget, seed: int) -> List[Finding]:
    """Run all applicable laws on one target with one seed."""
    rng = np.random.default_rng(seed)
    findings: List[Finding] = []
    path = f"<law:{target.name}>"
    a = target.gen(rng)
    b = target.gen(rng)

    def fail(law: str, a_res: dict, b_res: dict,
             labels: Tuple[str, str], batches: Sequence) -> None:
        detail = _diff_detail(a_res, b_res, labels)
        detail += "\nviolating input (seed={}):\n".format(seed)
        for i, batch in enumerate(batches):
            detail += f"-- batch {i} --\n{_batch_repr(batch)}\n"
        findings.append(Finding(
            rule=f"law-{law}", path=path, line=0,
            message=f"{law} violated by {target.name} "
                    f"(seed={seed}); counterexample below",
            detail=detail.rstrip()))

    # idempotence: applying the same delta twice is a no-op
    once = target.apply(target.fresh(), a)
    twice = target.apply(once, a)
    e_once, e_twice = target.extract(once), target.extract(twice)
    if not _stores_equal(e_once, e_twice):
        fail("idempotence", e_once, e_twice, ("once", "twice"), [a])

    # commutativity: delta application order must not matter
    ab = target.apply(target.apply(target.fresh(), a), b)
    ba = target.apply(target.apply(target.fresh(), b), a)
    e_ab, e_ba = target.extract(ab), target.extract(ba)
    if not _stores_equal(e_ab, e_ba):
        fail("commutativity", e_ab, e_ba, ("a,b", "b,a"), [a, b])

    # associativity: one combined delta == two sequential deltas
    if target.combine is not None:
        joint = target.apply(target.fresh(), target.combine(a, b))
        e_joint = target.extract(joint)
        if not _stores_equal(e_ab, e_joint):
            fail("associativity", e_ab, e_joint,
                 ("sequential", "combined"), [a, b])

    return findings


def run_laws(targets: Sequence[LawTarget],
             seeds: Sequence[int] = (0, 1, 2)) -> List[Finding]:
    findings: List[Finding] = []
    for target in targets:
        for seed in seeds:
            hits = check_target(target, seed)
            findings.extend(hits)
            if hits:
                break   # one counterexample per target is enough
    return findings


# --- builtin targets over the registered ops and kernels ---

_N = 64          # store width for law batches
_R = 8           # rows per delta
_CHUNKS = 4      # the stream kernel's replays per law batch


def _event_lanes(rng, size) -> tuple:
    """(lt, node, val, tomb) with the event-uniqueness invariant: val
    and tomb are deterministic functions of (lt, node), so identical
    stamps can never carry different payloads — otherwise ties broken
    either way are both 'right' and commutativity is unfalsifiable."""
    millis = rng.integers(1, 1 << 20, size=size)
    counter = rng.integers(0, 4, size=size)
    lt = ((millis << 16) | counter).astype(np.int64)
    node = rng.integers(1, 5, size=size).astype(np.int32)  # != local 0
    val = ((lt * 31 + node * 7) & 0x7FFF).astype(np.int64)
    tomb = ((lt ^ node) & 1).astype(bool)
    return lt, node, val, tomb


def _gen_sparse(rng, n: int, rows: int) -> dict:
    lt, node, val, tomb = _event_lanes(rng, rows)
    return {"slot": rng.integers(0, n, size=rows).astype(np.int64),
            "lt": lt, "node": node, "val": val, "tomb": tomb,
            "valid": np.ones(rows, dtype=bool)}


def _gen_dense(rng, n: int) -> dict:
    """Full-width wire delta (one lane value per slot, valid mask)."""
    lt, node, val, tomb = _event_lanes(rng, n)
    valid = rng.integers(0, 2, size=n).astype(bool)
    return {"lt": np.where(valid, lt, 0),
            "node": np.where(valid, node, 0).astype(np.int32),
            "val": np.where(valid, val, 0),
            "tomb": valid & tomb, "valid": valid}


def _wire_combine(a: dict, b: dict) -> dict:
    """Elementwise lattice max of two wire deltas: per slot keep the
    (lt, node)-lex greater valid event (equal stamps carry equal
    payloads by the uniqueness invariant, so >= is safe)."""
    a_newer = ((a["lt"] > b["lt"])
               | ((a["lt"] == b["lt"]) & (a["node"] >= b["node"])))
    a_wins = a["valid"] & (~b["valid"] | a_newer)
    out = {}
    for k in ("lt", "node", "val", "tomb", "valid"):
        out[k] = np.where(a_wins, a[k], b[k])
    out["valid"] = a["valid"] | b["valid"]
    return out


def _extract_store(store) -> dict:
    return {k: getattr(store, k) for k in _STATE_LANES}


def _clone(store):
    return type(store)(*(lane.clone() for lane in store))


def _dev(x, device, dtype):
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def _wire_lanes(batch: dict, device) -> tuple:
    return (_dev(batch["lt"], device, torch.int64),
            _dev(batch["node"], device, torch.int32),
            _dev(batch["val"], device, torch.int64),
            _dev(batch["tomb"], device, torch.bool),
            _dev(batch["valid"], device, torch.bool))


def make_wire_join_target(step: Callable, name: str, notes: str = "",
                          device=None) -> LawTarget:
    """LawTarget over a wire_join_step-shaped callable
    ``step(store, lt, node, val, tomb, valid, stamp_lt, local_node)``
    that joins in place. Public so the broken-merge fixture (and future
    ops) reuse the harness instead of reimplementing it."""
    from ..ops.dense import empty_dense_store
    device = resolve_device(device)

    def fresh():
        return empty_dense_store(_N, device)

    def gen(rng):
        return _gen_dense(rng, _N)

    def apply(store, batch):
        new_store, _win = step(_clone(store), *_wire_lanes(batch, device),
                               _WALL << 16, _LOCAL_NODE)
        return new_store

    return LawTarget(name=name, fresh=fresh, gen=gen, apply=apply,
                     extract=_extract_store, combine=_wire_combine,
                     notes=notes)


def _rows_to_grid(lanes: dict, key: str, dtype, n: int = _N):
    """Scatter R sparse rows into an [R, N] one-event-per-row grid —
    the DenseChangeset layout fanin_step folds over."""
    rows = len(lanes["slot"])
    grid = np.zeros((rows, n), dtype=dtype)
    r = np.arange(rows)
    grid[r, lanes["slot"]] = lanes[key] if key != "valid" \
        else lanes["valid"]
    mask = np.zeros((rows, n), dtype=bool)
    mask[r, lanes["slot"]] = lanes["valid"]
    if key != "valid":
        grid = np.where(mask, grid, np.zeros_like(grid))
    return grid.astype(dtype)


def _gen_grid(rng, n: int = _N, rows: int = _R) -> dict:
    """One event per row at a random slot, as [R, N] numpy lanes."""
    lanes = _gen_sparse(rng, n, rows)
    return {k: _rows_to_grid(lanes, k, dt, n)
            for k, dt in (("lt", np.int64), ("node", np.int32),
                          ("val", np.int64), ("tomb", bool),
                          ("valid", bool))}


def _grid_combine(a: dict, b: dict) -> dict:
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _changeset(batch, device):
    """A [R, N] batch (numpy dict, or a DenseChangeset of tensors) as a
    DenseChangeset on ``device``."""
    from ..ops.dense import CHANGESET_DTYPES, DenseChangeset
    if isinstance(batch, DenseChangeset):
        return batch
    return DenseChangeset(**{f: _dev(batch[f], device, dt)
                             for f, dt in CHANGESET_DTYPES.items()})


def _cat_changesets(a, b):
    from ..ops.dense import DenseChangeset
    return DenseChangeset(*(torch.cat([x, y]) for x, y in zip(a, b)))


def gen_dense_changeset(rng, n: int, rows: int, device, density=0.5):
    """A full-size ``[rows, n]`` changeset drawn on ``device`` from a
    torch generator seeded by ``rng``: each entry valid with probability
    ``density``, with the event-uniqueness invariant of `_event_lanes`
    (the kernel targets at the main path's shapes, where host drawing
    and copying would dominate)."""
    from ..ops.dense import DenseChangeset
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(0, 1 << 62)))

    def draw(lo, hi):
        return torch.randint(lo, hi, (rows, n), generator=g,
                             device=device, dtype=torch.int64)

    lt = (draw(1, 1 << 20) << 16) | draw(0, 4)
    node = draw(1, 5)
    valid = torch.rand((rows, n), generator=g, device=device) < density
    val = (lt * 31 + node * 7) & 0x7FFF
    tomb = ((lt ^ node) & 1).bool()
    return DenseChangeset(lt=torch.where(valid, lt, 0),
                          node=torch.where(valid, node, 0).to(torch.int32),
                          val=torch.where(valid, val, 0),
                          tomb=valid & tomb, valid=valid)


def _stream_target(device, n, rows, chunks, guards, gen) -> LawTarget:
    from ..ops.dense import empty_dense_store
    from ..ops.stream_kernel import fanin_stream

    def apply(store, batch):
        new_store, _res = fanin_stream(
            _clone(store), _changeset(batch, device), 0, _LOCAL_NODE,
            _WALL, n_chunks=chunks, guards=guards)
        return new_store

    return LawTarget(
        name=f"pallas.pallas_fanin_step[{guards}]",
        fresh=lambda: empty_dense_store(n, device), gen=gen, apply=apply,
        extract=_extract_store,
        combine=lambda a, b: _cat_changesets(_changeset(a, device),
                                             _changeset(b, device)),
        notes=f"K3 (csrc/fanin_stream.cu): one changeset replayed over "
              f"{chunks} chunks, {guards} guards; all three laws, "
              "combine=row concatenation")


def kernel_targets(device=None, *, n: int = _N, rows: int = _R,
                   chunks: int = _CHUNKS, flush_rows: Optional[int] = None,
                   dense: bool = False) -> List[LawTarget]:
    """Law targets over the five hand-kernel wrappers, named after the
    Pallas entries the JAX package's op audit traces. ``n`` slots,
    ``rows`` rows a delta, ``chunks`` stream replays, ``flush_rows``
    rows a K2 flush (default ``n // 4``); ``dense`` draws full-size
    batches on the device (`gen_dense_changeset`) instead of one event
    per row from numpy. On CPU tensors the wrappers take their plain
    versions; on the card they launch the kernels."""
    from ..ops.dense import empty_dense_store
    from ..ops.fanin_kernel import model_fanin_batch, model_fanin_split
    from ..ops.ingest_kernel import ingest_scatter
    from ..ops.split import split_changeset, split_changeset_narrow
    from ..parallel.fanin import (gather_store, make_fanin_mesh,
                                  make_sharded_fanin, shard_changeset,
                                  shard_store)
    device = resolve_device(device)

    def gen(rng):
        if dense:
            return gen_dense_changeset(rng, n, rows, device)
        return _changeset(_gen_grid(rng, n, rows), device)

    def fresh():
        return empty_dense_store(n, device)

    def combine(a, b):
        return _cat_changesets(a, b)

    targets: List[LawTarget] = []

    def k1_apply(store, cs):
        new_store, _res, _seen, _ovf = model_fanin_batch(
            _clone(store), cs, 0, _LOCAL_NODE, _WALL)
        return new_store

    targets.append(LawTarget(
        name="pallas.model_fanin_batch", fresh=fresh, gen=gen,
        apply=k1_apply, extract=_extract_store, combine=combine,
        notes="K1 (csrc/fanin_batch.cu): R-row strict lex fold; all "
              "three laws, combine=row concatenation"))

    # K1s takes peer ordinals 0..3 through a node_map onto the local
    # ordinals 1..4 (the generated nodes less one), so the remap runs
    # inside the kernel on every row.
    node_map = torch.arange(1, 5, dtype=torch.int32, device=device)

    def split_gen(rng):
        cs = gen(rng)
        return cs._replace(node=torch.where(cs.valid, cs.node - 1, 0))

    for width, split in (("wide", split_changeset),
                         ("narrow", lambda cs: split_changeset_narrow(cs)[0])):
        def k1s_apply(store, cs, split=split):
            new_store, _res, _seen, _ovf = model_fanin_split(
                _clone(store), split(cs), node_map, 0, _LOCAL_NODE, _WALL)
            return new_store

        targets.append(LawTarget(
            name=f"pallas.model_fanin_split[{width}]", fresh=fresh,
            gen=split_gen, apply=k1s_apply, extract=_extract_store,
            combine=combine,
            notes=f"K1s (csrc/fanin_split.cu) on {width} split lanes with "
                  "a remapping node_map; all three laws"))

    for guards in ("exact", "fast"):
        targets.append(_stream_target(device, n, rows, chunks, guards, gen))

    # K2 commits a deduped flush by blind writes, so the target runs it
    # as the commit of a join: the rows that beat the store (a plain
    # strict (lt, node) compare) are committed by the kernel, every
    # other row becomes the n_slots sentinel, which writes nothing. A
    # flush is one node's (`me`); its slots are unique and in slot
    # order, as the combiner hands them over.
    k = flush_rows if flush_rows is not None else max(n // 4, 1)

    def k2_gen(rng):
        slots = np.sort(rng.choice(n, size=k, replace=False))
        lt, node, val, tomb = _event_lanes(rng, k)
        me = int(rng.integers(1, 5))
        node[:] = me
        val = ((lt * 31 + me * 7) & 0x7FFF).astype(np.int64)
        tomb = ((lt ^ me) & 1).astype(bool)
        return {"slot": _dev(slots, device, torch.int64),
                "lt": _dev(lt, device, torch.int64),
                "val": _dev(val, device, torch.int64),
                "tomb": _dev(tomb, device, torch.bool), "me": me}

    def k2_apply(store, batch):
        out = _clone(store)
        slot, lt, me = batch["slot"], batch["lt"], batch["me"]
        s_lt, s_node = out.lt[slot], out.node[slot]
        beats = ~out.occupied[slot] | (lt > s_lt) | (
            (lt == s_lt) & (me > s_node))
        # crdtlint: disable=scatter-combiner-bypass -- the law target commits into a private store of its own, which no ingest window stages into
        return ingest_scatter(out, torch.where(beats, slot, n), lt,
                              batch["val"], batch["tomb"], me)

    targets.append(LawTarget(
        name="pallas.ingest_scatter_tiles", fresh=fresh, gen=k2_gen,
        apply=k2_apply, extract=_extract_store, combine=None,
        notes="K2 (csrc/ingest_scatter.cu) committing the rows of a "
              "one-node flush that beat the store; unique-slot "
              "contract: idempotence + commutativity only"))

    # K1p: the sharded step over a (2, 2) mesh of this device.
    mesh = make_fanin_mesh(2, 2, devices=[device] * 4)
    step = make_sharded_fanin(mesh)

    def k1p_apply(store, cs):
        new_store, _res = step(store, shard_changeset(cs, mesh), 0,
                               _LOCAL_NODE, _WALL)
        return new_store

    targets.append(LawTarget(
        name="parallel.pallas_fanin_block",
        fresh=lambda: shard_store(empty_dense_store(n, device), mesh),
        gen=gen, apply=k1p_apply,
        extract=lambda st: _extract_store(gather_store(st)),
        combine=combine,
        notes="K1p: K1 per (replica, key) block of a (2, 2) mesh, then "
              "the combine; all three laws"))
    return targets


def builtin_targets(device=None) -> List[LawTarget]:
    """Law targets over the registered merge ops on ``device`` (the JAX
    package's, over this package's plain ops) and the hand kernels
    (`kernel_targets`). ``device=None`` is the CUDA card and raises
    without one; ``"cpu"`` takes the plain versions."""
    from ..ops import dense as dense_ops
    from ..ops.dense import DenseStore, empty_dense_store
    from ..parallel import collective as _pc
    device = resolve_device(device)

    targets: List[LawTarget] = [
        make_wire_join_target(
            dense_ops.wire_join_step, "dense.wire_join_step",
            notes="elementwise full-width join; all three laws",
            device=device),
    ]

    # sparse_fanin_step: scatter-based; call contract requires unique
    # slots per delta => no associativity (concatenation would
    # manufacture exactly the duplicate-slot batches the contract
    # excludes).
    def sparse_fresh():
        return empty_dense_store(_N, device)

    def sparse_gen(rng):
        lanes = _gen_sparse(rng, _N, _R)
        # unique slots per delta (dict-keyed deltas guarantee it in
        # production); keep the first occurrence of each slot
        _, first = np.unique(lanes["slot"], return_index=True)
        keep = np.zeros(_R, dtype=bool)
        keep[first] = True
        lanes["valid"] = lanes["valid"] & keep
        return lanes

    def sparse_apply(store, batch):
        new_store, _win = dense_ops.sparse_fanin_step(
            _clone(store), _dev(batch["slot"], device, torch.int64),
            *_wire_lanes(batch, device), _WALL << 16, _LOCAL_NODE)
        return new_store

    targets.append(LawTarget(
        name="dense.sparse_fanin_step", fresh=sparse_fresh,
        gen=sparse_gen, apply=sparse_apply, extract=_extract_store,
        combine=None,
        notes="unique-slot contract: idempotence + commutativity "
              "only"))

    # fanin_step: R-row masked fold into the store; rows may collide,
    # the fold resolves them — all three laws, combine = row concat.
    def fanin_apply(store, batch):
        new_store, _res = dense_ops.fanin_step(
            store, _changeset(batch, device), 0, _LOCAL_NODE, _WALL)
        return new_store

    targets.append(LawTarget(
        name="dense.fanin_step", fresh=sparse_fresh, gen=_gen_grid,
        apply=fanin_apply, extract=_extract_store,
        combine=_grid_combine,
        notes="R-row masked fold; all three laws, combine=row "
              "concatenation"))

    # The pod-local collective join, driven as a 2-member group where
    # one member plays the store and the other the incoming delta; the
    # laws read member 0's joined lanes.
    coll_mesh = _pc.make_collective_mesh(2, devices=[device] * 2)
    coll_step = _pc.make_collective_join(coll_mesh, False, 8)

    def coll_apply(store, batch):
        lt, node, val, tomb, valid = _wire_lanes(batch, device)
        other = DenseStore(
            lt=lt, node=node, val=val,
            mod_lt=torch.zeros(_N, dtype=torch.int64, device=device),
            mod_node=torch.zeros(_N, dtype=torch.int32, device=device),
            occupied=valid, tomb=tomb)
        members, _res = coll_step(
            (store, other), torch.zeros(2, dtype=torch.int64),
            torch.tensor([0, 1], dtype=torch.int32), 0)
        return members[0]

    targets.append(LawTarget(
        name="parallel.collective_join[member2]",
        fresh=sparse_fresh, gen=lambda rng: _gen_dense(rng, _N),
        apply=coll_apply, extract=_extract_store, combine=_wire_combine,
        notes="group join over a 2-member mesh; all three laws on "
              "member 0's lanes"))

    # --- storage plane ---
    #
    # dense.gc_purge: the COMPOSITE operator the deployed system runs
    # — floor-masked join (the merge-side resurrection fence, modeled
    # as its stability premise: nothing at or below the floor is
    # still in flight, so sub-floor inbound rows are masked) followed
    # by the purge at the same fixed floor. The fresh store is
    # pre-seeded with sub-floor tombstones AND sub-floor live rows,
    # so the purge genuinely fires (tombs vanish, live rows survive)
    # on every law path. All three laws on the above-floor
    # sublattice.
    _FLOOR = 1 << 30

    def gc_fresh():
        lt = np.zeros(_N, np.int64)
        node = np.zeros(_N, np.int32)
        val = np.zeros(_N, np.int64)
        occ = np.zeros(_N, bool)
        tomb = np.zeros(_N, bool)
        for i in range(8):
            lt[i] = _FLOOR - 1 - i
            node[i] = 1 + (i % 4)
            occ[i] = True
            tomb[i] = (i % 2 == 0)
            val[i] = 0 if tomb[i] else 100 + i
        return dense_ops.store_from_numpy(dict(
            lt=lt, node=node, val=val, mod_lt=np.zeros(_N, np.int64),
            mod_node=np.zeros(_N, np.int32), occupied=occ, tomb=tomb),
            device)

    def gc_apply(store, batch):
        stability_floor = _FLOOR   # fixed modeled watermark
        lt, node, val, tomb, valid = _wire_lanes(batch, device)
        fenced = valid & (lt > stability_floor)
        joined, _win = dense_ops.wire_join_step(
            _clone(store), lt, node, val, tomb, fenced, _WALL << 16,
            _LOCAL_NODE)
        purged, _count, _mask = dense_ops.gc_purge(joined,
                                                   stability_floor)
        return purged

    targets.append(LawTarget(
        name="dense.gc_purge", fresh=gc_fresh,
        gen=lambda rng: _gen_dense(rng, _N), apply=gc_apply,
        extract=_extract_store, combine=_wire_combine,
        notes="floor-masked join + purge at a fixed stability floor; "
              "all three laws on the above-floor sublattice, purge "
              "fires on the seeded sub-floor tombstones"))

    # dense.compact_remap: join laws preserved under the compaction
    # quotient — extract compares the REMAPPED lanes (full-span
    # compact), so law-equal stores must also compact identically:
    # the remap is a deterministic, slot-order-preserving function of
    # the store, never of the delivery order.
    def compact_extract(store):
        out = dense_ops.compact_remap(
            store, torch.tensor([0], device=device),
            torch.tensor([_N], device=device), None, leaf_width=8)
        new_store, _translation, _live, _levels = out
        return _extract_store(new_store)

    compacted = make_wire_join_target(
        dense_ops.wire_join_step, "dense.compact_remap",
        notes="wire join compared through the compaction quotient: "
              "the remap must be order-independent or replicas that "
              "compact diverge", device=device)
    compacted.extract = compact_extract
    targets.append(compacted)

    # The semantics registry contributes one typed wire-join target
    # per registered lane type — a new type gets law coverage by
    # registering, zero hand-listed targets.
    from ..semantics import law_targets as _semantics_law_targets
    targets.extend(_semantics_law_targets(device))

    targets.extend(kernel_targets(device))
    return targets
