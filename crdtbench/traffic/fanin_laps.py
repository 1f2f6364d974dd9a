"""Fan-in laps: a fresh, empty replica absorbs the same peer backlog
again and again.

Set-up draws ``changesets`` changesets of ``rows_per_changeset`` rows
over the configuration's slots on the card, from the run's seed, and
runs ``warmup_laps`` laps. A lap builds an empty `DenseCrdt`, merges
every changeset through ``DenseCrdt.merge`` inside one ``pipelined()``
window and ends with the window's fence (its one readback). Laps run
back to back until the window has lasted ``--seconds``; nothing is
generated inside it. The replica's wall clock reads a fixed time, so the
reference can work out every ``modified`` stamp and the final clock.

``correct``: the replica of the last lap and of two laps drawn from the
seed, every lane of every slot and the clock, against the plain fold of
the same changesets (``reference/lww_fold.py``).
"""

from __future__ import annotations

import random
import time

from crdtbench import data, roofline
from crdtbench.harness import Check, Outcome
from crdtbench.reference import lww_fold


def _replica_lanes(crdt, ids) -> dict:
    """A replica's state in the fold's terms (node ids as ranks)."""
    st = crdt.store
    table = [str(t) for t in crdt._table.ids()]
    return dict(lt=st.lt.long(), val=st.val.long(), tomb=st.tomb.bool(),
                mod_lt=st.mod_lt.long(), occupied=st.occupied.bool(),
                node=lww_fold.ranks_of(st.node, table, ids),
                mod_node=lww_fold.ranks_of(st.mod_node, table, ids),
                canonical=crdt.canonical_time.logical_time)


def run(ctx, model=None) -> Outcome:
    """One run. ``model`` replaces the replica class (the tests' planted
    faults); by default the port's `DenseCrdt`."""
    from crdt_tpu_torch.ops.dense import DenseChangeset
    if model is None:
        from crdt_tpu_torch.models.dense_crdt import DenseCrdt as model
    cfg, p = ctx.config, ctx.params
    dev = ctx.devices[0]
    n, rows = cfg["n_slots"], p["rows_per_changeset"]
    peers, hub = cfg["peer_ids"], cfg["hub_id"]
    wall = data.MILLIS + cfg["wall_offset_ms"]
    inputs = [data.changeset(rows, n, data.sub_seed(ctx.seed, i), dev)
              for i in range(p["changesets"])]
    changesets = [DenseChangeset(**c) for c in inputs]
    records = sum(int(c["valid"].sum().item()) for c in inputs)
    host_merge_s = []

    def lap(spans: bool):
        crdt = model(hub, n, node_ids=peers, device=dev,
                     wall_clock=lambda: wall)
        with ctx.span("lap"), crdt.pipelined():
            for cs in changesets:
                if spans:
                    t = time.perf_counter()
                    with ctx.span("merge"):
                        crdt.merge(cs, peers)
                    host_merge_s.append(time.perf_counter() - t)
                else:
                    crdt.merge(cs, peers)
        return crdt

    for _ in range(p["warmup_laps"]):
        lap(False)
    ctx.sync()
    pick = random.Random(ctx.seed)
    kept, lap_s, traced_laps = [], [], 0

    def timed(spans: bool):
        t = time.perf_counter()
        crdt = lap(spans)
        lap_s.append(time.perf_counter() - t)
        # Two laps drawn from the seed, by reservoir, and the last.
        if len(kept) < 2:
            kept.append(crdt)
        elif pick.random() < 2 / len(lap_s):
            kept[pick.randrange(2)] = crdt
        return crdt

    ctx.settle()
    with ctx.profiling():
        t0 = time.perf_counter()
        ctx.window_opens(t0)
        if ctx.traced:
            # The traced slice: the window's first laps.
            ctx.slice_begins()
            while traced_laps == 0 or \
                    time.perf_counter() - t0 < p["trace_seconds"]:
                crdt = timed(True)
                traced_laps += 1
            ctx.slice_ends()
    while not lap_s or time.perf_counter() - t0 < ctx.seconds:
        crdt = timed(ctx.traced)
    window_s = time.perf_counter() - t0
    kept.append(crdt)
    laps = len(lap_s)
    out = Outcome(window_s=window_s, attempted=laps * len(changesets),
                  memory_peak_bytes=ctx.memory_peak())
    out.samples["unit_s"] = lap_s
    out.samples["merge_host_s"] = host_merge_s
    out.counts["records_in_window"] = records * laps
    out.counts["traced_laps"] = traced_laps

    # The plain fold, once the window has closed.
    got = [_replica_lanes(c, sorted(set(peers) | {hub})) for c in kept]
    del crdt, kept
    lap_bytes = []
    want = lww_fold.fold(
        inputs, peers, hub, wall,
        on_merge=lambda v, f, w: lap_bytes.append(
            roofline.merge_bytes(v, f, w)))
    out.counts["lap_bytes"] = sum(lap_bytes)
    out.checks = [
        Check("slots_differing",
              sum(lww_fold.mismatches(want, g) for g in got), 0),
        Check("clocks_differing",
              sum(g["canonical"] != want["canonical"] for g in got), 0)]
    return out


def control(ctx) -> dict:
    """The control at the cell's size: the plain fold with the node
    tie-break left out, in the program's place, against the fold."""
    p, cfg = ctx.params, ctx.config
    dev = ctx.devices[0]
    inputs = [data.changeset(p["rows_per_changeset"], cfg["n_slots"],
                             data.sub_seed(ctx.seed, i), dev)
              for i in range(p["changesets"])]
    wall = data.MILLIS + cfg["wall_offset_ms"]
    want = lww_fold.fold(inputs, cfg["peer_ids"], cfg["hub_id"], wall)
    got = lww_fold.fold(inputs, cfg["peer_ids"], cfg["hub_id"], wall,
                        node_tiebreak=False)
    return {"slots_differing": lww_fold.mismatches(want, got),
            "clocks_differing": int(got["canonical"] != want["canonical"])}
