"""Co-located replicas converging through the collective group join.

Set-up builds ``members`` `DenseCrdt` replicas of the configuration's
slots, member ``i`` on card ``i`` (on fewer cards, round robin), joins
them as one `CollectiveGroup` on its default mesh, draws every round's
writes from the seed, and runs ``warmup_rounds`` rounds. A round: every
member writes ``rows_per_member`` slots with one ``put_batch``, then
one ``CollectiveGroup.join``, whose report (a host copy) ends it. A
share ``contended`` of a round's slots is written by several members
in that round; the rest are distinct across the members, and all are
fresh until the seed's permutation of the slots is used up. Every
member's wall clock reads the configuration's base millisecond plus the
round's number, so the writes of one round carry one stamp and the node
id decides a contended slot. Rounds run back to back until the window
has lasted ``--seconds``.

``correct``: after the last round, every member's lanes on its own card
against the writes (``reference/group.py``): each written slot holds the
value, tombstone and writer of its last round's greatest writer, no
other slot is occupied, the members agree lane for lane, a round's
stamps follow every earlier round's, and each clock is the store's
newest stamp.
"""

from __future__ import annotations

import time

import numpy as np

from crdtbench.harness import Check, Outcome
from crdtbench.reference import group


def plan(n: int, members: int, rows: int, seed: int, contended: float):
    """Every round's slots, ``[members, rows]`` a round, drawn from the
    seed one permutation of the slots at a time, fresh until the
    permutation is used up. In the first ``contended * rows`` columns
    every member after the first writes the first member's slot with
    probability one half, so one to ``members`` members write each of
    them in the round; every other slot of the round has one writer. An
    iterator over rounds; the next permutation is drawn when one is used
    up."""
    per = members * rows
    shared = round(contended * rows)
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for k in range(n // per):
            slots = perm[k * per:(k + 1) * per].reshape(members, rows)
            take = rng.random((members - 1, shared)) < 0.5
            slots[1:, :shared] = np.where(take, slots[0, :shared],
                                          slots[1:, :shared])
            yield slots


def run(ctx, group_hook=None) -> Outcome:
    """One run. ``group_hook(group)`` may replace the group's methods
    (the tests' planted faults)."""
    from crdt_tpu_torch import CollectiveGroup
    from crdt_tpu_torch.models.dense_crdt import DenseCrdt
    from crdt_tpu_torch.parallel import make_collective_mesh
    cfg, p = ctx.config, ctx.params
    n, m, rows = cfg["n_slots"], p["members"], p["rows_per_member"]
    cards = [ctx.devices[i % len(ctx.devices)] for i in range(m)]
    wall = [cfg["group_wall_base_ms"]]
    members = [DenseCrdt(f"m{i}", n, device=d, wall_clock=lambda: wall[0])
               for i, d in enumerate(cards)]
    mesh = make_collective_mesh(m, cards)
    grp = CollectiveGroup(members, mesh=mesh)
    if group_hook is not None:
        group_hook(grp)
    rounds = plan(n, m, rows, ctx.seed, p["contended"])
    written = []                 # (slots, values) of every round run

    def round_(r: int) -> float:
        """One round; the join call's seconds."""
        slots = next(rounds)
        wall[0] = cfg["group_wall_base_ms"] + r
        vals = (r * m * rows + np.arange(m * rows, dtype=np.int64)
                ).reshape(m, rows) + 1
        for i, mem in enumerate(members):
            with ctx.span("write"):
                mem.put_batch(slots[i], vals[i])
        written.append((slots, vals))
        t = time.perf_counter()
        with ctx.span("join"):
            grp.join()
        return time.perf_counter() - t

    r = 0
    for r in range(p["warmup_rounds"]):
        round_(r)
    ctx.sync()
    join_s, traced_rounds = [], 0

    def timed():
        nonlocal r
        r += 1
        join_s.append(round_(r))

    ctx.settle()
    with ctx.profiling():
        t0 = time.perf_counter()
        ctx.window_opens(t0)
        if ctx.traced:
            # The traced slice: the window's first rounds.
            ctx.slice_begins()
            while traced_rounds == 0 or \
                    time.perf_counter() - t0 < p["trace_seconds"]:
                timed()
                traced_rounds += 1
            ctx.slice_ends()
    while not join_s or time.perf_counter() - t0 < ctx.seconds:
        timed()
    window_s = time.perf_counter() - t0
    rounds = len(join_s)
    out = Outcome(window_s=window_s, attempted=rounds,
                  memory_peak_bytes=ctx.memory_peak())
    out.samples["unit_s"] = join_s
    # Every member takes in the other members' writes of the round.
    out.counts["records_in_window"] = rounds * m * rows * (m - 1)
    out.counts["traced_joins"] = traced_rounds

    got = [_member_state(mem) for mem in members]
    del members, grp
    verdict = group.check(np.stack([w[0] for w in written]),
                          np.stack([w[1] for w in written]), n,
                          [f"m{i}" for i in range(m)], got)
    out.checks = [Check(k, v, 0) for k, v in verdict.items()]
    return out


def _member_state(crdt) -> dict:
    """A member's lanes on the host, node ordinals as ids."""
    st = crdt.store
    table = np.array([str(t) for t in crdt._table.ids()], object)
    lanes = {f: getattr(st, f).cpu().numpy()
             for f in ("lt", "node", "val", "tomb", "occupied")}
    lanes["node"] = table[np.clip(lanes["node"], 0, len(table) - 1)]
    lanes["canonical"] = crdt.canonical_time.logical_time
    return lanes


def control(ctx) -> dict:
    """The control at the cell's size: the plain group
    (``reference/group.py``), joined as a ring in which each member takes
    in only its neighbour's lanes, in the program's place."""
    cfg, p = ctx.config, ctx.params
    n, m, rows = cfg["n_slots"], p["members"], p["rows_per_member"]
    rounds = p["warmup_rounds"] + int(ctx.seconds * p["control_rounds_per_s"])
    it = plan(n, m, rows, ctx.seed, p["contended"])
    slots = np.stack([next(it) for _ in range(rounds)])
    values = (np.arange(rounds * m * rows, dtype=np.int64) + 1).reshape(
        rounds, m, rows)
    ids = [f"m{i}" for i in range(m)]
    got = group.ring_rounds(slots, values, n, ids)
    return group.check(slots, values, n, ids, got)
