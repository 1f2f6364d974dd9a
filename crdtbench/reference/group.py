"""What a group of LWW replicas must hold after rounds of writes, each
round ended by a join of the whole group, in plain numpy.

Round ``r``: member ``i`` writes ``values[r, i]`` at ``slots[r, i]``
with one stamp, then the group joins. Every write of a round is issued
after the previous round's join, which every member's clock has
absorbed, so it carries a stamp above every earlier round's; and every
member's wall clock reads the round's millisecond, so the writes of one
round carry the same stamp, and a slot that several members write in
one round goes to the greatest node id (last-writer-wins by (time,
node)). So each slot ends with its last round's greatest writer, whose
value, writer and tombstone (none) are known without the stamps. The
stamps themselves are held to what the clock guarantees: one stamp for
a member's batch, every round's above all earlier rounds', and each
member's clock at the newest stamp it holds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def expected(slots: np.ndarray, values: np.ndarray, n: int,
             ids: Sequence[str]) -> dict:
    """Each slot's winning write: value, writer id, round (-1: none).
    Within a round the members write in the order of their ids, so the
    greatest writer of a slot lands last."""
    val = np.zeros(n, np.int64)
    writer = np.full(n, "", object)
    rnd = np.full(n, -1, np.int64)
    by_id = sorted(range(len(ids)), key=lambda i: ids[i])
    for r in range(slots.shape[0]):
        for i in by_id:
            s = slots[r, i]
            val[s] = values[r, i]
            writer[s] = ids[i]
            rnd[s] = r
    return dict(val=val, writer=writer, round=rnd)


def check(slots: np.ndarray, values: np.ndarray, n: int, ids: List[str],
          members: List[Dict[str, np.ndarray]]) -> Dict[str, int]:
    """Counts of what no history allows, over ``members``' lanes
    (``lt``, ``node`` as ids, ``val``, ``tomb``, ``occupied``, and the
    ``canonical`` clock). The lanes of a slot no member holds are no
    record and are not compared."""
    want = expected(slots, values, n, ids)
    written = want["round"] >= 0
    wrong = 0
    for m in members:
        bad = m["occupied"] != written
        bad |= written & ((m["val"] != want["val"]) | m["tomb"]
                          | (m["node"] != want["writer"]))
        wrong += int(bad.sum())
    first = members[0]
    apart = np.zeros(n, bool)
    for m in members[1:]:
        apart |= m["occupied"] != first["occupied"]
        held = m["occupied"] | first["occupied"]
        for lane in ("lt", "node", "val", "tomb"):
            apart |= held & (m[lane] != first[lane])
    # Stamps, on the first member's lanes: one per (round, writer); each
    # round's lowest above every earlier round's highest.
    rnd, lt = want["round"][written], first["lt"][written]
    names = np.asarray(ids, str)
    by_id = np.argsort(names)
    writer = by_id[np.searchsorted(names[by_id],
                                   want["writer"][written].astype(str))]
    group_key = rnd * len(ids) + writer
    order = np.argsort(group_key, kind="stable")
    gk, glt = group_key[order], lt[order]
    starts = np.r_[0, np.nonzero(np.diff(gk))[0] + 1] if len(gk) else []
    g_min = np.minimum.reduceat(glt, starts) if len(gk) else glt
    g_max = np.maximum.reduceat(glt, starts) if len(gk) else glt
    torn = int((g_min != g_max).sum())
    g_round = gk[starts] // len(ids) if len(gk) else gk
    out_of_order = 0
    if len(gk):
        rounds = np.unique(g_round)
        r_min = np.array([g_min[g_round == r].min() for r in rounds])
        r_max = np.array([g_max[g_round == r].max() for r in rounds])
        out_of_order = int((np.maximum.accumulate(r_max)[:-1]
                            >= r_min[1:]).sum())
    clocks = sum(int(m["canonical"] != (m["lt"][m["occupied"]].max()
                                        if m["occupied"].any() else 0))
                 for m in members)
    return dict(slots_differing=wrong, members_disagreeing=int(apart.sum()),
                stamps_out_of_order=torn + out_of_order,
                clocks_differing=clocks)


def ring_rounds(slots: np.ndarray, values: np.ndarray, n: int,
                ids: List[str]) -> List[Dict[str, np.ndarray]]:
    """The control: the rounds on plain members whose join breaks the
    guarantee of convergence, member ``i`` taking in only member
    ``i + 1``'s lanes (a ring step, not the group's join). Stamps are
    (round, member) packed; the clock is the newest stamp held."""
    m = len(ids)
    mem = [dict(lt=np.zeros(n, np.int64), node=np.full(n, -1, np.int64),
                val=np.zeros(n, np.int64), tomb=np.zeros(n, bool),
                occupied=np.zeros(n, bool)) for _ in ids]
    for r in range(slots.shape[0]):
        for i, st in enumerate(mem):
            s = slots[r, i]
            st["lt"][s] = (r + 1) * m + i
            st["node"][s] = i
            st["val"][s] = values[r, i]
            st["occupied"][s] = True
        after = []
        for i, st in enumerate(mem):
            nb = mem[(i + 1) % m]
            take = nb["lt"] > st["lt"]
            after.append({k: np.where(take, nb[k], st[k]) for k in st})
        mem = after
    names = np.asarray(list(ids) + [""], object)
    for st in mem:
        st["node"] = names[st["node"]]
        st["canonical"] = int(st["lt"].max())
    return mem
