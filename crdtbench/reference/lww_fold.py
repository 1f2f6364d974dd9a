"""The LWW-register fan-in, folded row by row in plain torch.

The semantics are the map CRDT's (crdt.dart's ``merge`` over records
ordered by their HLC): a replica that starts empty takes peer
changesets one merge at a time; within a merge, rows are visited in
order and a valid record replaces the slot's current one only when its
``(logical time, node id)`` is strictly greater, so the record already
held wins an exact tie and an earlier row beats a later identical one.
Each merge first absorbs the largest valid logical time into the clock;
every slot replaced in that merge is stamped ``modified`` with that
absorbed clock and the local node; then the clock takes one send tick
against the wall (hlc.dart ``send``). Node ids are compared by their
sorted order, so the fold works on ranks and names the ids at the end.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

SHIFT = 16
MAX_COUNTER = (1 << SHIFT) - 1
NEG = -(1 << 63)


def send(lt: int, wall_millis: int) -> int:
    """hlc.dart ``send`` on a packed logical time."""
    millis = max(lt >> SHIFT, wall_millis)
    if millis == lt >> SHIFT:
        counter = (lt & MAX_COUNTER) + 1
        if counter > MAX_COUNTER:
            raise OverflowError("HLC counter overflow")
        return (millis << SHIFT) | counter
    return millis << SHIFT


def fold(changesets: Sequence[Dict[str, torch.Tensor]], peer_ids: List[str],
         local_id: str, wall_millis: int, node_tiebreak: bool = True,
         on_merge=None) -> dict:
    """The replica after merging ``changesets`` in order into an empty
    store. Each changeset's ``node`` lane indexes ``peer_ids``. Returns
    the lanes (``node`` and ``mod_node`` as ranks into ``ids``), the
    sorted ``ids`` and the final ``canonical`` logical time.

    ``node_tiebreak=False`` is the control: it breaks the total order
    the configuration states by letting the first record of a logical
    time win whatever its node id. ``on_merge(valid, final, win)`` is
    called after each merge with the ``[R, N]`` entries whose payload
    landed and the ``[N]`` slots it took."""
    ids = sorted(set(peer_ids) | {local_id})
    rank = {nid: i for i, nid in enumerate(ids)}
    n = changesets[0]["lt"].shape[1]
    dev = changesets[0]["lt"].device
    to_rank = torch.tensor([rank[p] for p in peer_ids], dtype=torch.int64,
                           device=dev)
    lt = torch.full((n,), NEG, dtype=torch.int64, device=dev)
    node = torch.full((n,), -1, dtype=torch.int64, device=dev)
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    tomb = torch.zeros(n, dtype=torch.bool, device=dev)
    mod_lt = torch.zeros(n, dtype=torch.int64, device=dev)
    occupied = torch.zeros(n, dtype=torch.bool, device=dev)
    canonical = 0
    for cs in changesets:
        won = torch.zeros(n, dtype=torch.bool, device=dev)
        win_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
        for r in range(cs["lt"].shape[0]):
            v = cs["valid"][r]
            r_lt = cs["lt"][r]
            r_node = to_rank[cs["node"][r].long()]
            newer = r_lt > lt
            if node_tiebreak:
                newer |= (r_lt == lt) & (r_node > node)
            better = v & newer
            lt = torch.where(better, r_lt, lt)
            node = torch.where(better, r_node, node)
            val = torch.where(better, cs["val"][r], val)
            tomb = torch.where(better, cs["tomb"][r], tomb)
            won |= better
            win_row = torch.where(better, r, win_row)
        if on_merge is not None:
            rows = torch.arange(cs["lt"].shape[0], device=dev)[:, None]
            on_merge(cs["valid"], rows == win_row[None, :], won)
        top = torch.where(cs["valid"], cs["lt"], NEG).max().item()
        canonical = max(canonical, int(top))
        mod_lt = torch.where(won, canonical, mod_lt)
        occupied |= won
        canonical = send(canonical, wall_millis)
    return dict(lt=lt, node=node, val=val, tomb=tomb, mod_lt=mod_lt,
                mod_node=torch.where(occupied, rank[local_id], -1),
                occupied=occupied, ids=ids, canonical=canonical)


def mismatches(expected: dict, got: dict) -> int:
    """Slots where the replica ``got`` (same keys; ``node`` and
    ``mod_node`` as ids mapped to ranks of ``expected["ids"]``, -1 for an
    id the fold never saw) differs from ``expected``: occupancy, and on
    occupied slots every lane."""
    occ = expected["occupied"]
    bad = occ != got["occupied"]
    for lane in ("lt", "node", "val", "tomb", "mod_lt", "mod_node"):
        bad |= occ & (expected[lane] != got[lane])
    return int(bad.sum().item())


def ranks_of(ordinals: torch.Tensor, table: List[str], ids: List[str]
             ) -> torch.Tensor:
    """A replica's node ordinals into its own ``table``, as ranks into
    the fold's sorted ``ids`` (-1 for an id the fold does not know)."""
    rank = {nid: i for i, nid in enumerate(ids)}
    lut = torch.tensor([rank.get(str(t), -1) for t in table],
                       dtype=torch.int64, device=ordinals.device)
    return lut[ordinals.long().clamp(0, len(table) - 1)]
