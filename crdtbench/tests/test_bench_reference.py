"""The plain references that decide ``correct``, against hand-worked
cases."""

import numpy as np
import pytest
import torch

from crdtbench import data, roofline
from crdtbench.reference import group, lww_fold

S = data.SHIFT


def cs(rows):
    """A changeset from rows of ``(lt, node, val, tomb, valid)`` tuples
    per slot."""
    lanes = {k: [] for k in data.LANES}
    for row in rows:
        for k, i in zip(data.LANES, range(5)):
            lanes[k].append([e[i] for e in row])
    dt = dict(lt=torch.int64, node=torch.int32, val=torch.int64,
              tomb=torch.bool, valid=torch.bool)
    return {k: torch.tensor(v, dtype=dt[k]) for k, v in lanes.items()}


PEERS = ["n0", "n1", "n2"]


def test_fold_orders_by_time_then_node_and_keeps_the_earlier_tie():
    a = (5 << S, 1, 10, False, True)
    b = (5 << S, 2, 20, False, True)       # same time, larger node: wins
    c = (5 << S, 2, 30, True, True)        # identical stamp, later: loses
    d = (4 << S, 2, 40, False, True)       # older: loses
    x = (0, 0, 0, False, False)            # invalid
    got = lww_fold.fold([cs([[a, d], [b, x], [c, a]])], PEERS, "n0", 100)
    assert got["val"].tolist() == [20, 10]
    assert got["tomb"].tolist() == [False, False]
    assert got["node"].tolist() == [2, 1]
    assert got["occupied"].tolist() == [True, True]


def test_fold_held_record_wins_an_exact_tie_and_stamps_modified():
    first = cs([[(7 << S, 1, 1, False, True), (0, 0, 0, False, False)]])
    second = cs([[(7 << S, 1, 2, True, True), (3 << S, 2, 5, False, True)]])
    wall = 6                                # below the records' millis
    got = lww_fold.fold([first, second], PEERS, "n0", wall)
    assert got["val"].tolist() == [1, 5]    # slot 0 kept the held record
    # Merge 1 absorbs 7<<S and stamps slot 0; its send tick is (7, 1).
    # Merge 2 absorbs max(7<<S|1, 7<<S) and stamps slot 1 only.
    assert got["mod_lt"].tolist() == [7 << S, (7 << S) | 1]
    assert got["canonical"] == (7 << S) | 2
    assert got["mod_node"].tolist() == [0, 0]


def test_fold_send_tick_takes_the_wall_when_ahead():
    got = lww_fold.fold([cs([[(7 << S, 1, 1, False, True)]])], PEERS, "n0",
                        wall_millis=9)
    assert got["canonical"] == 9 << S
    assert lww_fold.send((9 << S) | 4, 9) == (9 << S) | 5


def test_control_fold_breaks_the_node_tiebreak():
    rows = cs([[(5 << S, 1, 10, False, True)], [(5 << S, 2, 20, False, True)]])
    want = lww_fold.fold([rows], PEERS, "n0", 1)
    got = lww_fold.fold([rows], PEERS, "n0", 1, node_tiebreak=False)
    assert lww_fold.mismatches(want, got) == 1
    assert lww_fold.mismatches(want, want) == 0


def test_ranks_of_maps_a_replica_table_onto_the_fold_ids():
    ords = torch.tensor([0, 2, 1])
    assert lww_fold.ranks_of(ords, ["a", "c", "b"], ["a", "b", "c"]
                             ).tolist() == [0, 1, 2]
    assert lww_fold.ranks_of(ords, ["a", "x", "b"], ["a", "b"]
                             ).tolist() == [0, 1, -1]


def test_merge_bytes_follow_the_masks():
    valid = torch.zeros(2, 64, dtype=torch.bool)
    valid[0, 0] = True                      # one lt sector, one node sector
    final = valid.clone()
    win = torch.zeros(64, dtype=torch.bool)
    win[0] = True
    got = roofline.merge_bytes(valid, final, win)
    want = (2 * 64 + 32 + 32 + 32 + 32          # valid, lt, node, val, tomb
            + 64 * 13 + 16 * 32 + 2 * 32        # store read, kept val/tomb
            + 64 * 23 + 32 + 32)                # outputs, modified lanes
    assert got == want
    # Shapes alone move the fixed parts; masks move the rest.
    assert roofline.merge_bytes(valid[:1], final[:1], win) == want - 64
    with pytest.raises(ValueError):
        roofline.sector_bytes(torch.zeros(3, dtype=torch.bool), 8)


def members_after(slots, values, n, ids):
    """A correct group: the expected lanes, stamped as the program would
    (one stamp a round, every member's writes of it under the same), on
    every member."""
    want = group.expected(slots, values, n, ids)
    lt = np.where(want["round"] >= 0, (want["round"] + 1) * 10, 0)
    st = dict(lt=lt, node=want["writer"], val=want["val"],
              tomb=np.zeros(n, bool), occupied=want["round"] >= 0,
              canonical=int(lt.max()))
    return [dict(st) for _ in ids]


def test_group_check_holds_a_converged_group_and_its_faults():
    ids = ["m0", "m1"]
    slots = np.array([[[0, 1], [2, 3]], [[1, 4], [5, 0]]])
    values = np.arange(8).reshape(2, 2, 2) + 1
    good = members_after(slots, values, 8, ids)
    assert group.check(slots, values, 8, ids, good) == dict(
        slots_differing=0, members_disagreeing=0, stamps_out_of_order=0,
        clocks_differing=0)
    empty = members_after(slots, values, 8, ids)
    empty[1] = dict(empty[1], lt=empty[1]["lt"].copy())
    empty[1]["lt"][6] = 123                # a slot no member holds
    assert group.check(slots, values, 8, ids, empty)["members_disagreeing"] \
        == 0
    bad = members_after(slots, values, 8, ids)
    bad[1] = dict(bad[1], val=bad[1]["val"].copy())
    bad[1]["val"][4] = 99                  # one member's slot altered
    got = group.check(slots, values, 8, ids, bad)
    assert got["slots_differing"] == 1 and got["members_disagreeing"] == 1
    late = members_after(slots, values, 8, ids)
    for m in late:
        m["lt"] = m["lt"].copy()
        m["lt"][[0, 5]] = 1                # round 1's stamps below round 0's
    got = group.check(slots, values, 8, ids, late)
    assert got["stamps_out_of_order"] >= 1


def test_group_slot_written_by_several_members_goes_to_the_greatest_id():
    ids = ["m0", "m2", "m1"]                 # ranks by id, not by position
    slots = np.array([[[0, 1], [0, 2], [0, 1]],      # slot 0: all three
                      [[3, 4], [5, 4], [6, 7]]])     # slot 4: m0 and m2
    values = np.arange(12).reshape(2, 3, 2) + 1
    want = group.expected(slots, values, 8, ids)
    assert want["writer"][0] == "m2" and want["val"][0] == 3
    assert want["writer"][1] == "m1" and want["val"][1] == 6
    assert want["writer"][4] == "m2" and want["val"][4] == 10
    assert want["writer"][2] == "m2" and want["round"][2] == 0
    good = members_after(slots, values, 8, ids)
    assert not any(group.check(slots, values, 8, ids, good).values())
    low = members_after(slots, values, 8, ids)   # the least id kept instead
    for m in low:
        m["val"], m["node"] = m["val"].copy(), m["node"].copy()
        m["val"][0], m["node"][0] = 1, "m0"
    assert group.check(slots, values, 8, ids, low)["slots_differing"] == 3


def test_group_plan_contends_a_share_of_each_round():
    from crdtbench.traffic.group_join import plan
    it = plan(4096, 4, 16, 7, 0.25)
    rounds = [next(it) for _ in range(64)]
    for r in rounds:
        for row in r:
            assert len(set(row.tolist())) == 16      # a batch repeats none
        tail = r[:, 4:].reshape(-1)
        assert len(set(tail.tolist())) == tail.size  # one writer each
        assert not set(tail.tolist()) & set(r[:, :4].reshape(-1).tolist())
    shared = np.stack([r[1:, :4] == r[0, :4] for r in rounds])
    assert 0.4 < shared.mean() < 0.6                 # each joins by one half
    assert shared.any(1).mean() > 0.8                # most have 2+ writers
    fresh = np.concatenate([np.unique(r) for r in rounds])
    assert len(set(fresh.tolist())) == fresh.size    # fresh across rounds
    again = plan(4096, 4, 16, 7, 0.25)
    assert all((next(again) == r).all() for r in rounds)


def test_group_control_does_not_converge():
    ids = ["m0", "m1", "m2", "m3"]
    rng = np.random.default_rng(0)
    slots = np.stack([rng.permutation(64)[:16].reshape(4, 4)
                      for _ in range(3)])
    values = np.arange(48).reshape(3, 4, 4) + 1
    got = group.check(slots, values, 64, ids,
                      group.ring_rounds(slots, values, 64, ids))
    assert got["members_disagreeing"] > 0 and got["slots_differing"] > 0
