"""Each cell's run, with the look for a card skipped, at a small size on
the CPU: clean it comes out correct, and with the timed path broken
underneath (each fault the cell can have) ``correct`` comes out false.
The controls (the plain reference in the program's place, one
guarantee broken) fail too."""

import json
import time

import pytest
import torch

from crdtbench import harness
from crdtbench.run import complete

SMALL = {
    "fanin-1024": dict(n_slots=4096, rows_per_changeset=8, warmup_laps=1,
                       trace_seconds=0.2),
    "group-join-4card": dict(n_slots=4096, rows_per_member=16,
                             warmup_rounds=2, trace_seconds=0.2,
                             control_rounds_per_s=20),
}


#: The cells `BENCHMARK.json` lists; the others' files wait for a later
#: benchmark change to list them (their metrics are not reported yet).
LISTED = {w["name"] for w in harness.benchmark()["workloads"]}


def small(cell, seconds=1.5, traced=False):
    ctx = harness.Ctx(cell, 4_000_000_017, seconds, traced,
                      time.perf_counter(), ["cpu"])
    for k, v in SMALL[cell].items():
        (ctx.config if k in ctx.config else ctx.params)[k] = v
    return ctx


def verdict(line):
    d = json.loads(line)
    return d["correct"], d


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_clean_run_is_correct(cell):
    ok, line = verdict(complete(small(cell)))
    assert ok, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"]
    if cell in LISTED:
        assert len(line["metrics"]) >= 2


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reports_its_layers(cell):
    ok, line = verdict(complete(small(cell, traced=True)))
    assert ok
    assert line["device"]["window_s"] > 0 and "breakdown" in line


# --- fan-in ------------------------------------------------------------------


def dense():
    from crdt_tpu_torch.models.dense_crdt import DenseCrdt
    return DenseCrdt


def unchanged():
    class Unchanged(dense()):
        def merge(self, cs, node_ids):
            pass                              # the state returned as it was
    return Unchanged


def half_batch():
    from crdt_tpu_torch.ops.dense import DenseChangeset

    class Half(dense()):
        def merge(self, cs, node_ids):
            r = cs.lt.shape[0] // 2
            super().merge(DenseChangeset(*(lane[:r] for lane in cs)),
                          node_ids)
    return Half


def altered():
    class Altered(dense()):
        def merge(self, cs, node_ids):
            super().merge(cs, node_ids)
            self._store.val[7] += 1           # an answer altered
    return Altered


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fanin_faults_are_not_correct(fault):
    ok, line = verdict(complete(small("fanin-1024"), model=fault()))
    assert not ok and line["checks"]["slots_differing"]["value"] > 0


# --- group join ----------------------------------------------------------------


def join_nothing(grp):
    grp.join = lambda *a, **k: None


def exchange_left_out(monkeypatch):
    """Members in groups of their own, the cross-group exchange skipped:
    each group keeps its own partial."""
    from crdt_tpu_torch.parallel import comm, make_collective_mesh
    monkeypatch.setattr(comm, "_funnel", lambda layout, parts, fold:
                        list(parts))

    def hook(grp):
        grp.mesh = make_collective_mesh(4, ["cpu"] * 4, groups=[0, 1, 2, 3])
    return hook


def member_altered(grp):
    inner = grp.join

    def join(*a, **k):
        out = inner(*a, **k)
        grp.members[2]._store.val[3] += 1
        return out
    grp.join = join


def least_id_wins(monkeypatch):
    """The cross-card winner rule broken: of the members holding a slot's
    newest stamp, the least node id wins (min, not max, on the node)."""
    from crdt_tpu_torch.parallel import comm
    inner = comm.lex_winner

    def lex_winner(layout, lt, node):
        m1, m2, mine = inner(layout, lt, [-n for n in node])
        return m1, [-n for n in m2], mine
    monkeypatch.setattr(comm, "lex_winner", lex_winner)
    return None


@pytest.mark.parametrize("fault", ["unchanged", "exchange", "altered",
                                   "least_id"])
def test_group_faults_are_not_correct(fault, monkeypatch):
    hook = {"unchanged": join_nothing, "altered": member_altered,
            "exchange": exchange_left_out,
            "least_id": least_id_wins}[fault]
    if fault in ("exchange", "least_id"):
        hook = hook(monkeypatch)
    ok, line = verdict(complete(small("group-join-4card"), group_hook=hook))
    assert not ok
    assert line["checks"]["slots_differing"]["value"] + \
        line["checks"]["members_disagreeing"]["value"] > 0


def test_group_with_its_own_groups_is_correct():
    """The cross-group route itself (the funnel on the CPU) is sound."""
    from crdt_tpu_torch.parallel import make_collective_mesh

    def hook(grp):
        grp.mesh = make_collective_mesh(4, ["cpu"] * 4, groups=[0, 1, 2, 3])
    ok, line = verdict(complete(small("group-join-4card"), group_hook=hook))
    assert ok, line["checks"]


# --- controls ------------------------------------------------------------------


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails(cell):
    ctx = small(cell, seconds=4.0)
    readings = harness.traffic(ctx.params["kind"]).control(ctx)
    assert any(v > 0 for v in readings.values()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fanin-1024", "group-join-4card"])
def test_the_control_fails_on_the_card(cell, cuda):
    ctx = harness.Ctx(cell, 5, 1.0, False, time.perf_counter(), [cuda])
    for k, v in SMALL[cell].items():
        (ctx.config if k in ctx.config else ctx.params)[k] = v
    readings = harness.traffic(ctx.params["kind"]).control(ctx)
    assert any(v > 0 for v in readings.values()), readings
    torch.cuda.synchronize()
