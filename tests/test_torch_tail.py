"""The fan-in merge's tail (`ops.fanin_tail`): the stamp and, in a
coarse ``pipelined()`` window, the window's step, in ONE launch of the
fan-in tail kernel (K1t, ``csrc/fanin_batch.cu``) after each K1 or K1s
join on the card, and in eager ops (`_stamp`, `plain_step`) elsewhere.

Each script below drives a `DenseCrdt` through windows and merges:
flags of every kind, a merge of nothing, K1 and K1s joins mixed in one
window, unpipelined merges, no slots and ragged slot counts, two
windows on one replica. A script's observation is the replica's lanes
and clock, the window's state as its fence reads it, every error raised
(its type and message, which names the first flagged merge) and
``records_seen`` / ``records_adopted``.

- On the CPU: K1t's route, its argument table and its words, with the
  launch replaced by `emulate`, a numpy version of ``fanin_tail_kernel``
  over the same host pointers, hold every script's observation to the
  plain route's. The stats read inside a window and after its fence
  equal the same merges unpipelined, on both routes. Exact windows,
  typed stores and the sharded model never take the kernel.
- On the card (``-m cuda``): every script through K1t against the plain
  route on the card, and the kernel launches of one coarse-window merge
  under ``torch.profiler``.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tail.py
"""

import ctypes
import re
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_tpu_torch.hlc import (ClockDriftException, DuplicateNodeException,
                                MAX_COUNTER, MAX_DRIFT, SHIFT)
from crdt_tpu_torch.models.dense_crdt import (DenseCrdt, PipelinedGuardError,
                                              ShardedDenseCrdt)
from crdt_tpu_torch.obs import device as obs_device
from crdt_tpu_torch.ops import fanin_tail as ft
from crdt_tpu_torch.ops.dense import DenseChangeset
from crdt_tpu_torch.ops.split import split_changeset, split_changeset_narrow
from crdt_tpu_torch.parallel import make_fanin_mesh

from torch_threads import cap_torch_threads

cap_torch_threads()

BASE_MS = 1_700_000_000_000
WALL = BASE_MS + 100
# The hub "h" is ordinal 3 of its table; the peers write as 0..2.
PEERS = ["a", "b", "c", "h"]
LOCAL = 3


class Plant(NamedTuple):
    """One valid entry written into row 0 of a changeset."""
    slot: int
    lt: int
    node: int = 0
    val: int = 7


def changeset(seed: int, n: int, *plants: Plant, rows: int = 4
              ) -> DenseChangeset:
    g = torch.Generator().manual_seed(seed)
    cs = DenseChangeset(
        lt=(BASE_MS << SHIFT) + torch.randint(0, 1 << 12, (rows, n),
                                              generator=g),
        node=torch.randint(0, 3, (rows, n), generator=g).int(),
        val=torch.randint(-100, 100, (rows, n), generator=g),
        tomb=torch.rand(rows, n, generator=g) < 0.2,
        valid=torch.rand(rows, n, generator=g) < 0.7)
    for p in plants:
        cs.lt[0, p.slot] = p.lt
        cs.node[0, p.slot] = p.node
        cs.val[0, p.slot] = p.val
        cs.valid[0, p.slot] = True
    return cs


class Clock:
    """A wall clock that reads ``readings`` over and over."""

    def __init__(self, *readings: int):
        self.readings = readings
        self.at = 0

    def __call__(self) -> int:
        self.at += 1
        return self.readings[(self.at - 1) % len(self.readings)]


class Script(NamedTuple):
    n: int
    blocks: Tuple              # (pipelined, ops) pairs
    width: int = 64
    walls: Tuple = (WALL,)


# Ops: ("merge" | "split" | "narrow", seed, plants...), ("nothing",),
# ("stats",): read the stats there.
DUP = Plant(17, (WALL + 50) << SHIFT, node=LOCAL)
RECV_DRIFT = Plant(18, (WALL + MAX_DRIFT + 5) << SHIFT)
AT_MAX_COUNTER = Plant(19, (WALL << SHIFT) | MAX_COUNTER)
AHEAD = Plant(20, (WALL + 70_000) << SHIFT)
WIDE_VALUE = Plant(21, (BASE_MS + 1) << SHIFT, val=1 << 40)

SCRIPTS = {
    "no-flag": Script(1000, ((True, (("merge", 1), ("merge", 2),
                                     ("merge", 3))),)),
    "duplicate-node": Script(1000, ((True, (("merge", 1),
                                            ("merge", 2, DUP),
                                            ("merge", 3))),)),
    "recv-drift": Script(1000, ((True, (("merge", 1),
                                        ("merge", 2, RECV_DRIFT))),)),
    "send-overflow": Script(1000, ((True, (("merge", 1),
                                           ("merge", 2, AT_MAX_COUNTER),
                                           ("merge", 3))),)),
    # The merge's wall reads 100 s ahead of its send wall: the record 70 s
    # ahead passes the recv guard and trips the send bump's.
    "send-drift": Script(1000, ((True, (("merge", 1), ("merge", 2, AHEAD))),),
                         walls=(WALL + 100_000, WALL)),
    "value-overflow": Script(1000, ((True, (("merge", 1),
                                            ("merge", 2, WIDE_VALUE),
                                            ("merge", 3))),), width=32),
    "nothing-between": Script(1000, ((True, (("merge", 1), ("nothing",),
                                             ("merge", 2))),)),
    "k1-and-k1s": Script(1024, ((True, (("merge", 1), ("split", 2),
                                        ("merge", 3), ("split", 4))),)),
    "k1-and-k1s-narrow": Script(1024, ((True, (("narrow", 1), ("merge", 2),
                                               ("narrow", 3))),), width=32),
    "unpipelined": Script(1000, ((False, (("merge", 1), ("split", 2),
                                          ("nothing",), ("merge", 3))),)),
    "unpipelined-flags": Script(1000, (
        (False, (("merge", 1),)), (False, (("merge", 2, DUP),)),
        (False, (("merge", 3, RECV_DRIFT),)), (False, (("merge", 4),)))),
    "unpipelined-value-overflow": Script(1000, (
        (False, (("merge", 1),)), (False, (("merge", 2, WIDE_VALUE),)),
        (False, (("merge", 3),))), width=32),
    "no-slots": Script(0, ((True, (("merge", 1), ("merge", 2))),
                           (False, (("merge", 3),)))),
    "ragged": Script(4097, ((True, (("merge", 1), ("merge", 2))),)),
    "two-windows": Script(1000, ((True, (("merge", 1), ("merge", 2))),
                                 (True, (("merge", 3, DUP), ("merge", 4))),
                                 (True, (("merge", 5),)))),
    "stats-inside": Script(1000, ((True, (("merge", 1), ("stats",),
                                          ("merge", 2), ("stats",),
                                          ("merge", 3))),
                                  (False, (("merge", 4), ("stats",))))),
}
WINDOW_FIELDS = ("canonical", "any_bad", "overflow", "drift",
                 "val_overflow", "first_flag_idx")


def stats_of(crdt):
    return (crdt.stats.merges, crdt.stats.records_seen,
            crdt.stats.records_adopted)


def apply(crdt, op, device, n, obs):
    kind, *args = op
    if kind == "nothing":
        crdt.merge_many([])
    elif kind == "stats":
        obs["stats"].append(stats_of(crdt))
    else:
        seed, *plants = args
        cs = changeset(seed, n, *plants)
        if kind == "merge":
            crdt.merge(DenseChangeset(*(x.to(device) for x in cs)), PEERS)
        else:
            scs = split_changeset_narrow(cs)[0] if kind == "narrow" \
                else split_changeset(cs)
            crdt.merge_split(type(scs)(*(x.to(device) for x in scs)),
                             PEERS)


def run(name: str, device) -> dict:
    """A script's observation (see the module docstring)."""
    s = SCRIPTS[name]
    crdt = DenseCrdt("h", s.n, node_ids=PEERS, device=device,
                     wall_clock=Clock(*s.walls), value_width=s.width)
    obs = {"errors": [], "windows": [], "stats": []}
    for pipelined, ops in s.blocks:
        try:
            if not pipelined:
                for op in ops:
                    apply(crdt, op, device, s.n, obs)
                continue
            with crdt.pipelined():
                for op in ops:
                    apply(crdt, op, device, s.n, obs)
                pipe = crdt._pipe
                obs["windows"].append(
                    [int(getattr(pipe, f)) for f in WINDOW_FIELDS]
                    + [pipe.merges])
        except (PipelinedGuardError, DuplicateNodeException,
                ClockDriftException, ValueError) as e:
            obs["errors"].append((type(e).__name__, str(e)))
    obs["lanes"] = {f: getattr(crdt.store, f).cpu()
                    for f in crdt.store._fields}
    obs["canonical"] = crdt.canonical_time.logical_time
    obs["stats"].append(stats_of(crdt))
    return obs


def assert_same(got: dict, want: dict) -> None:
    for f, lane in want["lanes"].items():
        assert got["lanes"][f].dtype == lane.dtype, f
        assert torch.equal(got["lanes"][f], lane), f
    for key in ("canonical", "errors", "windows", "stats"):
        assert got[key] == want[key], key


def kernel_merges(name: str) -> int:
    """The merges of a script that end in K1t: every join (a merge of
    nothing has none) outside an exact window."""
    return sum(op[0] in ("merge", "split", "narrow")
               for _, ops in SCRIPTS[name].blocks for op in ops)


# --- on the CPU: the kernel's route, emulated ---------------------------


def at(ptr: int, dtype, count: int = 1) -> np.ndarray:
    """``count`` entries of ``dtype`` at host address ``ptr``, writable."""
    dtype = np.dtype(dtype)
    if count == 0:
        return np.empty(0, dtype)
    assert ptr, "a pointer the kernel reads is null"
    return np.frombuffer((ctypes.c_char * (count * dtype.itemsize))
                         .from_address(ptr), dtype)


def emulate(ptrs, dims, dev) -> None:
    """``fanin_tail_kernel`` in numpy over its argument table: the
    stamped lanes, the adopted count, the words (``crdt_fanin_tail``'s
    launcher documents the table)."""
    assert len(ptrs) == 18 and len(dims) == 6 and dev.type == "cpu"
    n, thresh, send_wall, idx, local, window = dims
    (st_mod_lt, st_mod_node, win, o_mod_lt, o_mod_node, canonical,
     basemax, any_dup, seen, val_ovf, seen_sum, adopted_sum, any_bad,
     overflow, drift, val_ovf_all, first_flag, out) = ptrs
    i64 = np.int64
    won = at(win, np.uint8, n) != 0
    bmax = int(at(basemax, i64)[0])
    new_c = max(int(at(canonical, i64)[0]), bmax)
    at(o_mod_lt, i64, n)[:] = np.where(won, new_c, at(st_mod_lt, i64, n))
    at(o_mod_node, np.int32, n)[:] = np.where(
        won, local, at(st_mod_node, np.int32, n))
    adopted = int(won.sum())
    o = at(out, i64, ft.WORDS)
    recv = bool(at(any_dup, np.uint8)[0]) or bmax > thresh
    vo = bool(val_ovf) and bool(at(val_ovf, np.uint8)[0])
    o[ft.RECV], o[ft.ADOPTED], o[ft.NEW_CANONICAL], o[ft.VAL_OVERFLOW] = (
        recv, adopted, new_c, vo)
    o[ft.SEEN_SUM] = (int(at(seen_sum, i64)[0]) if seen_sum else 0) \
        + int(at(seen, i64)[0])
    o[ft.ADOPTED_SUM] = (int(at(adopted_sum, i64)[0]) if adopted_sum
                         else 0) + adopted
    o[ft.WORDS - 2:] = adopted, max(1, -(-n // 256))   # the scratch
    if window:
        first = int(at(first_flag, np.int32)[0])
        if first < 0 and (recv or vo):
            first = idx
        ms = new_c >> SHIFT
        stay = ms >= send_wall
        ovf = stay and (new_c & MAX_COUNTER) == MAX_COUNTER
        c = new_c if ovf else (new_c + 1 if stay else send_wall << SHIFT)
        dr = ms - send_wall > MAX_DRIFT
        if first < 0 and (ovf or dr):
            first = idx
        flag = lambda p: bool(at(p, np.uint8)[0])
        o[ft.CANONICAL] = c
        o[ft.ANY_BAD] = flag(any_bad) or recv
        o[ft.OVERFLOW] = flag(overflow) or ovf
        o[ft.DRIFT] = flag(drift) or dr
        o[ft.VAL_OVERFLOW_ALL] = flag(val_ovf_all) or vo
        o[ft.FIRST_FLAG] = first
    obs_device.note_launch("fanin_tail")


@pytest.fixture
def emulated(monkeypatch):
    """K1t's route for CPU lanes too, its launch `emulate`d."""
    monkeypatch.setattr(ft, "_takes_kernel",
                        lambda j, pipe: pipe is None or not pipe.exact)
    monkeypatch.setattr(ft, "_launch", emulate)
    obs_device.reset()


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_kernels_route_equals_the_plain_route(name, monkeypatch):
    obs_device.reset()
    want = run(name, "cpu")
    assert obs_device.launches()["fanin_tail"] == 0
    monkeypatch.setattr(ft, "_takes_kernel",
                        lambda j, pipe: pipe is None or not pipe.exact)
    monkeypatch.setattr(ft, "_launch", emulate)
    obs_device.reset()
    got = run(name, "cpu")
    assert obs_device.launches()["fanin_tail"] == kernel_merges(name)
    assert_same(got, want)


def test_the_scripts_trip_what_they_plant():
    """Each flag script raises what it plants, at the merge it names."""
    raised = {name: run(name, "cpu")["errors"] for name in (
        "duplicate-node", "recv-drift", "send-overflow", "send-drift",
        "value-overflow", "unpipelined-flags",
        "unpipelined-value-overflow", "two-windows")}
    coarse = "PipelinedGuardError"
    assert [(t, "recv-guard" in m, "#1 of 3" in m) for t, m in
            raised["duplicate-node"]] == [(coarse, True, True)]
    assert "#1 of 2" in raised["recv-drift"][0][1]
    assert "send counter overflow" in raised["send-overflow"][0][1]
    assert "#1 of 3" in raised["send-overflow"][0][1]
    assert "send drift" in raised["send-drift"][0][1]
    assert "value-ref overflow" in raised["value-overflow"][0][1]
    assert [t for t, _ in raised["unpipelined-flags"]] == [
        "DuplicateNodeException", "ClockDriftException"]
    assert [t for t, _ in raised["unpipelined-value-overflow"]] == [
        "ValueError"]
    assert [(t, "#0 of 2" in m) for t, m in raised["two-windows"]] == [
        (coarse, True)]


def window_and_unpipelined_stats(read_inside: bool):
    """``(merges, records_seen, records_adopted)`` of four merges in a
    window, read inside it (``read_inside``) and after its fence, and of
    the same merges unpipelined."""
    n = 1000
    batches = [changeset(i, n) for i in range(4)]
    w = DenseCrdt("h", n, node_ids=PEERS, device="cpu",
                  wall_clock=Clock(WALL))
    inside = []
    with w.pipelined():
        for i, cs in enumerate(batches):
            w.merge(cs, PEERS)
            if read_inside and i in (1, 2):
                inside.append(stats_of(w))
    u = DenseCrdt("h", n, node_ids=PEERS, device="cpu",
                  wall_clock=Clock(WALL))
    steps = []
    for cs in batches:
        u.merge(cs, PEERS)
        steps.append(stats_of(u))
    return inside, stats_of(w), steps


@pytest.mark.parametrize("read_inside", [True, False],
                         ids=["read-inside", "read-after"])
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_window_stats_equal_the_unpipelined_merges(route, read_inside,
                                                   request):
    obs_device.reset()
    if route == "kernel":
        request.getfixturevalue("emulated")
    inside, after, steps = window_and_unpipelined_stats(read_inside)
    assert inside == ([steps[1], steps[2]] if read_inside else [])
    assert after == steps[-1]
    assert after[1] > 0 and after[2] > 0
    assert obs_device.launches()["fanin_tail"] == (
        8 if route == "kernel" else 0)


def test_exact_typed_and_sharded_merges_take_the_plain_route(emulated):
    n = 512
    cs = changeset(1, n)
    crdt = DenseCrdt("h", n, node_ids=PEERS, device="cpu",
                     wall_clock=Clock(WALL))
    with crdt.pipelined(exact_guards=True):
        crdt.merge(cs, PEERS)
        crdt.merge_split(split_changeset(cs), PEERS)
    typed = DenseCrdt("h", n, node_ids=PEERS, device="cpu",
                      wall_clock=Clock(WALL))
    typed.set_semantics(range(0, n // 2), "gcounter")
    with typed.pipelined():
        typed.merge(cs, PEERS)
    typed.merge(cs, PEERS)
    sharded = ShardedDenseCrdt(
        "h", n, make_fanin_mesh(2, 2, devices=["cpu"] * 4),
        node_ids=PEERS, wall_clock=Clock(WALL))
    with sharded.pipelined():
        sharded.merge(cs, PEERS)
    sharded.merge(cs, PEERS)
    assert obs_device.launches()["fanin_tail"] == 0
    crdt.merge(cs, PEERS)
    assert obs_device.launches()["fanin_tail"] == 1


def test_the_words_are_the_kernels():
    """The word indices and the table's length are those of the CUDA
    source."""
    src = (Path(ft.__file__).parent.parent / "csrc" / "fanin_batch.cu"
           ).read_text()
    enum = re.search(r"enum Word \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in enum.split(",") if w.strip()]
    py = {"kRecv": ft.RECV, "kAdopted": ft.ADOPTED,
          "kNewCanonical": ft.NEW_CANONICAL,
          "kValOverflow": ft.VAL_OVERFLOW, "kSeenSum": ft.SEEN_SUM,
          "kAdoptedSum": ft.ADOPTED_SUM, "kCanonical": ft.CANONICAL,
          "kAnyBad": ft.ANY_BAD, "kOverflow": ft.OVERFLOW,
          "kDrift": ft.DRIFT, "kValOverflowAll": ft.VAL_OVERFLOW_ALL,
          "kFirstFlag": ft.FIRST_FLAG, "kWords": ft.WORDS}
    assert {k: names.index(k) for k in py} == py
    assert len(re.findall(r"a\.\w+ = \([^;]*\)ptrs\[(\d+)\];", src)) == 18


# --- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1t is a CUDA kernel")
    torch.cuda.init()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_the_kernel_equals_the_plain_route_on_the_card(card, name,
                                                       monkeypatch):
    obs_device.reset()
    got = run(name, card)
    torch.cuda.synchronize()
    assert obs_device.launches()["fanin_tail"] == kernel_merges(name)
    monkeypatch.setattr(ft, "_takes_kernel", lambda j, pipe: False)
    want = run(name, card)
    assert_same(got, want)
    assert_same(run(name, "cpu"), want)


def coarse_window(device, n=4096, count=3):
    crdt = DenseCrdt("h", n, node_ids=PEERS, device=device,
                     wall_clock=Clock(WALL))
    batches = [DenseChangeset(*(x.to(device) for x in changeset(i, n)))
               for i in range(count)]
    return crdt, batches


@pytest.mark.cuda
def test_a_coarse_window_merge_launches_at_most_four_kernels(card):
    crdt, batches = coarse_window(card)
    with crdt.pipelined():
        crdt.merge(batches[0], PEERS)
        torch.cuda.synchronize()
        obs_device.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            crdt.merge(batches[1], PEERS)
            torch.cuda.synchronize()
        crdt.merge(batches[2], PEERS)
    # The card's activity less the spans' ranges on the card's timeline.
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("crdt_tpu_torch.")]
    kernels = [k for k in on_card if not k.startswith(("Memset", "Memcpy"))]
    launched = [e.name for e in prof.events()
                if e.name.startswith("cudaLaunchKernel")]
    assert kernels, on_card
    assert len(kernels) <= 4 and len(launched) <= 4, (kernels, launched)
    assert obs_device.launches()["fanin_tail"] == 2
    assert obs_device.launches()["fanin_batch"] == 2


@pytest.mark.cuda
def test_exact_typed_and_sharded_merges_launch_no_tail(card):
    obs_device.reset()
    crdt, batches = coarse_window(card, count=2)
    with crdt.pipelined(exact_guards=True):
        for cs in batches:
            crdt.merge(cs, PEERS)
    typed, _ = coarse_window(card, count=0)
    typed.set_semantics(range(0, 2048), "gcounter")
    with typed.pipelined():
        typed.merge(batches[0], PEERS)
    sharded = ShardedDenseCrdt("h", 4096, make_fanin_mesh(1, 1),
                               node_ids=PEERS, wall_clock=Clock(WALL))
    with sharded.pipelined():
        sharded.merge(batches[0], PEERS)
    torch.cuda.synchronize()
    assert obs_device.launches()["fanin_tail"] == 0
    assert obs_device.launches()["fanin_batch_sharded"] == 1
