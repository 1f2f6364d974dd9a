"""The port's spans (`crdt_tpu_torch.obs.trace.span`) and the spans of
its merge step.

- Not live (the ring off, no profiler recording), a span runs its body
  alone: no profiler range, no clock, no histogram, no sync debug mode.
- Under a CPU ``torch.profiler`` every span of the merge step is a
  profiler range, and each is timed once a merge, on the pipelined path
  and the unpipelined one alike (the stamp span around the merge's
  whole tail: the stamp and, in a window, the window's step); the fence
  once a window.
  With the ring on, a merge is still one ``merge`` event.
- The sync counter's hook: the outermost live span turns torch's sync
  reports on and restores the mode; a report counts under the innermost
  live span and is not shown; other warnings pass. The hook and its
  filter are put in place once and stay.
- On the card (``-m cuda``): a live span around one ``.item()`` counts
  1 sync, one that only enqueues counts 0, a window's fence at least 1.
  In a coarse window, ``merge``, ``merge_many`` and ``merge_split``
  (wide and narrow lanes) count none under any span of the merge step,
  and land the lanes and clock of the same merges unpipelined.

This file imports neither jax nor the JAX package, so on a machine
without jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

import threading
import warnings
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crdt_tpu_torch.models.dense_crdt import DenseCrdt
from crdt_tpu_torch.obs import trace as ptrace
from crdt_tpu_torch.obs.registry import default_registry
from crdt_tpu_torch.ops.dense import DenseChangeset
from crdt_tpu_torch.ops.split import split_changeset, split_changeset_narrow

from torch_threads import cap_torch_threads

cap_torch_threads()

BASE = 1_700_000_000_000 << 16
WALL = 1_700_000_000_100
IDS = ["a", "b", "c"]
PER_MERGE = ["crdt_tpu_torch.merge", "crdt_tpu_torch.merge.prepare",
             "crdt_tpu_torch.dense_merge", "crdt_tpu_torch.fanin.mask",
             "crdt_tpu_torch.fanin.join", "crdt_tpu_torch.fanin.stamp"]
FENCE = "crdt_tpu_torch.window.fence"


def changeset(seed, n, device, rows=4):
    g = torch.Generator().manual_seed(seed)
    cs = DenseChangeset(
        lt=BASE + torch.randint(0, 8, (rows, n), generator=g),
        node=torch.randint(0, len(IDS), (rows, n), generator=g).int(),
        val=torch.randint(0, 100, (rows, n), generator=g),
        tomb=torch.rand(rows, n, generator=g) < 0.2,
        valid=torch.rand(rows, n, generator=g) < 0.7)
    return DenseChangeset(*(lane.to(device) for lane in cs))


def merges(device, pipelined, n=1024, count=3):
    """A fresh replica merging ``count`` changesets, in one window or
    one by one."""
    batches = [changeset(i, n, device) for i in range(count)]
    crdt = DenseCrdt("h", n, node_ids=IDS, device=device,
                     wall_clock=lambda: WALL)
    if pipelined:
        with crdt.pipelined():
            for cs in batches:
                crdt.merge(cs, IDS)
    else:
        for cs in batches:
            crdt.merge(cs, IDS)
    return crdt


def span_totals():
    """``{span: (count, seconds)}`` of the span histogram."""
    hist = default_registry().histogram("crdt_tpu_span_seconds")
    return {s["labels"]["span"]: (s["count"], s["sum"])
            for s in hist.samples()}


def since(before, i):
    """Each span's growth in count (``i`` 0) or seconds (``i`` 1)."""
    return {k: v[i] - before.get(k, (0, 0.0))[i]
            for k, v in span_totals().items()
            if v[i] != before.get(k, (0, 0.0))[i]}


def span_counts_since(before):
    return since(before, 0)


def syncs(name):
    return default_registry().counter("crdt_tpu_span_syncs_total").value(
        span=name)


class Untouchable:
    """Stands for a module a span that is not live must never reach."""

    def __init__(self, what):
        self._what = what

    def __getattr__(self, attr):
        raise AssertionError(f"a span that is not live read "
                             f"{self._what}.{attr}")


def test_a_span_that_is_not_live_runs_its_body_alone(monkeypatch):
    assert not ptrace.tracer().enabled
    before = span_totals()
    monkeypatch.setattr(ptrace, "torch", Untouchable("torch"))
    monkeypatch.setattr(ptrace, "time", Untouchable("time"))
    monkeypatch.setattr(ptrace, "_span_histogram", Untouchable("histogram"))
    monkeypatch.setattr(ptrace, "_watch_syncs", Untouchable("sync watch"))
    ran = []
    with ptrace.span("torch_spans_test", kind="merge", hlc=lambda: 1 / 0):
        ran.append("with")
    # The whole merge step, every span of it not live.
    crdt = merges("cpu", pipelined=True)
    assert ran == ["with"]
    assert crdt.stats.merges == 3
    assert span_totals() == before


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "unpipelined"])
def test_the_merge_steps_spans_reach_the_profiler(pipelined):
    before = span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        merges("cpu", pipelined)
    ranges = {e.name for e in prof.events()}
    assert set(PER_MERGE) <= ranges
    assert (FENCE in ranges) == pipelined
    want = {name: 3 for name in PER_MERGE}
    if pipelined:
        want[FENCE] = 1
    assert span_counts_since(before) == want
    # The stages lie inside the merge span.
    spent = since(before, 1)
    stages = sum(spent[k] for k in PER_MERGE[1:]
                 if k != "crdt_tpu_torch.dense_merge")
    assert 0 < stages <= spent["crdt_tpu_torch.merge"]


def test_the_ring_makes_spans_live_and_emits_them():
    ring = ptrace.tracer()
    before = span_totals()
    ring.clear()
    ring.enable()
    try:
        merges("cpu", pipelined=True)
    finally:
        ring.disable()
    events = [e for e in ring.events() if e.get("span") in
              set(PER_MERGE) | {FENCE}]
    assert sorted({e["span"] for e in events}) == sorted(
        set(PER_MERGE) | {FENCE})
    assert all(e["dur_s"] >= 0 for e in events)
    # One ``merge`` event a merge, the dispatch's, as in the JAX package.
    assert [e["span"] for e in events if e["kind"] == "merge"] == [
        "crdt_tpu_torch.dense_merge"] * 3
    assert span_counts_since(before)["crdt_tpu_torch.merge"] == 3


class FakeCuda:
    """The sync debug mode of a card that is up, recorded."""

    def __init__(self):
        self.mode = 0
        self.calls = []

    def is_initialized(self):
        return True

    def get_sync_debug_mode(self):
        return self.mode

    def set_sync_debug_mode(self, mode):
        self.calls.append(mode)
        self.mode = {"default": 0, "warn": 1}.get(mode, mode)


def test_the_outermost_live_span_counts_sync_reports(monkeypatch):
    cuda = FakeCuda()
    monkeypatch.setattr(ptrace, "torch", SimpleNamespace(
        cuda=cuda, profiler=torch.profiler))
    ring = ptrace.tracer()
    outer0, inner0 = syncs("torch_spans_outer"), syncs("torch_spans_inner")
    report = ptrace._SYNC_WARNING + " (Triggered internally at x.cpp:1.)"
    show = warnings.showwarning
    ring.enable()
    try:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            with ptrace.span("torch_spans_outer"):
                assert cuda.mode == 1
                warnings.warn(report)
                with ptrace.span("torch_spans_inner"):
                    warnings.warn(report)
                    warnings.warn(report)
                    warnings.warn("another warning")
                assert cuda.calls == ["warn"]
            assert cuda.mode == 0
            # The hook stays; with no span holding the mode a report is
            # shown and, with no live span, not counted.
            assert warnings.showwarning is ptrace._on_warning
            warnings.warn(report)
    finally:
        ring.disable()
    assert cuda.calls == ["warn", 0]
    assert [str(w.message) for w in shown] == ["another warning", report]
    assert syncs("torch_spans_outer") - outer0 == 1
    assert syncs("torch_spans_inner") - inner0 == 2
    assert warnings.showwarning is show
    assert ptrace._SYNC_DEPTH == 0 and not ptrace._SYNC_OURS


def test_a_mode_set_by_the_caller_is_kept(monkeypatch):
    cuda = FakeCuda()
    cuda.mode = 1
    monkeypatch.setattr(ptrace, "torch", SimpleNamespace(
        cuda=cuda, profiler=torch.profiler))
    ring = ptrace.tracer()
    n0 = syncs("torch_spans_kept")
    ring.enable()
    try:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            with ptrace.span("torch_spans_kept"):
                warnings.warn(ptrace._SYNC_WARNING)
    finally:
        ring.disable()
    assert cuda.calls == [] and cuda.mode == 1
    assert [str(w.message) for w in shown] == [ptrace._SYNC_WARNING]
    assert syncs("torch_spans_kept") - n0 == 1


def test_the_warning_hook_is_put_in_place_once(monkeypatch):
    """Later outermost spans only toggle the mode: no new filter (which
    would reset every module's once-only warnings), no new hook; a
    warning from another thread passes whatever the spans do."""
    cuda = FakeCuda()
    monkeypatch.setattr(ptrace, "torch", SimpleNamespace(
        cuda=cuda, profiler=torch.profiler))
    ring = ptrace.tracer()
    ring.enable()
    try:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("default")
            real = warnings.filterwarnings
            added = []
            monkeypatch.setattr(warnings, "filterwarnings",
                                lambda *a, **k: (added.append(a),
                                                 real(*a, **k)))
            for _ in range(3):
                with ptrace.span("torch_spans_once"):
                    assert warnings.showwarning is ptrace._on_warning
                    warnings.warn(ptrace._SYNC_WARNING)
            hook = warnings.showwarning
            t = threading.Thread(target=lambda: warnings.warn(
                "from another thread"))
            with ptrace.span("torch_spans_once"):
                t.start()
                t.join()
            other = [str(w.message) for w in shown]
    finally:
        ring.disable()
    assert added == [("always",)] and hook is ptrace._on_warning
    assert cuda.calls == ["warn", 0] * 4
    assert other == ["from another thread"]


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync counter counts the "
                    "card's host-device synchronizations")
    torch.cuda.init()
    return torch.device("cuda")


@pytest.fixture
def ring():
    ring = ptrace.tracer()
    ring.enable()
    try:
        yield ring
    finally:
        ring.disable()


@pytest.mark.cuda
def test_one_item_counts_one_sync(card, ring):
    x = torch.arange(8, device=card).sum()
    torch.cuda.synchronize()
    n0 = syncs("torch_spans_item")
    with ptrace.span("torch_spans_item"):
        assert x.item() == 28
    assert syncs("torch_spans_item") - n0 == 1
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_a_span_that_only_enqueues_counts_none(card, ring):
    x = torch.arange(1 << 16, device=card)
    torch.cuda.synchronize()
    n0 = syncs("torch_spans_enqueue")
    with ptrace.span("torch_spans_enqueue"):
        y = torch.where(x % 3 == 0, x * 2, torch.zeros_like(x)).sum()
    assert syncs("torch_spans_enqueue") - n0 == 0
    assert int(y) > 0


@pytest.mark.cuda
def test_the_window_fence_counts_its_readback(card, ring):
    n0 = {name: syncs(name) for name in PER_MERGE + [FENCE]}
    before = span_totals()
    merges(card, pipelined=True, n=4096)
    got = {name: syncs(name) - n0[name] for name in n0}
    assert got[FENCE] >= 1
    assert span_counts_since(before)["crdt_tpu_torch.merge"] == 3


# The hub's table is its peers' ids: the ordinal remap is the identity
# and the merge step copies nothing from the host, as in the benchmark.
PEERS = IDS + ["h"]
WINDOW_CASES = ["merge", "merge_many", "merge_split-wide",
                "merge_split-narrow"]


def window_merges(case, device, pipelined, n=4096):
    """A fresh hub's merges of three changesets by ``case``'s entry, in
    one window or one by one."""
    narrow = case == "merge_split-narrow"
    crdt = DenseCrdt("h", n, node_ids=PEERS, device=device,
                     wall_clock=lambda: WALL,
                     value_width=32 if narrow else 64)
    batches = [changeset(i, n, device) for i in range(3)]
    if case == "merge_many":
        calls = [lambda: crdt.merge_many([(cs, PEERS) for cs in batches])]
    elif case == "merge":
        calls = [lambda cs=cs: crdt.merge(cs, PEERS) for cs in batches]
    else:
        lanes = [split_changeset_narrow(cs)[0] if narrow
                 else split_changeset(cs) for cs in batches]
        calls = [lambda s=s: crdt.merge_split(s, PEERS) for s in lanes]
    if pipelined:
        with crdt.pipelined():
            for call in calls:
                call()
    else:
        for call in calls:
            call()
    return crdt, len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_a_coarse_window_syncs_only_at_its_fence(card, ring, case):
    n0 = {name: syncs(name) for name in PER_MERGE + [FENCE]}
    before = span_totals()
    crdt, calls = window_merges(case, card, pipelined=True)
    got = {name: syncs(name) - n0[name] for name in n0}
    assert {name: got[name] for name in PER_MERGE} == dict.fromkeys(
        PER_MERGE, 0)
    assert got[FENCE] >= 1
    assert span_counts_since(before)["crdt_tpu_torch.dense_merge"] == calls
    plain, _ = window_merges(case, card, pipelined=False)
    for f in crdt.store._fields:
        assert torch.equal(getattr(crdt.store, f), getattr(plain.store, f)), f
    assert crdt.canonical_time == plain.canonical_time
