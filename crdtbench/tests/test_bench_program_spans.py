"""The readers of the port's own spans (``crdtbench/program_spans.py``
and the six metrics on it) on registry states set by hand: each gives
its value, and none reads where no merge span was timed."""

import pytest

from crdtbench import harness, program_spans as ps
from crdtbench.harness import Outcome

READERS = ["model.merge_span_ms", "model.prepare_ms", "model.step_ms",
           "kernels.join_host_ms", "model.syncs_per_merge",
           "model.fence_wait_ms"]


@pytest.fixture
def registry():
    """The port's registry, emptied for the test and then restored."""
    from crdt_tpu_torch.obs.registry import default_registry
    reg = default_registry()
    saved = reg.state_snapshot()
    reg.restore_state(({}, saved[1]))
    try:
        yield reg
    finally:
        reg.restore_state(saved)


def timed(reg, name, *seconds):
    hist = reg.histogram(ps.SECONDS, low_exp=-20, high_exp=5)
    for s in seconds:
        hist.observe(s, span=name)


def read(metric):
    return harness.reader(metric)(Outcome(window_s=1.0))


def four_merges(reg):
    """Four merges in two windows, times in binary fractions."""
    timed(reg, ps.MERGE, *[2 ** -8] * 4)
    timed(reg, ps.PREPARE, *[2 ** -10] * 4)
    timed(reg, "crdt_tpu_torch.dense_merge", *[2 ** -9] * 4)
    timed(reg, ps.MASK, *[2 ** -12] * 4)
    timed(reg, ps.JOIN, *[2 ** -11] * 4)
    timed(reg, ps.STAMP, *[2 ** -11] * 4)
    timed(reg, ps.FENCE, 2 ** -9, 2 ** -7)
    timed(reg, "pack_since", 2 ** -6, 2 ** -6)    # another path's
    syncs = reg.counter(ps.SYNCS)
    syncs.inc(4, span=ps.STAMP)
    syncs.inc(2, span=ps.PREPARE)
    syncs.inc(2, span=ps.FENCE)              # outside the merges
    syncs.inc(2, span="pack_since")


@pytest.mark.parametrize("metric,want", [
    ("model.merge_span_ms", 1e3 * 2 ** -8),
    ("model.prepare_ms", 1e3 * 2 ** -10),
    ("model.step_ms", 1e3 * (2 ** -12 + 2 ** -11)),
    ("kernels.join_host_ms", 1e3 * 2 ** -11),
    ("model.syncs_per_merge", 1.5),
    ("model.fence_wait_ms", 1e3 * (2 ** -9 + 2 ** -7) / 2),
])
def test_each_reader_gives_its_value(registry, metric, want):
    four_merges(registry)
    assert read(metric) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", READERS)
def test_no_reading_without_a_live_span(registry, metric):
    assert read(metric) is None
    # Spans of other paths, and a sync counter, are not a merge's.
    timed(registry, "pack_since", 0.001)
    registry.counter(ps.SYNCS).inc(3, span="pack_since")
    assert read(metric) is None


def test_merges_without_a_sync_counter_read_no_syncs(registry):
    """A program that times its spans but never counted a sync."""
    timed(registry, ps.MERGE, 0.002, 0.002)
    assert read("model.syncs_per_merge") == 0.0
    assert read("model.merge_span_ms") == pytest.approx(2.0)
    assert read("model.prepare_ms") is None


def test_the_readers_are_the_benchmarks_entries():
    bench = harness.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READERS:
        m = entries[metric]
        assert m["source"] == "program_span"
        assert m["moves"] == "merged_records_per_s"
        assert m["workloads"] == ["fanin-1024"]
