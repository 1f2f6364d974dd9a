"""The harness finds every cell, configuration, traffic kind and metric
by name from files; ``BENCHMARK.json`` keeps to its contract; the result
line carries its keys; the trace reduction on hand-worked cases."""

import json
import re

import pytest

from crdtbench import harness, stats, tracing

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "crdtbench/run.py"]
    assert BENCH["paths"] == ["crdtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_from_its_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = harness.workload(cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"]
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["traffic"] == cell and entry["chips"] in (1, 4)
    assert harness.config(entry["config"])["name"] == entry["config"]
    assert hasattr(harness.traffic(wl["traffic"]["kind"]), "run")
    assert hasattr(harness.traffic(wl["traffic"]["kind"]), "control")
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell, True)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_has_its_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"crdtbench/configs/{cfg['name']}.json"
    assert harness.config(cfg["name"])["name"] == cfg["name"]
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader_and_keeps_to_the_contract(m):
    assert callable(harness.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_names_are_unique_and_four_card_cells_are_few():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        harness.workload("../BENCHMARK")


def test_result_line_keys():
    out = harness.Outcome(window_s=2.0, attempted=3, failed=0,
                          memory_peak_bytes=5,
                          checks=[harness.Check("wrong", 0, 0)])
    out.samples["unit_s"] = [0.01, 0.02]
    out.counts["records_in_window"] = 10
    vals = harness.metric_values(BENCH, "fanin-1024", False, out, 1.5)
    assert set(vals) == {"merged_records_per_s", "merge_p95_ms", "setup_s"}
    assert vals["merged_records_per_s"] == {"value": 5.0,
                                            "unit": "records/s"}
    line = json.loads(harness.result_line(True, out, vals, {"count": 1}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == {"wrong": {"value": 0, "limit": 0}}


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 0.99) == 99
    assert stats.percentile(xs, 0.95) == 95
    assert stats.percentile([3.0], 0.99) == 3.0
    assert stats.percentile([], 0.5) is None


def test_trace_reduction_on_a_hand_worked_slice():
    dev = [(0, "k1", 10.0, 30.0, 5.0), (0, "k2", 20.0, 40.0, 8.0),  # overlap
           (0, "ncclKernel", 60.0, 70.0, 45.0), (1, "k1", 0.0, 200.0, None),
           (2, "other card", 0.0, 5.0, 1.0)]
    ann = [("crdtbench.join", 40.0, 80.0), ("crdtbench.write", 0.0, 40.0)]
    tr = tracing.reduce(dev, ann, 2, 0.0, 100.0)
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx([40e-6, 100e-6])
    assert tr["device_ops"] == [3, 1]
    assert tr["nccl_s"] == pytest.approx([10e-6, 0.0])
    gaps = dict(tr["idle_gaps"])
    assert gaps["crdtbench.write"] == pytest.approx(10e-6)
    assert gaps["crdtbench.join"] == pytest.approx(20e-6)
    assert gaps[tracing.OUTSIDE] == pytest.approx(30e-6)
    # Work counts for the span that launched it, whenever it ran.
    assert tr["launched_s"]["crdtbench.write"] == pytest.approx([30e-6, 0])
    assert tr["launched_s"]["crdtbench.join"] == pytest.approx([10e-6, 0])
    assert tr["unlinked"] == [0, 1]


def test_merge_roofline_reads_the_merges_device_time_only():
    read = harness.reader("fanin.merge_roofline")
    out = harness.Outcome(window_s=1.0)
    out.counts.update(traced_laps=2, lap_bytes=3.35e6)   # 1 us a lap
    tr = dict(busy_s=[10e-6], unlinked=[0],
              launched_s={"crdtbench.merge": [4e-6],
                          "crdtbench.lap": [6e-6]})
    out.trace = tr
    assert read(out) == pytest.approx(50.0)
    assert read(harness.Outcome(window_s=1.0)) is None
    out.trace = dict(tr, unlinked=[1])            # a launch not known
    assert read(out) is None
    out.trace = dict(tr, launched_s={})           # nothing launched in a merge
    assert read(out) is None
