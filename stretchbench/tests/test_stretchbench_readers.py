"""Each metric reader on a recorded run: stamps, flags and a device trace
written out by hand, with the numbers they must give."""

import json
import math

import numpy as np
import pytest

from stretchbench import harness, roofline, spec, trace


def recorded_run():
    """Two super-batches of K = 2 ticks of 100 tuples after one set-up
    super-batch; the window runs from 10.0 s to 11.0 s, and the second
    of its super-batches is accepted after it."""
    run = harness.Run()
    run.cfg = {"tick": 100, "stash_cap": 28}
    run.traffic = {"loop": "open"}
    run.k, run.seconds = 2, 1.0
    run.t0, run.t_end, run.setup_s = 10.0, 11.0, 7.5
    run.tick_ids = np.array([2, 3, 4, 5])
    run.due = np.array([10.1, 10.2, 10.3, 10.4])
    run.taken = np.array([10.15, 10.2, 10.3, 10.5])
    run.sink_accepted = {0: 9.9, 1: 10.5, 2: 11.2}
    run.sb_tuples = {0: 200, 1: 200, 2: 200}
    run.accept = np.array([10.5, 10.5, 11.2, 11.2])
    run.program_flags = np.array([0, 0, 0, 1, 0, 0], bool)
    run.decisions = [{"sb": 1, "tick": 2, "t": 10.05}]
    run.switches = 1
    run.switch_bytes = 16412
    run.report = type("R", (), {"queue_high_water": 3})()
    run.graphs = {(2, 130, 1, 4): {"nodes": {"nodes": 900}}}
    run.spans = [("ingest:stage_super", 10.1, 10.102),
                 ("ingest:stage_super", 10.3, 10.306),
                 ("ingest:stage_super", 9.0, 9.5),
                 ("main:dispatch", 10.4, 10.5)]
    # 40 ms of window: two merge launches of 1 ms, a join kernel of
    # 20 ms, a copy of 2 ms; idle 40 - 24 = 16 ms
    ns = lambda ms: int(ms * 1e6)
    run.trace = {
        "window_s": 0.040, "busy_s": 0.024,
        "kernels": [("scalegate_merge_kernel", ns(0), ns(1)),
                    ("reduce_kernel", ns(2), ns(22)),
                    ("scalegate_merge_kernel", ns(22), ns(23)),
                    ("Memcpy HtoD (Pinned -> Device)", ns(30), ns(32))],
        "by_name": {}, "gaps": [], "offset_ns": 0}
    run.least = {"merge_call": 1e-5, "join": 2e-5,
                 "segment_aggregate_call": 1e-6}
    return run


def read(folder, name):
    return spec.reader(folder, name)(recorded_run())


def test_end_to_end_readers():
    assert read("e2e", "tuples_per_s") == 200.0      # one super-batch done
    # every tick the window offered, the two accepted after it too
    assert read("e2e", "latency_p95_ms") == pytest.approx(
        np.percentile([0.4, 0.3, 0.9, 0.8], 95) * 1e3)
    # decided at 10.05, switched in tick 3 (the window's super-batch 1),
    # accepted at 10.5
    assert read("e2e", "reconfig_ms") == pytest.approx(450.0)
    assert read("e2e", "setup_s") == 7.5


def test_layer_readers():
    assert read("layers", "queue_high_water") == 3
    assert read("layers", "generator_lag_ms") == pytest.approx(
        np.mean([0.05, 0.0, 0.0, 0.1]) * 1e3)
    assert read("layers", "switch_ticks") == 2
    assert read("layers", "switch_table_bytes") == 16412
    assert read("layers", "stage_super_ms") == pytest.approx(4.0)
    assert read("layers", "graph_nodes_per_tick") == 450
    assert read("layers", "scalegate_merge_roofline") == pytest.approx(
        100 * 2 * 1e-5 / 2e-3)
    assert read("layers", "join_roofline") == pytest.approx(
        100 * 2e-5 / 20e-3)
    assert read("layers", "join_roofline.paced") == \
        read("layers", "join_roofline")
    assert read("layers", "device_idle_pct") == pytest.approx(40.0)
    assert read("layers", "device_idle_pct.paced") == pytest.approx(40.0)
    # no segment_aggregate launch in this trace: nothing to read
    assert read("layers", "segment_aggregate_roofline") is None


def test_readers_without_a_trace_read_nothing():
    run = recorded_run()
    run.trace = None
    for name in ("scalegate_merge_roofline", "join_roofline",
                 "device_idle_pct"):
        assert spec.reader("layers", name)(run) is None


def test_union_and_gaps():
    busy, gaps = trace._union([(0, 5), (3, 8), (10, 12)], 0, 20)
    assert busy == 10 and gaps == [(8, 10), (12, 20)]
    parsed = {"gaps": gaps, "offset_ns": 0}
    named = trace.label_gaps(parsed, [("main:dispatch", 13e-9, 19e-9)])
    assert named == [["main:dispatch", 8e-9], ["runtime", 2e-9]]


def test_every_metric_has_its_reader():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        assert callable(spec.reader("e2e", m["name"]))
    for m in bench["per_layer"]:
        assert callable(spec.reader("layers", m["name"]))


def test_roofline_counts():
    n = 8705
    assert roofline.merge_call(n) == pytest.approx(
        max((n * 17 + 4) / 3.35e12, n * 14 / (132 * 64 * 1.98e9)))
    t = roofline.segment_aggregate_call(98304, 1, 65536, 4, 98304)
    assert t == pytest.approx((98304 * 12 + 2 * 65536 * 4 * 4) / 3.35e12)
    assert math.isclose(roofline.join_tick(10**9, 0, 0, 0, 2, 4),
                        6e9 / 67e12)
