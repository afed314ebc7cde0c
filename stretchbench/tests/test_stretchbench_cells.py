"""Each cell, cut to CPU sizes, end to end: the port's live runtime over
its pipeline against the plain reference, a reconfiguration in every
window; the result line's keys; planted faults and the controls caught."""

import dataclasses

import pytest
import torch

from stretchbench import harness, spec
from stretchbench.tests import tiny

CELLS = ["q1-wordcount.zipf-max", "q3-scalejoin.max", "q3-scalejoin.paced",
         "q1-wordcount.uniform-max"]


@pytest.mark.parametrize("workload", CELLS)
def test_port_equals_reference(workload):
    r = tiny.result(workload)
    assert r["correct"], r["checks"]
    assert r["checked"]["outputs"] > 500
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"tuples_per_s", "latency_p95_ms",
                                 "reconfig_ms", "setup_s"}


def test_line_keys_and_checks_last():
    r = tiny.result("q1-wordcount.zipf-max")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(r["checks"]) == {"outputs_wrong", "flags_wrong",
                                "loads_wrong"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def _fault(kind):
    """A tick function broken underneath the timed path."""
    def wrap(f):
        def g(op_, st, ready, resp, explicit_w=None):
            if kind == "half":
                data = ready.valid & ~ready.is_control
                odd = torch.cumsum(data.long(), 0) % 2 == 1
                ready = dataclasses.replace(ready,
                                            valid=ready.valid & ~(data & odd))
            st2, outs = f(op_, st, ready, resp, explicit_w=explicit_w)
            if kind == "state":
                return st, outs
            if kind == "answer":
                p = outs.payload.clone()
                p[0, -1] += 1.0
                outs = dataclasses.replace(outs, payload=p)
            return st2, outs
        return g
    return wrap


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
@pytest.mark.parametrize("workload", ["q1-wordcount.zipf-max",
                                      "q3-scalejoin.max"])
def test_planted_fault_is_not_correct(workload, fault):
    """A step that returns its state unchanged, half of each tick's
    tuples left out, an answer altered where it is produced: each makes
    ``correct`` false (one chip: no exchange between chips to leave
    out)."""
    r = tiny.result(workload, wrap=_fault(fault))
    assert not r["correct"]
    assert r["checks"]["outputs_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit(workload):
    """The reference in the program's place with a guarantee broken (Q1:
    the moved keys' counts lost at a switch; Q3: bfloat16 attributes)
    fails the outputs' limit."""
    c = tiny.cell(workload)
    nums = harness.run_control(c["cfg"], c["traffic"],
                               spec.kind(c["cfg"]["kind"]), seed=2**31 + 7,
                               n_sb=12, n_sample=6)
    assert nums["outputs_wrong"] > c["cfg"]["limits"]["outputs_wrong"]
    assert not harness.verdict(nums, c["cfg"]["limits"])


@pytest.mark.parametrize("field", ["flags", "loads"])
def test_switch_flags_and_loads_are_checked(monkeypatch, field):
    """A switch flag or an instance load reported wrong is caught."""
    from repro_torch.core import vsn
    tick = vsn.pipeline_tick

    def wrong(*a, **kw):
        out = list(tick(*a, **kw))
        if field == "flags":
            out[5] = ~out[5]
        else:
            out[7] = out[7] + 1
        return tuple(out)

    monkeypatch.setattr(vsn, "pipeline_tick", wrong)
    r = tiny.result("q1-wordcount.zipf-max")
    assert not r["correct"]
    assert r["checks"][f"{field}_wrong"]["value"] > 0
