"""What the harness loads and reads: never JAX nor the JAX package (their
top-level names compared whole), never ``benchmarks/`` or ``bench/``; and
a cell added as new files and new entries alone."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from stretchbench import spec

ROOT = spec.ROOT
HERE = spec.HERE

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {src!r})
from stretchbench.tests import tiny
r = tiny.result({workload!r}, trace=False)
from stretchbench import run
print(json.dumps({{"correct": r["correct"],
                  "forbidden": run.loaded_forbidden(),
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "metrics": sorted(r["metrics"])}}))
"""


def _run(code: str, cwd: pathlib.Path) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["q1-wordcount.zipf-max",
                                      "q3-scalejoin.max"])
def test_no_jax_nor_the_jax_package_loaded(workload):
    got = _run(RUN_TINY.format(src=str(ROOT / "src"), workload=workload),
               ROOT)
    assert got["correct"]
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])
    assert "repro_torch" in got["modules"]


def test_sources_name_neither_benchmarks_nor_bench():
    pat = re.compile(r"\b(benchmarks|bench)/|[\"'](benchmarks|bench)[\"']"
                     r"|import (repro|jax)\b|from (repro|jax)[ .]")
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            assert not pat.search(line), (path, line)


THROWAWAY_LAYER = '''"""Queued super-batches, read again under a new name."""


def read(run):
    return float(run.report.queue_high_water) + 1.0
'''


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A throwaway deployment, traffic mix and layer metric: new files
    and new entries in a copy; no file of the benchmark is edited."""
    shutil.copytree(HERE, tmp_path / "stretchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "stretchbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    dep = json.loads((HERE / "deployments" / "q1-wordcount.json").read_text())
    dep.update(name="q1-small", vocab=5000)
    (tmp_path / "stretchbench/deployments/q1-small.json").write_text(
        json.dumps(dep))
    traffic = json.loads((HERE / "traffic" / "zipf-max.json").read_text())
    traffic["zipf_a"] = 1.1
    (tmp_path / "stretchbench/traffic/zipf11.json").write_text(
        json.dumps(traffic))
    (tmp_path / "stretchbench/layers/queue_plus_one.py").write_text(
        THROWAWAY_LAYER)
    bench["configs"].append({"name": "q1-small", "source": "a test",
                             "file": "stretchbench/deployments/q1-small.json",
                             "reduced": ["vocab"], "why": "a test"})
    bench["workloads"].append({"name": "q1-small.zipf11",
                               "config": "q1-small", "traffic": "zipf11",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "queue_plus_one", "unit": "n",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "live runtime",
                               "moves": "latency_p95_ms",
                               "workloads": ["q1-small.zipf11"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "stretchbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
    code = """
import json, sys, time
sys.path.insert(0, {src!r})
from stretchbench import spec, run
from stretchbench.tests import tiny
c = spec.cell("q1-small.zipf11")
c["cfg"].update(tiny.SIZES["q1-wordcount"]); c["traffic"].update(tiny.TRAFFIC)
r = run.result(c, 5, 2.5, True, "cpu", t_start=time.perf_counter())
print(json.dumps({{"correct": r["correct"], "metrics": r["metrics"],
                  "layers": [m["name"] for m in c["layers"]]}}))
""".format(src=str(ROOT / "src"))
    got = _run(code, tmp_path)
    assert got["correct"]
    assert got["layers"] == ["queue_plus_one"]
    # no profiler window on the CPU: the trace readers find nothing; the
    # new reader reads the run
    assert got["metrics"]["queue_plus_one"]["value"] >= 1.0
