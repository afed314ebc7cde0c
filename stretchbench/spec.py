"""Finding a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  The configuration's
``file`` is its deployment (``deployments/<name>.json``), whose ``kind``
names the module of ``kinds/`` that builds and checks it; the traffic mix
is ``traffic/<traffic>.json``.  A metric is read by ``e2e/<name>.py`` or
``layers/<name>.py`` (a ``read(run)`` function): the end-to-end metrics
without a ``workloads`` key or listing the cell, and the per-layer metrics
that list the cell, or that have no such key and move an end-to-end
metric the cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(workload: str, root: pathlib.Path = ROOT) -> Dict:
    """Everything a run of ``workload`` needs."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == workload] or [None]
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    cfg = json.loads((root / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _for(m, workload)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if (workload in m["workloads"] if "workloads" in m
                  else m["moves"] in moved)]
    return dict(workload=w, config=c, cfg=cfg, traffic=traffic, e2e=e2e,
                layers=layers)


def kind(name: str):
    return importlib.import_module(f"stretchbench.kinds.{name}")


def reader(folder: str, name: str):
    """The ``read`` function of ``<folder>/<name>.py`` (a name may hold
    dots, so the file is loaded by its path)."""
    path = HERE / folder / f"{name}.py"
    mod_name = f"stretchbench.{folder}." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
