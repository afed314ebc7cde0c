"""The benchmark's command: one run of one cell on the card.

    python3 -m stretchbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted`` (ticks offered in the
window), ``failed`` (ticks of the window found wrong), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``setup_phases`` (when each
part of set-up ended), and last ``checks``: each
number compared with its limit, which also end standard error.  Exits 2,
printing no result, without a CUDA device (or fewer than the cell asks
for), outside a checkout that holds the port, or if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def result(c: dict, seed: int, seconds: float, trace: bool, device,
           t_start: float = None, wrap=None) -> dict:
    """Run the cell ``c`` (``spec.cell``'s dict) and build its result line
    (a dict; ``checks`` last)."""
    import torch
    from stretchbench import harness, spec
    from stretchbench import trace as tracing

    kind = spec.kind(c["cfg"]["kind"])
    run = harness.run_cell(c["cfg"], c["traffic"], kind, seed=seed,
                           seconds=seconds, trace=trace, device=device,
                           t_start=T_START if t_start is None else t_start,
                           wrap=wrap)
    if trace:
        run.least = kind.least_s(c["cfg"], run.ref, run.traced_ticks)
    metrics = {}
    for m in (c["layers"] if trace else c["e2e"]):
        v = spec.reader("layers" if trace else "e2e", m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    limits = c["cfg"]["limits"]
    out = {
        "correct": harness.verdict(run.checks, limits),
        "attempted": int(len(run.tick_ids)),
        "failed": int(run.failed), "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(run.memory_peak_bytes)}}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {
            "device_ops": tracing.top_ops(run.trace),
            "idle_gaps": tracing.label_gaps(run.trace, run.spans)}
    out["setup_phases"] = run.setup_phases
    out["checked"] = run.checked
    out["checks"] = {n: {"value": v, "limit": limits[n]}
                     for n, v in run.checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m stretchbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"stretchbench: no port at {src / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    from stretchbench import spec
    c = spec.cell(a.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"stretchbench: {a.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = result(c, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"stretchbench: JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 2
    print("setup phases (s from the start): " + " ".join(
        f"{n} {v:.3f}" for n, v in out["setup_phases"].items()),
        file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
