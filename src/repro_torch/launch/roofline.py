"""Roofline analysis via a two-point decomposition of the dry-run.

Held against ``src/repro/launch/roofline.py``, with the same method.
Each cell is traced twice by ``launch.dryrun`` at ``n_layers = 2p`` and
``4p`` (p = the gemma3 local:global period, else 1) and
``n_microbatches=1``, and per metric the linear model

    C(L) = C_fixed + L * C_layer

is solved (``solve``): total per-device cost = C_fixed + n_layers *
C_layer.  The time recurrences (rwkv, the hybrid's SSM) are one
``linear_scan`` launch each in the trace, at its inputs' and outputs'
bytes and no FLOPs, so their FLOPs are added in closed form, as the
reference adds those of its scanned recurrences.  The dry-run's bytes
include the attention logits that the plain attention forms; the
``flash_attention`` kernel keeps them in registers and shared memory, so
their closed-form traffic (``attention_interior_bytes``) is subtracted.
The scan's per-step state (``recurrence_interior_bytes``) is not in the
trace, so nothing is subtracted for it.  Peak memory comes from the
dry-run's JSON of the production cells, since peaks don't decompose
linearly.

Terms, from NVIDIA's H100 Tensor Core GPU data sheet (H100 SXM):
989 TFLOP/s dense bf16 (Tensor Core, without sparsity), 3.35 TB/s HBM3,
NVLink 900 GB/s per GPU in both directions together, so 450 GB/s each
way::

    T_comp = flops_dev / 989e12
    T_mem  = bytes_dev / 3.35e12
    T_coll = coll_bytes_dev / 450e9
    roofline_fraction = (MODEL_FLOPS_dev / 989e12) / max(T_*)

The production mesh puts a 16-wide model axis on 256 GPUs: ``T_coll``
assumes every GPU reaches the others of its model group at the NVLink
rate, that is one NVLink domain of that size (the data sheet's NVLink
Switch System), not eight-GPU servers joined by a slower network.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --all --json r.json
  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      --cell qwen3_moe_30b_a3b:train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.configs import ARCHS, canon, get_config
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12             # dense bf16, H100 SXM
HBM_BW = 3.35e12                # HBM3, H100 SXM
NVLINK_BW = 450e9               # 900 GB/s both directions, one way
CHIPS = 256
DP = 16                          # single-pod data-parallel degree

SHAPE_TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
                "decode_32k": 128, "long_500k": 1}


def model_flops_per_device(cfg: ModelConfig, shape: str) -> float:
    n = cfg.active_param_count()
    toks = SHAPE_TOKENS[shape]
    mult = 6.0 if shape == "train_4k" else 2.0
    return mult * n * toks / CHIPS


def recurrence_flops_per_device(cfg: ModelConfig, shape: str) -> float:
    """Closed-form FLOPs of the time recurrences (one launch each in the
    trace)."""
    toks_dev = SHAPE_TOKENS[shape] / DP
    mult = 3.0 if shape == "train_4k" else 1.0   # fwd+bwd+remat vs fwd
    if cfg.kind == "rwkv":
        h = cfg.d_model // cfg.rwkv_head
        per_tok = 6 * h * cfg.rwkv_head * cfg.rwkv_head
    elif cfg.kind == "hybrid":
        per_tok = 6 * cfg.ssm_heads * cfg.ssm_state * cfg.head_dim
    else:
        return 0.0
    return mult * cfg.n_layers * per_tok * toks_dev


def _shape_dims(cfg: ModelConfig, shape: str):
    if shape == "train_4k":
        return 256 // DP, 4096, 4096, 3.0      # B_loc, Sq, Skv, passes
    if shape == "prefill_32k":
        return 32 // DP, 32768, 32768, 1.0
    if shape == "decode_32k":
        return 128 // DP, 1, 32768, 1.0
    return 1, 1, 524288, 1.0                   # long_500k


def attention_interior_bytes(cfg: ModelConfig, shape: str) -> float:
    """Bytes the plain attention spends on logits and probabilities that
    the flash kernel keeps on chip (s f32 written and read, p likewise:
    ~12 B a pair).  Window layers cap the KV span at the window."""
    if not cfg.n_heads:
        return 0.0
    b, sq, skv, passes = _shape_dims(cfg, shape)
    heads_sharded = cfg.n_kv_heads % 16 == 0 and cfg.n_heads % 16 == 0
    h_dev = cfg.n_heads // 16 if heads_sharded else cfg.n_heads
    if cfg.window_pattern is not None:
        local, every = cfg.window_pattern
        span_local = min(local + 1024, skv)    # chunk granularity
        frac_g = 1.0 / every
        span = frac_g * skv + (1 - frac_g) * span_local
    else:
        span = skv
    pairs = b * sq * span * h_dev * cfg.n_layers
    return pairs * 12.0 * passes


def recurrence_interior_bytes(cfg: ModelConfig, shape: str) -> float:
    """Bytes of the per-step recurrent state that the linear_scan kernel
    keeps on chip (state read and written per token: ~12 B an
    element)."""
    b, sq, _, passes = _shape_dims(cfg, shape)
    toks = b * sq
    if cfg.kind == "rwkv":
        h = cfg.d_model // cfg.rwkv_head
        elems = h * cfg.rwkv_head * cfg.rwkv_head
    elif cfg.kind == "hybrid":
        elems = cfg.ssm_heads * cfg.ssm_state * cfg.head_dim
    else:
        return 0.0
    return toks * elems * 12.0 * cfg.n_layers * passes


def solve(points: dict, n_layers: int, i: int) -> float:
    """Metric ``i`` of ``points`` ({L: (flops, bytes, coll)} at two depths)
    extrapolated to ``n_layers`` through C(L) = C_fixed + L * C_layer."""
    l1, l2 = sorted(points)
    c_layer = (points[l2][i] - points[l1][i]) / (l2 - l1)
    c_fixed = points[l1][i] - l1 * c_layer
    return c_fixed + n_layers * c_layer


def measure_cell(arch: str, shape: str) -> dict:
    from repro_torch.launch.dryrun import LONG_OK_KINDS, run_cell

    cfg = get_config(arch)
    if shape == "long_500k" and cfg.kind not in LONG_OK_KINDS:
        return {"arch": arch, "shape": shape,
                "status": "skipped (full attention)"}
    period = cfg.window_pattern[1] if cfg.window_pattern else 1
    points = {}
    for l in (2 * period, 4 * period):
        cfg_a = dataclasses.replace(
            cfg, n_layers=l, scan_layers=False, n_microbatches=1,
            analysis_unroll=True)
        try:
            r = run_cell(arch, shape, multi_pod=False, cfg=cfg_a)
        except Exception as e:  # a failing cell is a bug: surface it
            r = {"status": f"FAIL {type(e).__name__}: {e}"}
        if r["status"] != "ok":
            return {"arch": arch, "shape": shape,
                    "status": f"analysis-trace failed: {r['status']}"}
        coll = sum(r["collective_bytes"].values())
        points[l] = (r["flops"], r["hlo_bytes"], coll)

    flops = solve(points, cfg.n_layers, 0) + recurrence_flops_per_device(
        cfg, shape)
    bytes_raw = solve(points, cfg.n_layers, 1)
    bytes_kern = max(bytes_raw - attention_interior_bytes(cfg, shape),
                     bytes_raw * 0.05)
    coll = max(solve(points, cfg.n_layers, 2), 0.0)
    return {"arch": arch, "shape": shape, "status": "ok",
            "flops_dev": flops, "bytes_dev": bytes_kern,
            "bytes_dev_raw": bytes_raw, "coll_dev": coll}


def min_bytes_per_device(cfg: ModelConfig, shape: str) -> float:
    """The memory floor: every GPU must read its parameter shard once per
    step (TP=16: parameters replicated across the data axis) plus its
    KV/state slice: the MBU-style bound that governs decode."""
    tp = 16
    w = 2.0 * cfg.active_param_count() / tp
    b, sq, skv, _ = _shape_dims(cfg, shape)
    kv = 0.0
    if cfg.n_heads:
        kv = 2.0 * b * skv * cfg.kv_dim * 2 / tp     # kv_seq/model sharded
    if cfg.kind == "rwkv":
        kv = b * (cfg.d_model // cfg.rwkv_head) * cfg.rwkv_head ** 2 * 4
    if shape == "train_4k":
        w = w * 3 + 12.0 * cfg.active_param_count() / (tp * DP)  # grads+opt
    return w + kv


def analyse(rec: dict, peak_mem=None) -> dict:
    cfg = get_config(rec["arch"])
    t_comp = rec["flops_dev"] / PEAK_FLOPS
    t_mem = rec["bytes_dev"] / HBM_BW
    t_coll = rec["coll_dev"] / NVLINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(cfg, rec["shape"])
    # the achievable floor is whichever resource binds first: the tensor
    # cores (compute) or the HBM read of weights+KV (decode regime).
    t_ideal = max(mf / PEAK_FLOPS,
                  min_bytes_per_device(cfg, rec["shape"]) / HBM_BW)
    return {
        **rec,
        "t_comp_s": t_comp, "t_mem_s": t_mem, "t_coll_s": t_coll,
        "t_mem_raw_s": rec.get("bytes_dev_raw", rec["bytes_dev"]) / HBM_BW,
        "dominant": dominant,
        "model_flops_dev": mf,
        "useful_ratio": mf / rec["flops_dev"] if rec["flops_dev"] else 0.0,
        "roofline_fraction": t_ideal / max(terms.values())
        if max(terms.values()) else 0.0,
        "peak_gb": peak_mem,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--peaks-from", default="dryrun_single.json")
    args = ap.parse_args(argv)

    peaks = {}
    if os.path.exists(args.peaks_from):
        with open(args.peaks_from) as f:
            for r in json.load(f):
                if r.get("status") == "ok" and not r.get("multi_pod"):
                    peaks[(r["arch"], r["shape"])] = \
                        (r.get("peak_bytes_per_device") or 0) / 2 ** 30

    from repro_torch.launch.dryrun import SHAPES
    cells = ([tuple(args.cell.split(":"))] if args.cell else
             [(a, s) for a in ARCHS for s in SHAPES])

    rows = []
    hdr = (f"{'arch':20s} {'shape':12s} {'T_comp':>10s} {'T_mem':>10s} "
           f"{'T_coll':>10s} {'dom':>10s} {'useful':>7s} {'roofline':>9s} "
           f"{'peakGB':>7s}")
    print(hdr, flush=True)
    for arch, shape in cells:
        arch = canon(arch)
        rec = measure_cell(arch, shape)
        if rec["status"] != "ok":
            print(f"{arch:20s} {shape:12s} {rec['status']}", flush=True)
            rows.append(rec)
            continue
        w = analyse(rec, peaks.get((arch, shape)))
        rows.append(w)
        print(f"{arch:20s} {shape:12s} {w['t_comp_s']:10.3e} "
              f"{w['t_mem_s']:10.3e} {w['t_coll_s']:10.3e} "
              f"{w['dominant']:>10s} {w['useful_ratio']:7.1%} "
              f"{w['roofline_fraction']:9.1%} "
              f"{(w['peak_gb'] or 0):7.2f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
