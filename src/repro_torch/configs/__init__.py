"""Assigned-architecture registry: ``get_config(name)`` + reduced configs.

Held against ``src/repro/configs/__init__.py``: the same data.

Each ``<arch>.py`` holds the exact published hyperparameters from the
assignment; ``reduced()`` shrinks any config to a CPU-smoke footprint while
preserving its family (kind, GQA ratio, window pattern, MoE top-k...).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, MoEConfig

ARCHS = [
    "chameleon_34b", "stablelm_12b", "gemma3_12b", "gemma3_4b", "qwen3_14b",
    "musicgen_large", "hymba_1_5b", "deepseek_moe_16b", "qwen3_moe_30b_a3b",
    "rwkv6_7b",
]


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canon(name)}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, smoke-test footprint (runs a train step on 1 CPU core)."""
    upd = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(max(1, round(4 * cfg.n_kv_heads / cfg.n_heads))
                    if cfg.n_heads else 0),
        d_head=16 if cfg.n_heads else None,
        n_microbatches=1,
        scan_layers=cfg.scan_layers,
    )
    if cfg.window_pattern is not None:
        upd["window_pattern"] = (8, cfg.window_pattern[1])
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 3),
            d_ff_expert=32, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.kind == "hybrid":
        upd["ssm_heads"] = 4
        upd["ssm_state"] = 8
    if cfg.kind == "rwkv":
        upd["rwkv_head"] = 16
    return dataclasses.replace(cfg, **upd)
