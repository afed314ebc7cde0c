"""Decoder stack assembly: block dispatch by arch kind, embeddings/unembed.

Held against ``src/repro/models/transformer.py`` for the kinds ``dense``
(with ``window_pattern`` and ``frontend="embedding_stub"``), ``moe`` and
``rwkv``.
Layers are a Python list walked in order; the reference's
``scan_layers``/``remat`` have no counterpart in eager code.  Parameters
are a dict with ``layers`` a list of per-layer dicts; caches and recurrent
states keep the reference's stacked ``[L, B, ...]`` layout, and ``forward``
updates them in place (the reference returns new arrays) and returns them
with the reference's ``aux``, the MoE tokens dropped over the layers.  With
a slot pool (``lanes``) an MoE layer routes each batch row as a group of
its own, as the reference's serving engine decodes each lane under its
``vmap``; otherwise the ``[B, S]`` block is one group, as in the
reference's ``forward``.
``init_params`` draws from an explicit ``torch.Generator`` on the target
device: the reference's distributions, not JAX's bits (the tests carry
the reference's own parameters across with ``convert.from_reference``).
The ``hybrid`` kind and ``loss_fn`` (training) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch import device as _device
from repro_torch.models import attention, moe as moe_mod, rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, init_dense, rms_norm, swiglu,
                                       unembed)

BIG_WINDOW = 1 << 30
KINDS = ("dense", "moe", "rwkv")


def check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise NotImplementedError(
            f"model kind {cfg.kind!r} ({cfg.name}) is not ported yet: the "
            f"port has {KINDS}; ssm/hybrid is ROADMAP.md queue 1 item 7")


def layer_windows(cfg: ModelConfig) -> Optional[List[int]]:
    """gemma3 5:1 local:global pattern -> per-layer window sizes."""
    if cfg.window_pattern is None:
        return None
    local, every = cfg.window_pattern
    return [BIG_WINDOW if (i + 1) % every == 0 else local
            for i in range(cfg.n_layers)]


def init_layer(gen, cfg: ModelConfig, dtype, device=None):
    check_kind(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "norm1": torch.zeros((d,), dtype=dtype, device=device),
        "norm2": torch.zeros((d,), dtype=dtype, device=device)}
    if cfg.kind == "rwkv":
        p["tm"] = rwkv_mod.init_time_mix(gen, cfg, dtype, device)
        p["cm"] = rwkv_mod.init_channel_mix(gen, cfg, dtype, device)
        return p
    p["attn"] = attention.init_attn(gen, cfg, dtype, device)
    if cfg.kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
        return p
    p["mlp"] = {
        "wg": init_dense(gen, (d, cfg.d_ff), dtype=dtype, device=device),
        "wu": init_dense(gen, (d, cfg.d_ff), dtype=dtype, device=device),
        "wd": init_dense(gen, (cfg.d_ff, d), dtype=dtype, device=device),
    }
    return p


def block_forward(p, x, positions, cfg: ModelConfig, *, window=None,
                  cache=None, state=None, index=None, per_row=False):
    """One decoder block.  Returns (x, cache, new_state, aux), ``aux`` the
    MoE tokens dropped (float32; None for the other kinds).  ``index``:
    the forward's ``attention.cache_index``, shared by its layers;
    ``per_row``: route the MoE per batch row."""
    aux = None
    if cfg.kind == "rwkv":
        h, shift_tm, wkv = rwkv_mod.time_mix_forward(
            p["tm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
            state["shift_tm"], state["wkv"])
        x = x + h
        h, shift_cm = rwkv_mod.channel_mix_forward(
            p["cm"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg,
            state["shift_cm"])
        x = x + h
        return x, cache, {"shift_tm": shift_tm, "shift_cm": shift_cm,
                          "wkv": wkv}, aux
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    attn_out, cache = attention.attn_forward(
        p["attn"], h, positions, cfg, window=window, cache=cache,
        index=index)
    x = x + attn_out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.kind == "moe":
        ffn_out, dropped = moe_mod.moe_forward(p["moe"], h, cfg,
                                               per_row=per_row)
        aux = dropped.to(torch.float32)
    else:
        ffn_out = swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
    return x + ffn_out, cache, state, aux


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    with the reference's distributions (``init_dense``: normal over
    sqrt(fan_in), embeddings 0.02), made on ``device`` (default: the
    card)."""
    check_kind(cfg)
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embedding": init_dense(gen, (cfg.padded_vocab, cfg.d_model),
                                scale=0.02, dtype=dtype, device=dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_dense(gen, (cfg.padded_vocab, cfg.d_model),
                                       scale=0.02, dtype=dtype, device=dev)
    params["layers"] = [init_layer(gen, cfg, dtype, dev)
                        for _ in range(cfg.n_layers)]
    return params


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked [L, ...] KV caches (dense) or recurrent states (rwkv)."""
    check_kind(cfg)
    dev = _device.resolve(device)
    stack = lambda tree: {k: torch.stack([v] * cfg.n_layers)
                          for k, v in tree.items()}
    if cfg.kind == "rwkv":
        return None, stack(rwkv_mod.init_rwkv_state(cfg, batch, dev))
    return stack(attention.init_cache(cfg, batch, max_seq,
                                      getattr(torch, cfg.dtype), dev)), None


def forward(params, cfg: ModelConfig, inputs, positions, *, caches=None,
            states=None, lanes=None):
    """inputs: tokens [B, S] (frontend="token") or precomputed frontend
    embeddings [B, S, D]; positions: [S] or [B, S].  ``lanes`` (i64[B])
    maps batch rows to rows of ``caches``/``states`` (a slot pool); left
    out, row b is row b.  Returns (logits, caches, states, aux); caches
    and states are updated in place (rwkv without states starts from
    zeros)."""
    check_kind(cfg)
    if cfg.frontend == "token":
        x = embed(inputs, params["embedding"])
    else:
        x = inputs.to(getattr(torch, cfg.dtype))
    windows = layer_windows(cfg)
    if cfg.kind == "rwkv" and states is None:
        _, states = init_caches(cfg, x.shape[0], 0, x.device)
    index = (attention.cache_index(positions, x.shape[0], lanes)
             if caches is not None and cfg.kind != "rwkv" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer_p in enumerate(params["layers"]):
        cache = (None if caches is None
                 else {k: v[i] for k, v in caches.items()})
        state = None
        if states is not None:
            state = {k: v[i] if lanes is None else v[i][lanes]
                     for k, v in states.items()}
        x, _, new_state, layer_aux = block_forward(
            layer_p, x, positions, cfg,
            window=None if windows is None else windows[i], cache=cache,
            state=state, index=index, per_row=lanes is not None)
        if layer_aux is not None:
            aux = aux + layer_aux
        if states is not None:
            for k, v in new_state.items():
                if lanes is None:
                    states[k][i].copy_(v)
                else:
                    states[k][i][lanes] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed", params["embedding"]))
    return logits, caches, states, aux
