"""Decoder stack assembly: block dispatch by arch kind, embeddings/unembed,
the training loss.

Held against ``src/repro/models/transformer.py`` for the kinds ``dense``
(with ``window_pattern`` and ``frontend="embedding_stub"``), ``moe``,
``rwkv`` and ``hybrid`` (attention and SSM heads side by side on one
input, ``x + 0.5 * (attn + ssm)``).
Layers are a Python list walked in order (the reference's ``scan_layers``
stacks them; ``convert.to_reference`` gives that layout).  ``cfg.remat``
is the reference's ``jax.checkpoint(run_block)``: while gradients are on,
each block runs under non-reentrant ``torch.utils.checkpoint``, so its
backward recomputes the block's forward (the model kernels launch twice a
block, forward and recompute, and their backward kernels once).
Parameters are a dict with ``layers`` a list of per-layer dicts; caches
and recurrent states keep the reference's stacked ``[L, B, ...]`` layout
(rwkv's a dict, hybrid's one float32 ``[L, B, H, n_state, head_dim]``
tensor), and ``forward`` updates them in place (the reference returns new
arrays) and returns them with the reference's ``aux``, the MoE tokens
dropped over the layers.  Without states (training, a prefill that keeps
none) rwkv and hybrid layers start from zeros and no state is kept or
returned: nothing is written in place, so a training step's graph holds
no copy into a state buffer.  With a slot pool (``lanes``) an MoE layer
routes each batch row
as a group of its own, as the reference's serving engine decodes each lane
under its ``vmap``; otherwise the ``[B, S]`` block is one group, as in the
reference's ``forward``.  ``live`` (bool ``[B]``) marks the rows that are
real requests: the serving engine pads a round to its bucket with rows
that read and write a scratch row of the pool, and their MoE drops are
not counted.
``init_params`` draws from an explicit ``torch.Generator`` on the target
device: the reference's distributions, not JAX's bits (the tests carry
the reference's own parameters across with ``convert.from_reference``).
``loss_fn`` is the reference's masked next-token cross-entropy over a
float32 log-softmax of the padded vocab.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch import device as _device
from repro_torch.models import attention, moe as moe_mod, rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, init_dense, rms_norm, swiglu,
                                       unembed)
from repro_torch.models.sharding import shard, sharded_logprob

BIG_WINDOW = 1 << 30
KINDS = ("dense", "moe", "rwkv", "hybrid")


def check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown model kind {cfg.kind!r} ({cfg.name}); "
                         f"the kinds are {KINDS}")


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
    if cfg.kind == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device)
        p["norm1b"] = torch.zeros((d,), dtype=dtype, device=device)
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
                  cache=None, state=None, index=None, per_row=False,
                  live=None):
    """One decoder block.  Returns (x, cache, new_state, aux), ``aux`` the
    MoE tokens dropped (float32; None for the other kinds).  ``index``:
    the forward's ``attention.cache_index``, shared by its layers;
    ``per_row``: route the MoE per batch row; ``live``: the rows whose
    drops count."""
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
    if cfg.kind == "hybrid":
        ssm_out, state = ssm_mod.ssm_forward(
            p["ssm"], rms_norm(x, p["norm1b"], cfg.norm_eps), cfg, state)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.kind == "moe":
        ffn_out, dropped = moe_mod.moe_forward(p["moe"], h, cfg,
                                               per_row=per_row, live=live)
        aux = dropped.to(torch.float32)
    else:
        ffn_out = swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
        ffn_out = shard(ffn_out, "batch", "seq", "embed")
    return x + ffn_out, cache, state, aux


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    with the reference's distributions (``init_dense``: normal over
    sqrt(fan_in), embeddings 0.02), made on ``device`` (default: the
    card; ``"meta"``: shapes and dtypes only)."""
    check_kind(cfg)
    dev = _device.resolve(device)
    # on the meta device (model.abstract_params) nothing is drawn
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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
    """Stacked [L, ...] KV caches (dense, moe, hybrid) and recurrent
    states (rwkv; hybrid's SSM state)."""
    check_kind(cfg)
    dev = _device.resolve(device)
    stack = lambda tree: {k: torch.stack([v] * cfg.n_layers)
                          for k, v in tree.items()}
    if cfg.kind == "rwkv":
        return None, stack(rwkv_mod.init_rwkv_state(cfg, batch, dev))
    caches = stack(attention.init_cache(cfg, batch, max_seq,
                                        getattr(torch, cfg.dtype), dev))
    states = None
    if cfg.kind == "hybrid":
        states = torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                              cfg.ssm_state, cfg.head_dim),
                             dtype=torch.float32, device=dev)
    return caches, states


def _state_at(states, i: int, lanes):
    """Layer ``i``'s state (rows ``lanes``, or all), dict or tensor."""
    take = lambda v: v[i] if lanes is None else v[i][lanes]
    if isinstance(states, torch.Tensor):
        return take(states)
    return {k: take(v) for k, v in states.items()}


def _state_put(states, i: int, lanes, new) -> None:
    """Write layer ``i``'s new state back in place."""
    pairs = ([(states, new)] if isinstance(states, torch.Tensor)
             else [(states[k], v) for k, v in new.items()])
    for dst, v in pairs:
        if lanes is None:
            dst[i].copy_(v)
        else:
            dst[i][lanes] = v


def forward(params, cfg: ModelConfig, inputs, positions, *, caches=None,
            states=None, lanes=None, live=None):
    """inputs: tokens [B, S] (frontend="token") or precomputed frontend
    embeddings [B, S, D]; positions: [S] or [B, S].  ``lanes`` (i64[B])
    maps batch rows to rows of ``caches``/``states`` (a slot pool); left
    out, row b is row b.  ``live`` (bool [B], with ``lanes``): the rows
    whose MoE drops count.  Returns (logits, caches, states, aux); caches
    and states are updated in place.  Without ``states`` the rwkv and
    hybrid layers start from zeros and the returned states are None."""
    check_kind(cfg)
    if cfg.frontend == "token":
        x = embed(inputs, params["embedding"])
    else:
        x = inputs.to(getattr(torch, cfg.dtype))
    x = shard(x, "batch", "seq", "embed")
    windows = layer_windows(cfg)
    zero_state = None
    if cfg.kind == "rwkv" and states is None:
        zero_state = rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.device)
    index = (attention.cache_index(positions, x.shape[0], lanes)
             if caches is not None and cfg.kind != "rwkv" else None)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer_p in enumerate(params["layers"]):
        cache = (None if caches is None
                 else {k: v[i] for k, v in caches.items()})
        state = (zero_state if states is None
                 else _state_at(states, i, lanes))
        kw = dict(window=None if windows is None else windows[i],
                  cache=cache, state=state, index=index,
                  per_row=lanes is not None, live=live)
        if remat:
            # the reference's jax.checkpoint(run_block): the backward
            # recomputes the block
            x, _, new_state, layer_aux = torch.utils.checkpoint.checkpoint(
                block_forward, layer_p, x, positions, cfg,
                use_reentrant=False, preserve_rng_state=False, **kw)
        else:
            x, _, new_state, layer_aux = block_forward(
                layer_p, x, positions, cfg, **kw)
        if layer_aux is not None:
            aux = aux + layer_aux
        if states is not None:
            _state_put(states, i, lanes, new_state)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, params.get("unembed", params["embedding"]))
    return shard(logits, "batch", "seq", "vocab"), caches, states, aux


def loss_fn(params, cfg: ModelConfig, inputs, labels, mask, positions):
    """Masked next-token cross-entropy: ``-sum(ll * mask) / max(sum(mask),
    1)`` with ``ll`` the label's float32 log-softmax over the padded vocab.
    -> (loss, aux), aux the MoE tokens dropped (float32)."""
    logits, _, _, aux = forward(params, cfg, inputs, positions)
    ll = sharded_logprob(logits.float(), labels.long()[..., None])[..., 0]
    n = torch.clamp(mask.sum(), min=1.0)
    return -(ll * mask).sum() / n, aux
