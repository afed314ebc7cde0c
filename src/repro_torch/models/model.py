"""Public step functions: train_step, prefill_step, prefill_with_cache,
decode_step; the training shapes without allocation.

Held against ``src/repro/models/model.py``.  ``train_step`` takes the
reference's path: one ``torch.autograd.grad`` of ``transformer.loss_fn``
when ``cfg.n_microbatches`` is 1; otherwise each microbatch's gradients
(in the parameters' dtypes, as ``jax.value_and_grad`` gives them) are
added into float32 buffers, divided by m, and every gradient is cast to
bfloat16 before ``adamw.apply_updates``.  Its metrics stay on the device
(no host read inside the step).  The tensors on ``torch.device("meta")``
that ``make_train_batch_shapes``, ``abstract_params`` and
``abstract_opt`` return are the port's ``jax.ShapeDtypeStruct``s.

``decode_step`` takes ``pos`` as an int or as ``[B]``
positions, one per lane, and ``lanes`` maps the batch onto the rows of a
slot pool's caches (an MoE then routes each lane alone, as the
reference's serving engine does under its per-lane ``vmap``); both step
functions update caches and states in place.  The reference's step
functions drop ``forward``'s ``aux`` (the MoE tokens dropped);
``with_aux=True`` returns it as a fourth value.
The reference's ``chunk`` (its jnp attention's KV chunk) has no
counterpart: the kernel tiles the KV axis itself.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_unflatten

META = torch.device("meta")


def make_train_batch_shapes(cfg: ModelConfig, global_batch: int, seq: int):
    """The train batch's shapes and dtypes, as meta tensors."""
    if cfg.frontend == "token":
        inputs = torch.empty((global_batch, seq), dtype=torch.int32,
                             device=META)
    else:
        inputs = torch.empty((global_batch, seq, cfg.d_model),
                             dtype=torch.bfloat16, device=META)
    return {
        "inputs": inputs,
        "labels": torch.empty((global_batch, seq), dtype=torch.int32,
                              device=META),
        "mask": torch.empty((global_batch, seq), dtype=torch.float32,
                            device=META),
    }


def train_step(params, opt_state, batch: Dict[str, Any], *,
               cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """Forward/backward (+ microbatch grad accumulation) + AdamW update.
    -> (new params, new opt state, metrics {loss, dropped, grad_norm, lr}
    as device scalars).  ``params`` and ``opt_state`` are left as they
    are."""
    inputs, labels, mask = batch["inputs"], batch["labels"], batch["mask"]
    b, s = labels.shape
    positions = torch.arange(s, device=labels.device)
    m = cfg.n_microbatches
    leaves = tree_leaves(params)
    # the step differentiates detached aliases: the caller's tensors keep
    # their requires_grad
    live = [p.detach().requires_grad_() for p in leaves]
    p_live = tree_unflatten(params, live)

    def loss_grads(inp, lab, msk):
        with torch.enable_grad():
            loss, aux = transformer.loss_fn(p_live, cfg, inp, lab, msk,
                                            positions)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), aux.detach(), grads

    if m == 1:
        loss, aux, grads = loss_grads(inputs, labels, mask)
    else:
        assert b % m == 0, (b, m)
        mb = b // m
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=labels.device)
        aux = torch.zeros((), dtype=torch.float32, device=labels.device)
        for i in range(m):
            rows = slice(i * mb, (i + 1) * mb)
            l, a, g = loss_grads(inputs[rows], labels[rows], mask[rows])
            for buf, gi in zip(acc, g):
                buf.add_(gi)
            del g
            loss = loss + l
            aux = aux + a
        grads = [buf / m for buf in acc]
        loss = loss / m
    # the reference casts every gradient to bfloat16 before the update
    # (its cross-replica reduce moves bf16)
    g_tree = tree_unflatten(params, [g.to(torch.bfloat16) for g in grads])
    params, opt_state, om = adamw.apply_updates(params, g_tree, opt_state,
                                                opt_cfg)
    return params, opt_state, {"loss": loss, "dropped": aux, **om}


def prefill_step(params, inputs, *, cfg: ModelConfig):
    """Full-sequence forward without caches; the last position's logits."""
    positions = torch.arange(inputs.shape[1], device=inputs.device)
    logits, _, _, _ = transformer.forward(params, cfg, inputs, positions)
    return logits[:, -1]


def prefill_with_cache(params, inputs, caches, states, *, cfg: ModelConfig,
                       lanes=None, with_aux: bool = False):
    """Prefill that also fills the decode caches (serving path)."""
    positions = torch.arange(inputs.shape[1], device=inputs.device)
    logits, caches, states, aux = transformer.forward(
        params, cfg, inputs, positions, caches=caches, states=states,
        lanes=lanes)
    return (logits[:, -1], caches, states) + ((aux,) if with_aux else ())


def decode_step(params, caches, states, token, pos, *, cfg: ModelConfig,
                lanes=None, live=None, with_aux: bool = False):
    """One new token per lane against the KV cache / recurrent state.

    token: [B] ids (or [B, D] stub embeddings); pos: int or [B] positions
    (a device tensor keeps the depth off the host); ``live`` (bool [B]):
    the lanes whose MoE drops count (``transformer.forward``).
    """
    inputs = token[:, None]
    positions = torch.as_tensor(pos, device=token.device).reshape(-1, 1)
    if positions.shape[0] == 1:
        positions = positions.expand(token.shape[0], 1)
    logits, caches, states, aux = transformer.forward(
        params, cfg, inputs, positions, caches=caches, states=states,
        lanes=lanes, live=live)
    return (logits[:, -1], caches, states) + ((aux,) if with_aux else ())


def abstract_params(cfg: ModelConfig):
    """The parameters' shapes and dtypes (meta tensors), nothing drawn."""
    return transformer.init_params(cfg, device=META)


def abstract_opt(params):
    return adamw.init_opt(params)
