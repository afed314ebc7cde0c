"""Public step functions of the serving path: prefill_step,
prefill_with_cache, decode_step.

Held against ``src/repro/models/model.py`` (``train_step`` waits for the
training slice).  ``decode_step`` takes ``pos`` as an int or as ``[B]``
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

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


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
                lanes=None, with_aux: bool = False):
    """One new token per lane against the KV cache / recurrent state.

    token: [B] ids (or [B, D] stub embeddings); pos: int or [B] positions.
    """
    inputs = token[:, None]
    positions = torch.as_tensor(pos, device=token.device).reshape(-1, 1)
    if positions.shape[0] == 1:
        positions = positions.expand(token.shape[0], 1)
    logits, caches, states, aux = transformer.forward(
        params, cfg, inputs, positions, caches=caches, states=states,
        lanes=lanes)
    return (logits[:, -1], caches, states) + ((aux,) if with_aux else ())
