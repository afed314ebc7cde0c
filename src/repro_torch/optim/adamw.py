"""AdamW with a cosine schedule and global-norm clipping.

Held against ``src/repro/optim/adamw.py``: the same arithmetic, leaf by
leaf over the port's parameter trees (``repro_torch.tree``).  The global
norm is taken over the gradients as given (bfloat16 in a train step) in
float32; the moments are float32; the update ``p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p)`` is computed in float32 and cast to the
parameter's dtype.  It is not ``torch.optim.AdamW``, whose decoupled
``p *= 1 - lr * wd`` rounds differently.  Everything stays on the
parameters' device: ``OptState.step`` is an int32 scalar tensor there,
and ``apply_updates`` reads nothing back to the host.  The reference's
ZeRO-1 sharding of the moments needs the model mesh (ROADMAP.md queue 1
item 10); on one device the state is whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor


def init_opt(params) -> OptState:
    """Zero float32 moments shaped like ``params`` and step 0 (int32), on
    the parameters' device."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``, then a cosine down to a tenth of it;
    ``step`` an int32 tensor, the result float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    """sqrt of the sum over leaves (``flatten``'s order) of the float32
    sum of squares."""
    total = 0
    for g in tree_leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def apply_updates(params, grads, opt: OptState, cfg: AdamWConfig):
    """-> (new params, new ``OptState``, {"grad_norm", "lr"}), all new
    tensors (the inputs are left as they are)."""
    step = opt.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g.square()
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (params, grads, opt.mu, opt.nu)))]
    pick = lambda i: tree_unflatten(params, [o[i] for o in out])
    return pick(0), OptState(pick(1), pick(2), step), {"grad_norm": gn,
                                                      "lr": lr}
