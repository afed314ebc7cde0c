"""Carry the reference's parameter trees, caches and recurrent states into
the port.

``from_reference`` takes the tree of ``repro.models.transformer.
init_params`` with its leaves as numpy arrays (``np.asarray`` of each JAX
leaf).  Each leaf keeps its dtype; a bfloat16 leaf (numpy's ``bfloat16``
extension dtype, which numpy itself cannot compute in) goes through
float32, which holds every bfloat16 value exactly.  Layers stacked
``[L, ...]`` under ``scan_layers`` become the port's list of per-layer
dicts, whatever they hold: attention, the dense ``mlp``, the ``moe``
leaves (``router``, ``wg``, ``wu``, ``wd``, ``shared_*``), rwkv's, or the
hybrid's ``ssm`` (its float32 ``a_log`` included) and ``norm1b``.
``from_reference_caches`` does the same for ``init_caches``' stacked
caches and states (a dict of leaves, or the hybrid's one ``[L, B, H,
n_state, head_dim]`` array), whose layout the port keeps, so tests can
hand both packages one slot pool.

``to_reference`` is ``from_reference``'s inverse: the port's parameters
in the reference's layout (layers stacked ``[L, ...]`` under
``scan_layers``, a list of per-layer dicts otherwise), as torch tensors
on their device.  ``opt_to_reference`` and ``opt_from_reference`` do the
same for ``adamw.OptState`` (its ``mu`` and ``nu`` trees are shaped like
the parameters).  The training launcher saves ``(params, opt)`` in that
layout, so a checkpoint directory written by either package restores in
the other.  ``from_reference`` also takes torch leaves (a restored
checkpoint's).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptState


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaf(dev):
    def leaf(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.detach().to(dev, copy=True)
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)       # a writable copy
    return leaf


def from_reference(np_params: Dict[str, Any], cfg: ModelConfig,
                   device=None) -> Dict[str, Any]:
    """The reference's parameters as the port's, on ``device`` (default:
    the card)."""
    leaf = _leaf(_device.resolve(device))
    out = {k: leaf(v) for k, v in np_params.items() if k != "layers"}
    layers = np_params["layers"]
    if isinstance(layers, dict):                    # stacked [L, ...]
        layers = [_tree(layers, lambda a, i=i: a[i] if isinstance(
                      a, torch.Tensor) else np.asarray(a)[i])
                  for i in range(cfg.n_layers)]
    out["layers"] = [_tree(lp, leaf) for lp in layers]
    return out


def from_reference_caches(caches, states, device=None):
    """``init_caches``' ``(caches, states)`` (numpy leaves, stacked
    ``[L, B, ...]``) as the port's, on ``device``."""
    leaf = _leaf(_device.resolve(device))
    return (None if caches is None else _tree(caches, leaf),
            None if states is None else _tree(states, leaf))


def to_reference(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters in the reference's layout (torch tensors on
    their device): layers stacked ``[L, ...]`` when ``cfg.scan_layers``,
    else the list of per-layer dicts."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    if cfg.scan_layers:
        layers = _stack(layers)
    out["layers"] = layers
    return out


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def opt_to_reference(opt, cfg: ModelConfig):
    """An ``adamw.OptState`` with its moments in the reference's layout."""
    return OptState(to_reference(opt.mu, cfg), to_reference(opt.nu, cfg),
                    opt.step)


def opt_from_reference(opt, cfg: ModelConfig, device=None):
    """The reference's ``OptState`` (numpy or torch leaves) as the port's,
    on ``device``."""
    dev = _device.resolve(device)
    return OptState(from_reference(opt.mu, cfg, dev),
                    from_reference(opt.nu, cfg, dev),
                    _leaf(dev)(opt.step))
