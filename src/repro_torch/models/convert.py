"""Carry the reference's parameter trees, caches and recurrent states into
the port.

``from_reference`` takes the tree of ``repro.models.transformer.
init_params`` with its leaves as numpy arrays (``np.asarray`` of each JAX
leaf).  Each leaf keeps its dtype; a bfloat16 leaf (numpy's ``bfloat16``
extension dtype, which numpy itself cannot compute in) goes through
float32, which holds every bfloat16 value exactly.  Layers stacked
``[L, ...]`` under ``scan_layers`` become the port's list of per-layer
dicts, whatever they hold: attention, the dense ``mlp``, the ``moe``
leaves (``router``, ``wg``, ``wu``, ``wd``, ``shared_*``) or rwkv's.  ``from_reference_caches`` does the same for ``init_caches``'
stacked caches and states, whose layout the port keeps, so tests can hand
both packages one slot pool.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.config import ModelConfig


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaf(dev):
    def leaf(a) -> torch.Tensor:
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
        layers = [_tree(layers, lambda a, i=i: np.asarray(a)[i])
                  for i in range(cfg.n_layers)]
    out["layers"] = [_tree(lp, leaf) for lp in layers]
    return out


def from_reference_caches(caches, states, device=None):
    """``init_caches``' ``(caches, states)`` (numpy leaves, stacked
    ``[L, B, ...]``) as the port's, on ``device``."""
    leaf = _leaf(_device.resolve(device))
    return (None if caches is None else _tree(caches, leaf),
            None if states is None else _tree(states, leaf))
