"""Reconfiguration requests (paper §3 controller API, §8.4).

Held against ``src/repro/core/controller.py``: the ``Reconfiguration``
record and the balanced key map, in numpy.  The controllers themselves
come with the live-runtime slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Reconfiguration:
    epoch: int
    n_active: int
    fmu: np.ndarray       # i32[K]
    active: np.ndarray    # bool[n_max]


def balanced_fmu(k_virt: int, n_active: int, n_max: int) -> np.ndarray:
    """Round-robin key -> instance map over the active prefix."""
    return (np.arange(k_virt) % max(n_active, 1)).astype(np.int32)


def active_mask(n_active: int, n_max: int) -> np.ndarray:
    m = np.zeros((n_max,), bool)
    m[:n_active] = True
    return m
