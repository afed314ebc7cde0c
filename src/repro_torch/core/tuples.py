"""Tuple batches, the unit of data of the runtime.

Held against ``src/repro/core/tuples.py``.  A ``TupleBatch`` is a
structure-of-arrays view of ``B`` tuples ``<tau, ..., [phi...]>`` (paper
§2.1) as tensors on one device: int32 ``tau``/``keys``/``source``/
``ctrl_epoch``, float32 ``payload``, bool ``valid``/``is_control``.
``keys`` is the multi-key set ``f_MK(t)`` padded with ``NO_KEY``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device

NO_KEY = -1  # padding value inside the multi-key set

DTYPES = {"tau": torch.int32, "keys": torch.int32, "payload": torch.float32,
          "source": torch.int32, "valid": torch.bool,
          "is_control": torch.bool, "ctrl_epoch": torch.int32}
FIELDS = tuple(DTYPES)


@dataclasses.dataclass(frozen=True)
class TupleBatch:
    tau: torch.Tensor          # i32[B]
    keys: torch.Tensor         # i32[B, KMAX]
    payload: torch.Tensor      # f32[B, P]
    source: torch.Tensor       # i32[B]
    valid: torch.Tensor        # bool[B]
    is_control: torch.Tensor   # bool[B]
    ctrl_epoch: torch.Tensor   # i32[B]

    @property
    def batch(self) -> int:
        return self.tau.shape[0]

    @property
    def kmax(self) -> int:
        return self.keys.shape[1]

    @property
    def payload_width(self) -> int:
        return self.payload.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tau.device

    def to(self, device, non_blocking: bool = False) -> "TupleBatch":
        return TupleBatch(**{f: getattr(self, f).to(device,
                                                     non_blocking=non_blocking)
                             for f in FIELDS})


def _tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def make_batch(tau, payload, keys=None, source=None, valid=None,
               is_control=None, ctrl_epoch=None, kmax: int = 1,
               device=None) -> TupleBatch:
    """Build a TupleBatch from plain arrays, filling defaults."""
    dev = _device.resolve(device)
    tau = _tensor(tau, torch.int32, dev)
    b = tau.shape[0]
    payload = _tensor(payload, torch.float32, dev)
    if payload.ndim == 1:
        payload = payload[:, None]
    if keys is None:
        keys = torch.full((b, kmax), NO_KEY, dtype=torch.int32, device=dev)
    else:
        keys = _tensor(keys, torch.int32, dev)
        if keys.ndim == 1:
            keys = keys[:, None]

    def field(x, dtype, fill):
        if x is None:
            return torch.full((b,), fill, dtype=dtype, device=dev)
        return _tensor(x, dtype, dev)

    return TupleBatch(tau=tau, keys=keys, payload=payload,
                      source=field(source, torch.int32, 0),
                      valid=field(valid, torch.bool, True),
                      is_control=field(is_control, torch.bool, False),
                      ctrl_epoch=field(ctrl_epoch, torch.int32, 0))


def empty_batch(b: int, kmax: int, payload_width: int,
                device=None) -> TupleBatch:
    dev = _device.resolve(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return TupleBatch(
        tau=torch.zeros((b,), **i32),
        keys=torch.full((b, kmax), NO_KEY, **i32),
        payload=torch.zeros((b, payload_width), dtype=torch.float32,
                            device=dev),
        source=torch.zeros((b,), **i32),
        valid=torch.zeros((b,), dtype=torch.bool, device=dev),
        is_control=torch.zeros((b,), dtype=torch.bool, device=dev),
        ctrl_epoch=torch.zeros((b,), **i32),
    )


def concat(a: TupleBatch, b: TupleBatch) -> TupleBatch:
    return TupleBatch(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                         for f in FIELDS})


def take(batch: TupleBatch, idx: torch.Tensor,
         fill_invalid: Optional[torch.Tensor] = None) -> TupleBatch:
    """Gather lanes ``idx``; lanes where ``fill_invalid`` is True are invalidated."""
    idx = idx.long()
    out = TupleBatch(**{f: getattr(batch, f)[idx] for f in FIELDS})
    if fill_invalid is not None:
        out = dataclasses.replace(out, valid=out.valid & ~fill_invalid)
    return out
