"""Time-based sliding-window arithmetic (paper §2.1).

Held against ``src/repro/core/windows.py``.  Windows cover
``[l*WA, l*WA + WS)``; a tuple with event time ``tau`` falls into window
indices ``l_min = floor((tau - WS) / WA) + 1 .. l_max = floor(tau / WA)``.
The arithmetic works on int32 tensors (floor division and a non-negative
modulus, as ``jnp.floor_divide``/``jnp.mod``) and on Python ints.
"""

from __future__ import annotations

import dataclasses

import torch

SINGLE = "single"
MULTI = "multi"


def _floordiv(x, d: int):
    if isinstance(x, torch.Tensor):
        return torch.div(x, d, rounding_mode="floor")
    return x // d


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    wa: int          # window advance (delta ticks)
    ws: int          # window size    (delta ticks)
    wt: str = MULTI  # window type: "single" | "multi"

    def __post_init__(self):
        if self.wa <= 0 or self.ws <= 0:
            raise ValueError("WA and WS must be positive")
        if self.wt not in (SINGLE, MULTI):
            raise ValueError(f"bad window type {self.wt!r}")

    @property
    def n_slots(self) -> int:
        """Number of concurrently-live window instances per key."""
        if self.wt == SINGLE:
            return 1
        return -(-self.ws // self.wa)  # ceil

    def latest_win_l(self, tau):
        return _floordiv(tau, self.wa)

    def earliest_win_l(self, tau):
        return _floordiv(tau - self.ws, self.wa) + 1

    def window_indices(self, tau):
        return self.earliest_win_l(tau), self.latest_win_l(tau)

    def slot_of(self, l):
        return l % self.n_slots

    def left_of(self, l):
        return l * self.wa

    def right_of(self, l):
        return l * self.wa + self.ws

    def expired(self, l, watermark):
        return self.right_of(l) <= watermark
