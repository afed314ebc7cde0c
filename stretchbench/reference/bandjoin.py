"""A band join of two streams over a time window (ScaleJoin, paper §8.3
Q3), in NumPy.

Every pair of tuples from opposite streams whose event times lie at most
``ws`` apart and whose first ``n_attrs`` attributes each lie at most
``band`` apart is emitted once, when the later of the two is released,
with the later one's event time plus ``wa``.  A pair is compared here as
an unordered pair of payloads.  The arithmetic is float32's, as the
attributes are: ``|a - b| <= band`` with the difference rounded once.
``attr_dtype="bfloat16"`` (the control) rounds the attributes and their
difference to bfloat16 instead.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "float32":
        return x.astype(np.float32)
    import torch
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _near(x: np.ndarray, y: np.ndarray, band: float, dtype: str):
    """``|x - y| <= band`` on every attribute (rows of ``y`` against the
    row ``x``, or pairwise rows), in ``dtype``."""
    d = np.abs(_round(_round(x, dtype) - _round(y, dtype), dtype))
    return (d <= np.float32(band)).all(axis=-1)


def pair_key(tau: int, p: np.ndarray, q: np.ndarray):
    a, b = tuple(float(v) for v in p), tuple(float(v) for v in q)
    return (int(tau),) + ((a, b) if a <= b else (b, a))


class BandJoin:
    """The join over a stream of tuples ``tau``, ``src``, ``pay`` (all the
    tuples of the run, the prefilled window first), each released at tick
    ``rel`` (-1: before the first tick; a large number: not yet)."""

    def __init__(self, tau, src, pay, rel, *, ws: int, wa: int, band: float,
                 n_attrs: int):
        self.tau = np.asarray(tau, np.int64)
        self.src = np.asarray(src, np.int64)
        self.pay = np.asarray(pay, np.float32)
        self.attr = self.pay[:, :n_attrs]
        self.rel = np.asarray(rel, np.int64)
        self.ws, self.wa, self.band = ws, wa, band

    def _stored(self, t: int, since: int) -> np.ndarray:
        """Ids released before tick ``t`` with ``tau >= since``, sorted by
        their first attribute."""
        ids = np.nonzero((self.rel < t) & (self.tau >= since))[0]
        return ids[np.argsort(self.attr[ids, 0], kind="stable")]

    def expected(self, t: int, attr_dtype: str = "float32") -> Counter:
        """The pairs emitted at tick ``t`` as ``(tau, payload, payload)``."""
        new = np.nonzero(self.rel == t)[0]
        out = Counter()
        if new.size == 0:
            return out
        stored = self._stored(t, int(self.tau[new].min()) - self.ws)
        a0 = self.attr[stored, 0]
        # candidates by the first attribute, widened past any rounding;
        # the predicate below decides
        slack = self.band + (256.0 if attr_dtype != "float32" else 1.0)
        lo = np.searchsorted(a0, self.attr[new, 0] - slack, side="left")
        hi = np.searchsorted(a0, self.attr[new, 0] + slack, side="right")
        for x, a, b in zip(new, lo, hi):
            y = stored[a:b]
            y = y[(self.src[y] != self.src[x])
                  & (self.tau[y] >= self.tau[x] - self.ws)]
            y = y[_near(self.attr[x], self.attr[y], self.band, attr_dtype)]
            for j in y:
                out[pair_key(self.tau[x] + self.wa, self.pay[x],
                             self.pay[j])] += 1
        # pairs inside the tick: each unordered cross-stream pair once
        i, j = np.triu_indices(new.size, k=1)
        i, j = new[i], new[j]
        ok = ((self.src[i] != self.src[j])
              & (np.abs(self.tau[i] - self.tau[j]) <= self.ws))
        i, j = i[ok], j[ok]
        ok = _near(self.attr[i], self.attr[j], self.band, attr_dtype)
        for p, q in zip(i[ok], j[ok]):
            out[pair_key(max(self.tau[p], self.tau[q]) + self.wa,
                         self.pay[p], self.pay[q])] += 1
        return out

    def live(self, t: int) -> int:
        """The stored tuples tick ``t``'s earliest tuple still sees."""
        new = np.nonzero(self.rel == t)[0]
        if new.size == 0:
            return 0
        since = int(self.tau[new].min()) - self.ws
        return int(((self.rel < t) & (self.tau >= since)).sum())

    def comparisons(self, t: int) -> int:
        """The comparisons tick ``t`` needs: each released tuple against
        every live opposite-stream tuple released before it (before the
        tick, or earlier in the tick)."""
        new = np.nonzero(self.rel == t)[0]
        if new.size == 0:
            return 0
        total = 0
        for s in (0, 1):
            st = np.sort(self.tau[(self.rel < t) & (self.src == s)])
            x = self.tau[new[self.src[new] != s]]
            total += int((st.size - np.searchsorted(st, x - self.ws,
                                                    side="left")).sum())
        i, j = np.triu_indices(new.size, k=1)
        total += int(((self.src[new[i]] != self.src[new[j]])
                      & (np.abs(self.tau[new[i]] - self.tau[new[j]])
                         <= self.ws)).sum())
        return total
