"""Wordcount over sliding windows (paper §8.1 Q1), in NumPy.

Windows cover ``[l * wa, l * wa + ws)``.  A tuple counts once for each key
of its key set (a word repeated in a tweet counts once) in every window
that holds its event time.  A window closes when the watermark, the
largest event time released so far, reaches its end; it then emits, for
every key it counted, ``(l * wa + ws, key, count)``.  Generations before
the first released tuple's earliest window are never opened.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np


def earliest_window(tau: int, wa: int, ws: int) -> int:
    return (tau - ws) // wa + 1


def closing(ticks: Iterable[Optional[Tuple[int, int]]], wa: int,
            ws: int) -> List[Tuple[int, int]]:
    """For each tick, given ``(min, max)`` of the event times it released
    (None for none), the generations ``[lo, hi)`` that close at it."""
    next_l, wmark, out = None, 0, []
    for mm in ticks:
        if mm is not None:
            if next_l is None:
                next_l = earliest_window(mm[0], wa, ws)
            wmark = max(wmark, mm[1])
        if next_l is None:
            out.append((0, 0))
            continue
        new = max(next_l, earliest_window(wmark, wa, ws))
        out.append((next_l, new))
        next_l = new
    return out


def distinct_keys(keys: np.ndarray) -> np.ndarray:
    """The keys of each tuple's key set, a repeated key once, -1 dropped."""
    if keys.size == 0:
        return np.zeros((0,), np.int64)
    k = np.sort(keys, axis=1)
    first = np.ones(k.shape, bool)
    first[:, 1:] = k[:, 1:] != k[:, :-1]
    return k[first & (k >= 0)].astype(np.int64)


def window_counts(tau: np.ndarray, keys: np.ndarray, lo: int, hi: int,
                  lost: Tuple = ()) -> Counter:
    """Per key, the tuples with ``lo <= tau < hi`` that hold it.  ``lost``
    (the control) holds ``(gamma, moved)`` switches whose moved keys lose
    what they counted up to ``gamma``."""
    sel = (tau >= lo) & (tau < hi)
    counts = np.bincount(distinct_keys(keys[sel]))
    for gamma, moved in lost:
        if lo <= gamma < hi:
            before = np.bincount(distinct_keys(keys[sel & (tau <= gamma)]),
                                 minlength=counts.shape[0])
            m = np.zeros(counts.shape[0], bool)
            m[:moved.shape[0]] = moved[:counts.shape[0]]
            counts = np.where(m, counts - before[:counts.shape[0]], counts)
    nz = np.nonzero(counts)[0]
    return Counter({(int(k), int(counts[k])): 1 for k in nz})


def expected(lo_hi: Tuple[int, int], wa: int, ws: int,
             tuples_between: Callable[[int, int], Tuple[np.ndarray,
                                                         np.ndarray]],
             lost: Tuple = ()) -> Counter:
    """The outputs ``(tau, key, count)`` of the generations ``[lo, hi)``
    closing at one tick; ``tuples_between(a, b)`` gives the event times and
    key sets of the released tuples with ``a <= tau < b``."""
    out = Counter()
    for l in range(*lo_hi):
        a, b = l * wa, l * wa + ws
        tau, keys = tuples_between(a, b)
        for (k, c), n in window_counts(tau, keys, a, b, lost).items():
            out[(b, k, c)] += n
    return out
