"""Peaks of one H100 and the least time of each layer's work.

Frozen from ``chip_smoke.py``: the peaks (lines 258-267: HBM3 at 3.35
TB/s, 67 TFLOP/s float32 outside the tensor cores, 132 SMs x 64 INT32
lanes x 1.98 GHz), ``bound`` (its line 354: the larger of bytes over the
memory rate and operations over their peak), the merge's bytes and
operations (line 520: keys, taus and flags in, an 8-byte order out, an
``n log n`` compare count) and ``segment_aggregate``'s (line 846: keys,
slots and values read once, the accumulator read once and written once,
one add a live hit).  The join's count is the benchmark's own: each
comparison the inputs need (``reference.bandjoin.BandJoin.comparisons``)
costs a subtract, an absolute value and a compare on each of its
attributes in float32 and an event-time compare in int32, as
``chip_smoke.py``'s ``window_join`` row counts them (line 971); the live
window is read once and each tick's tuples and outputs once.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(n_bytes: float, int_ops: float = 0.0, fp_ops: float = 0.0) -> float:
    """Least seconds for the work on the card."""
    return max(n_bytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S,
               fp_ops / FP32_OPS_PER_S)


def merge_call(n: int) -> float:
    """One ``scalegate_merge`` call over ``n`` lanes."""
    return bound(n * (4 + 4 + 1) + n * 8 + 4,
                 int_ops=n * math.ceil(math.log2(max(n, 2))))


def segment_aggregate_call(rows: int, w: int, k: int, s: int,
                           hits: float) -> float:
    """One ``segment_aggregate`` call: ``rows`` hit rows of width ``w``
    into an accumulator ``[k, s, w]``, ``hits`` of them live."""
    return bound(rows * (8 + 4 * w) + 2 * k * s * w * 4, fp_ops=hits * w)


def join_tick(comparisons: int, live_window: int, tick: int, outputs: int,
              n_attrs: int, payload_width: int) -> float:
    """One ScaleJoin tick: ``comparisons`` pairs compared, the
    ``live_window`` stored tuples read once (event time, stream and the
    compared attributes), the ``tick`` incoming tuples read once and
    stored once, the ``outputs`` written once (event time, two payloads,
    a flag)."""
    n_bytes = (live_window * (8 + 4 * n_attrs)
               + tick * (12 + 4 * payload_width) * 2
               + outputs * (4 + 8 * payload_width + 1))
    return bound(n_bytes, int_ops=comparisons,
                 fp_ops=3 * n_attrs * comparisons)
