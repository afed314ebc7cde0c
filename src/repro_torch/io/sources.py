"""Stream sources: rate-controlled synthetic generators and file/replay.

Held against ``src/repro/io/sources.py``.  A source is an iterable of
``TupleBatch`` ticks plus two bits of shape the runtime needs up front
(``n_inputs``, and optionally a nominal offered rate).  Event time
(``tau``) always comes from the batches themselves: the paper's streams
are event-timed (§2.1), and replaying a recorded stream must preserve its
timestamps exactly, which is what makes the async-vs-sync and
live-vs-static parity checks meaningful.

``RateSchedule`` describes the *offered* load as piecewise-constant phases
(the Q5 abruptly-changing trace).  It serves two masters:

* pacing: a ``SyntheticSource`` with ``pace=True`` sleeps between ticks so
  the wall-clock offered rate tracks the schedule (a live workload);
* determinism: ``rate_hint(tick)`` gives controllers the offered rate as a
  deterministic function of the tick index, so closed-loop drills and
  tests reconfigure at reproducible points with no wall clock in the loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import tuples as T


@dataclasses.dataclass(frozen=True)
class RateSchedule:
    """Piecewise-constant offered rate: [(n_ticks, tuples_per_s), ...].
    Past the last phase the final rate holds."""
    phases: Tuple[Tuple[int, float], ...]

    def __post_init__(self):
        assert self.phases, "empty rate schedule"

    @property
    def total_ticks(self) -> int:
        return sum(n for n, _ in self.phases)

    def rate_at(self, tick: int) -> float:
        for n, rate in self.phases:
            if tick < n:
                return float(rate)
            tick -= n
        return float(self.phases[-1][1])


class SyntheticSource:
    """Wraps a generator of ``TupleBatch`` ticks (e.g. ``datagen.tweets``)
    with an optional offered-rate schedule.

    ``pace=True`` turns it into a live source: emission of tick i is
    delayed until ``tick_size / rate_at(i)`` seconds after tick i-1, so a
    slow consumer sees queue growth and a fast one sees idle gaps.
    Unpaced, it is free-running (benchmarks measure the pipeline, not the
    sleep)."""

    def __init__(self, batches: Iterable[T.TupleBatch], *, n_inputs: int = 1,
                 schedule: Optional[RateSchedule] = None, pace: bool = False,
                 tick_size: Optional[int] = None):
        self._batches = batches
        self.n_inputs = n_inputs
        self.schedule = schedule
        self.pace = pace and schedule is not None
        self.tick_size = tick_size

    def rate_hint(self, tick: int) -> Optional[float]:
        return self.schedule.rate_at(tick) if self.schedule else None

    def __iter__(self) -> Iterator[T.TupleBatch]:
        next_emit = time.perf_counter()
        for i, b in enumerate(self._batches):
            if self.pace:
                now = time.perf_counter()
                if now < next_emit:
                    time.sleep(next_emit - now)
                n = self.tick_size or b.batch
                next_emit = max(now, next_emit) + n / max(
                    self.schedule.rate_at(i), 1e-9)
            yield b


class ReplaySource:
    """Replays a recorded list of ticks, timestamps intact: the way to feed
    the exact same stream to an async run, a sync run and a static
    oracle."""

    def __init__(self, batches: Sequence[T.TupleBatch], *, n_inputs: int = 1,
                 schedule: Optional[RateSchedule] = None):
        self.batches = list(batches)
        self.n_inputs = n_inputs
        self.schedule = schedule

    def rate_hint(self, tick: int) -> Optional[float]:
        return self.schedule.rate_at(tick) if self.schedule else None

    def __iter__(self) -> Iterator[T.TupleBatch]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)

    def from_tick(self, tick: int) -> "ReplaySource":
        """The suffix stream starting at tick index ``tick``."""
        return ReplaySource(self.batches[tick:], n_inputs=self.n_inputs,
                            schedule=self.schedule)


def save_stream(path: str, batches: Sequence[T.TupleBatch], *,
                n_inputs: int = 1) -> None:
    """Persist a tick stream as one ``.npz`` (uniform tick shapes stacked
    on a leading T axis) for later ``load_stream`` replay."""
    batches = list(batches)
    arrays = {f: np.stack([getattr(b, f).cpu().numpy() for b in batches])
              for f in T.FIELDS}
    np.savez_compressed(path, n_inputs=np.int32(n_inputs), **arrays)


def load_stream(path: str, *, from_tick: int = 0,
                device=None) -> ReplaySource:
    """Load a stream saved by ``save_stream`` as a ``ReplaySource`` whose
    ticks lie on ``device`` (default: the card); ``from_tick`` skips the
    prefix a snapshot already covers."""
    dev = _device.resolve(device)
    with np.load(path) as z:
        n_inputs = int(z["n_inputs"])
        fields = {f: z[f][from_tick:] for f in T.FIELDS}
    n_ticks = fields["tau"].shape[0]
    batches: List[T.TupleBatch] = []
    for t in range(n_ticks):
        batches.append(T.TupleBatch(**{
            f: torch.tensor(v[t], dtype=T.DTYPES[f], device=dev)
            for f, v in fields.items()}))
    return ReplaySource(batches, n_inputs=n_inputs)
