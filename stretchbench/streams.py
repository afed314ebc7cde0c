"""The benchmark's stream generators: frozen copies of the port's.

``tweet_ticks`` is ``src/repro_torch/data/datagen.py`` ``tweets`` (wordcount
mode, one source) and ``key_of`` its ``_key_of``; ``scalejoin_ticks`` is
``datagen.scalejoin``.  The draws are the same numpy calls in the same
order, so a seed gives the port's stream; the copy adds a key-skew choice
(``words="uniform"`` draws words uniformly over the vocabulary in place of
Zipf(``zipf_a``)) and ScaleJoin's own row schema (``rows="scalejoin"``,
``scalejoin_rows``) beside datagen's uniform floats.  Ticks come back as numpy arrays, not tensors.

``Pool`` replays a pool of ticks drawn in set-up, cycle after cycle, with
every event time of a cycle shifted by the pool's span, as
``chip_smoke.py`` ``general_batches`` shifts its ticks: the stream stays
sorted per source and strictly increasing across ticks, and nothing is
drawn inside the measured window.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def key_of(words: np.ndarray, k_virt: int) -> np.ndarray:
    """datagen ``_key_of``: a word's virtual key."""
    return (words * 2654435761 % 2**31 % k_virt).astype(np.int32)


def tweet_ticks(rng: np.random.Generator, *, n_ticks: int, tick: int,
                words_per_tweet: int, vocab: int, k_virt: int,
                rate_per_tick: int, words: str = "zipf",
                zipf_a: float = 1.3, tau0: int = 0) -> List[Dict]:
    """datagen ``tweets`` (wordcount): ``n_ticks`` ticks of ``tick`` tweets,
    each a set of ``words_per_tweet`` word keys; event times advance by
    about ``rate_per_tick`` ms a tick; payload[0] is the tweet's length."""
    tau = tau0
    out = []
    for _ in range(n_ticks):
        taus = np.sort(tau + rng.integers(0, rate_per_tick, tick)
                       ).astype(np.int32)
        tau = int(taus.max()) + 1
        if words == "zipf":
            w = rng.zipf(zipf_a, (tick, words_per_tweet)).astype(np.int64) \
                % vocab
        elif words == "uniform":
            w = rng.integers(0, vocab, (tick, words_per_tweet),
                             dtype=np.int64)
        else:
            raise ValueError(f"unknown word distribution {words!r}")
        out.append(dict(
            tau=taus, keys=key_of(w, k_virt),
            payload=np.full((tick, 1), float(words_per_tweet), np.float32),
            src=np.zeros((tick,), np.int32)))
    return out


def scalejoin_ticks(rng: np.random.Generator, *, n_ticks: int, tick: int,
                    rate_t_per_s: float, payload_width: int,
                    rows: str = "datagen", tau0: int = 0) -> List[Dict]:
    """datagen ``scalejoin``: two timestamp-sorted streams (the source id
    0/1 drawn a lane) at ``rate_t_per_s`` tuples a second of event time;
    one key column (key 0), as ``chip_smoke.py`` builds Q3 (``k_virt=1``).
    ``rows="datagen"``: every attribute a float uniform in [1, 10000], as
    datagen draws them.  ``rows="scalejoin"``: ScaleJoin's rows (``rows``)
    in ``payload_width`` >= 7 float32 slots."""
    tau = tau0
    dt = max(int(1000 * tick / rate_t_per_s), 1)
    out = []
    for _ in range(n_ticks):
        taus = np.sort(tau + rng.integers(0, dt, tick)).astype(np.int32)
        tau = int(taus.max()) + 1
        src = rng.integers(0, 2, tick).astype(np.int32)
        if rows == "datagen":
            payload = rng.uniform(1, 10000, (tick, payload_width)
                                  ).astype(np.float32)
        elif rows == "scalejoin":
            payload = scalejoin_rows(rng, src, payload_width)
        else:
            raise ValueError(f"unknown rows {rows!r}")
        out.append(dict(tau=taus, keys=np.zeros((tick, 1), np.int32),
                        payload=payload, src=src))
    return out


def scalejoin_rows(rng: np.random.Generator, src: np.ndarray,
                   width: int) -> np.ndarray:
    """ScaleJoin's band-join rows (the benchmark of handshake join, Teubner
    and Mueller, SIGMOD 2011), each in ``width`` float32 slots.  Stream R
    (source 0): ``<x: int, y: float, z: char[20]>``, 28 bytes; stream S
    (source 1): ``<a: int, b: float, c: double, d: bool>``, 17 bytes.  x, a
    are integers and y, b, c floats, uniform in [1, 10000]; z is 20
    letters, four to a slot as a base-26 number (exact in float32); c is
    its float32 part and the float32 rest; d is 0 or 1; S's last slots
    are 0.  The predicate compares slots 0 and 1: x with a, y with b."""
    n = src.shape[0]
    if width < 7:
        raise ValueError(f"R's 28-byte row needs 7 float32 slots, not {width}")
    first = rng.integers(1, 10001, n)
    second = rng.uniform(1, 10000, n).astype(np.float32)
    letters = rng.integers(0, 26, (n, 5, 4))
    z = (letters * 26 ** np.arange(3, -1, -1)).sum(-1)
    c = rng.uniform(1, 10000, n)
    c_hi = c.astype(np.float32)
    c_lo = (c - c_hi).astype(np.float32)
    d = rng.integers(0, 2, n)
    out = np.zeros((n, width), np.float32)
    out[:, 0], out[:, 1] = first, second
    r, s = src == 0, src == 1
    out[r, 2:7] = z[r]
    out[s, 2], out[s, 3], out[s, 4] = c_hi[s], c_lo[s], d[s]
    return out


def tick_ms(tick: int, rate_t_per_s: float) -> int:
    """The event time one ScaleJoin tick covers (datagen's ``dt``)."""
    return max(int(1000 * tick / rate_t_per_s), 1)


@dataclasses.dataclass
class Pool:
    """A pool of ticks replayed cyclically; tick ``i`` is pool tick ``i %
    P`` with its event times moved on by ``(i // P) * span``."""
    ticks: List[Dict]

    def __post_init__(self):
        first = int(self.ticks[0]["tau"].min())
        last = int(self.ticks[-1]["tau"].max())
        self.span = last + 1 - first

    def __len__(self) -> int:
        return len(self.ticks)

    def tick(self, i: int) -> Dict:
        t = self.ticks[i % len(self.ticks)]
        shift = (i // len(self.ticks)) * self.span
        if shift == 0:
            return t
        return dict(t, tau=(t["tau"].astype(np.int64) + shift
                            ).astype(np.int32))


@dataclasses.dataclass
class Stream:
    """A cell's input: the ``prefill`` tuples already inside the window
    when the run starts (ids ``0 .. base - 1``, or None), then the pool's
    ticks (tick ``i``'s lane ``j`` has id ``base + i * tick + j``).
    ``frontier0`` is each source's latest event time before tick 0."""
    pool: Pool
    n_sources: int
    frontier0: List[int]
    prefill: Dict = None

    @property
    def base(self) -> int:
        return 0 if self.prefill is None else len(self.prefill["tau"])

    @property
    def tick_size(self) -> int:
        return len(self.pool.ticks[0]["tau"])

    def tick(self, i: int) -> Dict:
        return self.pool.tick(i)

    def ids(self, i: int) -> np.ndarray:
        b = self.tick_size
        return self.base + i * b + np.arange(b, dtype=np.int64)

    def keys_of(self, ids: np.ndarray) -> np.ndarray:
        """The key columns of the tuples ``ids``."""
        kmax = self.pool.ticks[0]["keys"].shape[1]
        out = np.empty((len(ids), kmax), np.int32)
        pre = ids < self.base
        if pre.any():
            out[pre] = self.prefill["keys"][ids[pre]]
        rel = ids[~pre] - self.base
        ticks, lanes = rel // self.tick_size, rel % self.tick_size
        rows = np.nonzero(~pre)[0]
        for t in np.unique(ticks):
            sel = ticks == t
            out[rows[sel]] = self.tick(int(t))["keys"][lanes[sel]]
        return out

    def arrays(self, n_ticks: int) -> Dict[str, np.ndarray]:
        """Every tuple of the prefill and of ticks ``0 .. n_ticks - 1``, in
        id order."""
        parts = ([] if self.prefill is None else [self.prefill]) + [
            self.tick(i) for i in range(n_ticks)]
        return {f: np.concatenate([p[f] for p in parts])
                for f in ("tau", "src", "payload")}
