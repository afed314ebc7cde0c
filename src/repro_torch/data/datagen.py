"""Synthetic stream generators mirroring the paper's workloads (§8).

Held against ``src/repro/data/datagen.py``: the same numpy draws in the
same order, so one seed gives field for field the same stream as the
reference generator, here as the port's ``TupleBatch``es on ``device``.

* ``tweets``    — Q1/Q2: per-tuple word lists from a Zipf vocabulary; the
                  wordcount keys are the words, the paircount keys the
                  nearby-word pairs at distance <= ``pair_dist``.
* ``scalejoin`` — Q3-Q5: two streams, payload attributes uniform in
                  [1, 10000].
* ``nyse``      — Q6: trades with a bursty rate in [0, 8000] t/s, payload
                  [company id, normalized distance from its average].
* ``token_batches`` — the training launcher's LM corpus, numpy batches
                  as the reference yields them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core import tuples as T


def _key_of(words: np.ndarray, k_virt: int) -> np.ndarray:
    return (words * 2654435761 % 2**31 % k_virt).astype(np.int32)


def _pair_key(w1, w2, k_virt):
    return ((w1 * 1000003 + w2) * 2654435761 % 2**31 % k_virt).astype(np.int32)


def tweets(rng: np.random.Generator, *, n_ticks: int, tick: int,
           words_per_tweet: int, vocab: int, k_virt: int,
           mode: str = "wordcount", pair_dist: int = 3,
           rate_per_tick: int = 100, n_sources: int = 1,
           device=None) -> Iterator[T.TupleBatch]:
    """mode: wordcount | paircount.  Keys are materialized into the key set
    (f_MK output); payload[0] = tweet length."""
    tau = 0
    if mode == "wordcount":
        kmax = words_per_tweet
    else:
        d = min(pair_dist, words_per_tweet - 1)
        kmax = sum(min(d, words_per_tweet - 1 - i)
                   for i in range(words_per_tweet))
    for _ in range(n_ticks):
        taus = np.sort(tau + rng.integers(0, rate_per_tick, tick)
                       ).astype(np.int32)
        tau = int(taus.max()) + 1
        words = rng.zipf(1.3, (tick, words_per_tweet)).astype(np.int64) % vocab
        keys = np.full((tick, kmax), -1, np.int32)
        if mode == "wordcount":
            keys[:, :words_per_tweet] = _key_of(words, k_virt)
        else:
            col = 0
            for i in range(words_per_tweet):
                for j in range(i + 1, min(i + 1 + pair_dist,
                                          words_per_tweet)):
                    keys[:, col] = _pair_key(words[:, i], words[:, j], k_virt)
                    col += 1
        payload = np.full((tick, 1), float(words_per_tweet), np.float32)
        source = (rng.integers(0, n_sources, tick).astype(np.int32)
                  if n_sources > 1 else None)
        yield T.make_batch(taus, payload, keys=keys, source=source, kmax=kmax,
                           device=device)


def scalejoin(rng: np.random.Generator, *, n_ticks: int, tick: int,
              k_virt: int, rate_t_per_s: float = 2000.0,
              payload_width: int = 4, device=None) -> Iterator[T.TupleBatch]:
    """Two timestamp-sorted streams (L/R) with the [13] benchmark payloads;
    f_MK = all virtual keys (Operator 3)."""
    tau = 0
    dt = max(int(1000 * tick / rate_t_per_s), 1)  # ms covered per tick
    keys = np.tile(np.arange(k_virt, dtype=np.int32), (tick, 1))
    for _ in range(n_ticks):
        taus = np.sort(tau + rng.integers(0, dt, tick)).astype(np.int32)
        tau = int(taus.max()) + 1
        src = rng.integers(0, 2, tick).astype(np.int32)
        payload = rng.uniform(1, 10000, (tick, payload_width)
                              ).astype(np.float32)
        yield T.make_batch(taus, payload, keys=keys, source=src, kmax=k_virt,
                           device=device)


def nyse(rng: np.random.Generator, *, n_ticks: int, tick: int,
         n_companies: int = 10, k_virt: int = 64,
         device=None) -> Iterator[T.TupleBatch]:
    """Q6-style trades: bursty rate, payload [id, ND] (normalized distance
    precomputed at ingress, cf. §8.6); self-join feeds both streams."""
    tau = 0
    avg = rng.uniform(50, 500, n_companies)
    keys = np.tile(np.arange(k_virt, dtype=np.int32), (tick, 1))
    for _ in range(n_ticks):
        rate = max(float(rng.uniform(0, 8000) *
                         (1 + 3 * (rng.random() < 0.05))), 100.0)
        dt = max(int(1000 * tick / rate), 1)
        taus = np.sort(tau + rng.integers(0, dt, tick)).astype(np.int32)
        tau = int(taus.max()) + 1
        ids = rng.integers(0, n_companies, tick)
        price = avg[ids] * rng.normal(1.0, 0.02, tick)
        nd = (price - avg[ids]) / avg[ids]
        payload = np.stack([ids.astype(np.float32),
                            nd.astype(np.float32)], axis=1)
        src = rng.integers(0, 2, tick).astype(np.int32)
        yield T.make_batch(taus, payload, keys=keys, source=src, kmax=k_virt,
                           device=device)


def token_batches(rng: np.random.Generator, *, vocab: int, batch: int,
                  seq: int, n_batches: int):
    """Synthetic LM corpus: Zipf unigrams with local bigram structure."""
    for _ in range(n_batches):
        x = rng.zipf(1.2, (batch, seq + 1)).astype(np.int64) % vocab
        x = np.maximum(x, 1)
        yield {
            "inputs": x[:, :-1].astype(np.int32),
            "labels": x[:, 1:].astype(np.int32),
            "mask": np.ones((batch, seq), np.float32),
        }
