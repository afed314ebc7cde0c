"""Q1 wordcount: a count aggregate over tweets (paper §8.1), built as
``chip_smoke.py`` ``q1_setup`` and ``q1_persistent`` build it: the port's
``aggregate.count_aggregate`` (WA / WS multi windows) on its fast tick
``aggregate.tick_fast("count")`` in a ``VSNPipeline`` with the fast-state
merge."""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np

from stretchbench import roofline, streams
from stretchbench.reference import wordcount


def make_stream(cfg: dict, traffic: dict, seed: int) -> streams.Stream:
    rng = np.random.default_rng(seed)
    ticks = streams.tweet_ticks(
        rng, n_ticks=int(traffic["pool_ticks"]), tick=cfg["tick"],
        words_per_tweet=cfg["words_per_tweet"], vocab=cfg["vocab"],
        k_virt=cfg["k_virt"], rate_per_tick=cfg["rate_per_tick"],
        words=traffic["words"], zipf_a=float(traffic.get("zipf_a", 1.3)))
    return streams.Stream(pool=streams.Pool(ticks), n_sources=1,
                          frontier0=[0])


def make_pipeline(cfg: dict, stream: streams.Stream, device, wrap=None):
    from repro_torch.core import aggregate as agg
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec

    op = agg.count_aggregate(
        WindowSpec(wa=cfg["wa_ms"], ws=cfg["ws_ms"], wt="multi"),
        cfg["k_virt"], out_cap=cfg["out_cap"],
        extra_slots=cfg["extra_slots"])

    def count_tick(op_, st, ready, resp, explicit_w=None):
        return agg.tick_fast(op_, "count", st, ready, resp,
                             explicit_w=explicit_w)

    tick = count_tick if wrap is None else wrap(count_tick)
    return VSNPipeline(op, n_max=cfg["n_max"], n_active=cfg["n_active"],
                       stash_cap=cfg["stash_cap"], tick_fn=tick,
                       merge_fn=merge_fast_state,
                       init_sigma=functools.partial(agg.fast_init, op),
                       device=device)


def canon(tau: int, payload: np.ndarray):
    """An output lane: ``(window end, key, count)``."""
    return (int(tau), float(payload[0]), float(payload[1]))


class Ref:
    def __init__(self, cfg: dict, stream: streams.Stream, n_ticks: int):
        self.cfg, self.stream = cfg, stream
        self.minmax = []
        self.lost = []

    def on_tick(self, i: int, ids, taus, switch=None) -> None:
        self.minmax.append((int(taus.min()), int(taus.max()))
                           if taus.size else None)
        if switch is not None:
            gamma, fmu_old, fmu_new = switch
            self.lost.append((gamma, fmu_old != fmu_new))

    def finish(self) -> None:
        c = self.cfg
        self.closes = wordcount.closing(self.minmax, c["wa_ms"], c["ws_ms"])
        self.tmin = np.array([mm[0] if mm else 0 for mm in self.minmax])
        self.tmax = np.array([mm[1] if mm else -1 for mm in self.minmax])

    def _between(self, a: int, b: int):
        ticks = np.nonzero((self.tmax >= a) & (self.tmin < b))[0]
        parts = [self.stream.tick(int(i)) for i in ticks]
        if not parts:
            return np.zeros((0,), np.int64), np.zeros((0, 1), np.int32)
        return (np.concatenate([p["tau"] for p in parts]).astype(np.int64),
                np.concatenate([p["keys"] for p in parts]))

    def expected(self, i: int, control: bool = False) -> Counter:
        c = self.cfg
        out = wordcount.expected(self.closes[i], c["wa_ms"], c["ws_ms"],
                                 self._between,
                                 lost=tuple(self.lost) if control else ())
        return Counter({(t, float(k), float(n)): m
                        for (t, k, n), m in out.items()})


def least_s(cfg: dict, ref: Ref, ticks) -> dict:
    """Per call: the merge over the stash and one tick, and a
    ``segment_aggregate`` of an instance's hits (its bytes bound it: the
    operation term, a live hit per row at most, is ~1/600 of it)."""
    del ref, ticks
    n_slots = -(-cfg["ws_ms"] // cfg["wa_ms"])
    rows = n_slots * cfg["words_per_tweet"] * cfg["tick"]
    return dict(
        merge_call=roofline.merge_call(cfg["stash_cap"] + cfg["tick"] + 1),
        segment_aggregate_call=roofline.segment_aggregate_call(
            rows, 1, cfg["k_virt"], n_slots + cfg["extra_slots"], rows))
