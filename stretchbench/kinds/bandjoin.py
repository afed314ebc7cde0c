"""Q3 ScaleJoin: a band join of two streams over a single window (paper
§8.3; Gulisano et al., ScaleJoin, IEEE Trans. Big Data 2016), built as
``chip_smoke.py`` ``q3_persistent`` builds it: the port's
``join.scalejoin_def`` and its fast tick ``join.tick_fast`` with
``join.band_predicate`` in a ``VSNPipeline`` with the fast-state merge.

The window is full when the run starts: set-up draws the tuples of one
window (``ws_ms`` of event time) from the seed ahead of the stream and
installs them as the pipeline's state (``import_state_np``), each stored
round-robin under one key as the operator stores it (tuple ``c`` under key
``c % K``, at ring position ``c // K``), with both sources' frontiers at
the window's last event time.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

from stretchbench import roofline, streams
from stretchbench.reference.bandjoin import BandJoin, pair_key


def make_stream(cfg: dict, traffic: dict, seed: int) -> streams.Stream:
    rng = np.random.default_rng(seed)
    dt = streams.tick_ms(cfg["tick"], cfg["rate_t_per_s"])
    n_pre = math.ceil(cfg["ws_ms"] / dt)
    kw = dict(tick=cfg["tick"], rate_t_per_s=cfg["rate_t_per_s"],
              payload_width=cfg["payload_width"], rows=cfg["rows"])
    pre = streams.scalejoin_ticks(rng, n_ticks=n_pre, **kw)
    last = int(pre[-1]["tau"].max())
    pool = streams.scalejoin_ticks(rng, n_ticks=int(traffic["pool_ticks"]),
                                   tau0=last + 1, **kw)
    prefill = {f: np.concatenate([t[f] for t in pre])
               for f in ("tau", "src", "payload", "keys")}
    live = n_pre * cfg["tick"] + 2 * cfg["tick"]
    if cfg["k_virt"] * cfg["ring"] < live:
        raise ValueError(f"k_virt x ring = {cfg['k_virt'] * cfg['ring']} "
                         f"slots cannot hold a window of up to {live} "
                         "tuples: the ring would overwrite live tuples")
    return streams.Stream(pool=streams.Pool(pool), n_sources=2,
                          frontier0=[last, last], prefill=prefill)


def _window(cfg):
    from repro_torch.core.windows import WindowSpec
    return WindowSpec(wa=cfg["wa_ms"], ws=cfg["ws_ms"], wt="single")


def make_pipeline(cfg: dict, stream: streams.Stream, device, wrap=None):
    from repro_torch.core import join
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state

    k, ring, p = cfg["k_virt"], cfg["ring"], cfg["payload_width"]
    ws = _window(cfg)
    fj = join.band_predicate(float(cfg["band"]), cfg["n_attrs"])
    op = join.scalejoin_def(ws, k, fj, payload_width=p, ring=ring,
                            out_cap=cfg["out_cap"])

    def join_tick(op_, st, ready, resp, explicit_w=None):
        return join.tick_fast(ws, fj, st, ready, resp,
                              out_cap=cfg["out_cap"])

    pipe = VSNPipeline(op, n_max=cfg["n_max"], n_active=cfg["n_active"],
                       stash_cap=cfg["stash_cap"],
                       tick_fn=join_tick if wrap is None else wrap(join_tick),
                       merge_fn=merge_fast_state,
                       init_sigma=lambda d: join.fast_join_init(k, ring, p, d),
                       device=device)
    pipe.ensure_gate_for(1, p)
    state = pipe.export_state_np()
    sigma = {f: np.array(v) for f, v in state["sigma"].items()}
    pre = stream.prefill
    c = np.arange(len(pre["tau"]))
    key, pos = c % k, c // k
    sigma["tau"][key, pos] = pre["tau"]
    sigma["pay"][key, pos] = pre["payload"]
    sigma["stream"][key, pos] = pre["src"]
    sigma["n"] = np.bincount(key, minlength=k).astype(np.int32)
    sigma["c"] = np.array(len(c), np.int32)
    state["sigma"] = sigma
    state["sg"]["wmark"]["frontier"] = np.asarray(stream.frontier0, np.int32)
    pipe.import_state_np(state)
    return pipe


def canon(tau: int, payload: np.ndarray):
    """An output lane as an unordered pair of payloads, with its tau."""
    h = payload.shape[0] // 2
    return pair_key(tau, payload[:h], payload[h:])


class Ref:
    def __init__(self, cfg: dict, stream: streams.Stream, n_ticks: int):
        self.cfg = cfg
        a = stream.arrays(n_ticks)
        self.rel = np.full(len(a["tau"]), np.iinfo(np.int64).max, np.int64)
        self.rel[:stream.base] = -1
        self.a = a

    def on_tick(self, i: int, ids, taus, switch=None) -> None:
        self.rel[ids] = i

    def finish(self) -> None:
        c = self.cfg
        self.join = BandJoin(self.a["tau"], self.a["src"], self.a["payload"],
                             self.rel, ws=c["ws_ms"], wa=c["wa_ms"],
                             band=float(c["band"]), n_attrs=c["n_attrs"])

    def expected(self, i: int, control: bool = False) -> Counter:
        return self.join.expected(i, "bfloat16" if control else "float32")


def least_s(cfg: dict, ref: Ref, ticks) -> dict:
    """Per merge call, and the join's work over ``ticks``."""
    join_s = 0.0
    for t in ticks:
        comps, live = ref.join.comparisons(t), ref.join.live(t)
        outs = sum(ref.expected(t).values())
        join_s += roofline.join_tick(comps, live, cfg["tick"], outs,
                                     cfg["n_attrs"], cfg["payload_width"])
    return dict(merge_call=roofline.merge_call(cfg["stash_cap"]
                                               + cfg["tick"] + 2),
                join=join_s)
