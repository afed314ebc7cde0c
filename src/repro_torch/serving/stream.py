"""The serving tier as a stream: requests are tuples, decode is the tick.

Held against ``src/repro/serving/stream.py``:

* ``RequestSource`` — a multi-tenant arrival process (Poisson draws against
  a ``RateSchedule``) that encodes each request as a stream tuple: ``tau``
  = arrival time (ms), payload = ``[uid, max_new, prompt_len, prompt...]``.
  Every tick also carries one heartbeat lane per source (``uid = -1``) so
  the per-source watermark frontier keeps advancing through the ingest
  tier even when a tenant is idle.  The tuples are host tensors: requests
  are parsed on the host, so they never make a round trip to the card.
* ``ServingPipeline`` — the ``AsyncStreamRuntime`` pipeline contract
  (``stage`` / ``step_staged`` / ``epoch``) over a ``ServingEngine``: a
  staged tick's valid lanes are admitted, one continuous-batching decode
  round runs, and an injected ``Reconfiguration`` is applied as the
  paper's ``f_mu`` rewrite (VSN: zero KV moved; ``mode="sn"`` materializes
  the migration baseline).  The epoch switch commits in the same tick.
* ``SloServingController`` — the SLO-aware policy: it reads the windowed
  p99 of the ``span.serve.decode`` registry histogram plus the runtime's
  queue depth from ``LiveMetrics``, and provisions the smallest replica
  count predicted to clear the target; SLO-engine breaches force a
  scale-up even when the raw signals look calm.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from repro_torch import device as _device
from repro_torch import obs as _obs
from repro_torch.core import tuples as T
from repro_torch.core.controller import (Reconfiguration, active_mask,
                                         balanced_fmu)
from repro_torch.io.sources import RateSchedule
from repro_torch.obs.slo import _windowed_quantile
from repro_torch.serving.kv_pool import Request, ServingEngine

META_COLS = 3          # payload layout: [uid, max_new, prompt_len, prompt..]
HEARTBEAT_UID = -1.0   # watermark-advancing lane; never admitted


# ------------------------------------------------------------- requests --

def encode_requests(reqs: List[Request], *, lanes: int, prompt_cap: int,
                    n_inputs: int, k_virt: int, tau: int) -> T.TupleBatch:
    """One tick: ``n_inputs`` heartbeat lanes + up to ``lanes`` requests,
    as a host batch.  Token ids ride in the float payload (exact below
    2**24, checked)."""
    if len(reqs) > lanes:
        raise ValueError(f"{len(reqs)} requests for {lanes} lanes")
    b = n_inputs + lanes
    pay = np.zeros((b, META_COLS + prompt_cap), np.float32)
    pay[:, 0] = HEARTBEAT_UID
    keys = np.zeros((b, 1), np.int32)
    source = np.zeros((b,), np.int32)
    valid = np.zeros((b,), bool)
    source[:n_inputs] = np.arange(n_inputs)
    valid[:n_inputs] = True
    for i, r in enumerate(reqs):
        lane = n_inputs + i
        if not (r.uid < (1 << 24) and len(r.prompt) <= prompt_cap
                and int(np.max(r.prompt, initial=0)) < (1 << 24)):
            raise ValueError(f"request {r.uid} does not fit the payload")
        pay[lane, 0] = r.uid
        pay[lane, 1] = r.max_new
        pay[lane, 2] = len(r.prompt)
        pay[lane, META_COLS:META_COLS + len(r.prompt)] = r.prompt
        keys[lane, 0] = r.uid % k_virt
        source[lane] = r.uid % n_inputs
        valid[lane] = True
    return T.make_batch(np.full((b,), tau, np.int32), pay, keys=keys,
                        source=source, valid=valid, device="cpu")


def decode_request_lanes(b: T.TupleBatch) -> List[Request]:
    """Valid non-heartbeat lanes of a (possibly tier-merged) tick back into
    ``Request``s."""
    ok = (b.valid & ~b.is_control).cpu().numpy()
    pay = b.payload.cpu().numpy()
    tau = b.tau.cpu().numpy()
    out: List[Request] = []
    for lane in np.nonzero(ok)[0]:
        uid = int(round(float(pay[lane, 0])))
        if uid < 0:
            continue                              # heartbeat
        p_len = int(round(float(pay[lane, 2])))
        prompt = np.rint(pay[lane, META_COLS:META_COLS + p_len]).astype(
            np.int32)
        out.append(Request(uid=uid, prompt=prompt,
                           max_new=int(round(float(pay[lane, 1]))),
                           arrived=int(tau[lane])))
    return out


class RequestSource:
    """Deterministic multi-tenant arrival process as a tick stream.

    Per tick, a Poisson draw against ``schedule.rate_at(tick)`` (requests/s
    over a ``tick_ms`` window) decides how many requests arrive; spill past
    the per-tick lane budget carries to the next tick (a spike backs up,
    like a real front door).  After ``ticks`` arrival ticks, ``drain_ticks``
    heartbeat-only ticks keep the watermark moving while in-flight requests
    finish.  Re-iterating restarts the same stream (seeded), which is what
    the async-vs-direct parity checks replay; the draws are numpy's, so the
    stream equals the reference's for the same arguments."""

    def __init__(self, *, schedule: RateSchedule, ticks: int,
                 lanes: int = 8, prompt_len: int = 4, max_new: int = 4,
                 vocab: int = 256, seed: int = 0, n_inputs: int = 1,
                 k_virt: int = 8, tick_ms: int = 50,
                 drain_ticks: int = 32, pace: bool = False):
        self.schedule = schedule
        self.ticks = ticks
        self.lanes = lanes
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.vocab = vocab
        self.seed = seed
        self.n_inputs = n_inputs
        self.k_virt = k_virt
        self.tick_ms = tick_ms
        self.drain_ticks = drain_ticks
        self.pace = pace
        self.total_requests = 0       # after one full iteration

    def rate_hint(self, tick: int) -> Optional[float]:
        return self.schedule.rate_at(tick)

    def __len__(self) -> int:
        return self.ticks + self.drain_ticks

    def __iter__(self) -> Iterator[T.TupleBatch]:
        rng = np.random.default_rng(self.seed)
        uid = 0
        backlog = 0
        next_emit = time.perf_counter()
        for i in range(self.ticks + self.drain_ticks):
            if self.pace:
                now = time.perf_counter()
                if now < next_emit:
                    time.sleep(next_emit - now)
                next_emit = max(now, next_emit) + self.tick_ms / 1e3
            reqs: List[Request] = []
            if i < self.ticks:
                lam = self.schedule.rate_at(i) * self.tick_ms / 1e3
                backlog += int(rng.poisson(lam))
                take = min(backlog, self.lanes)
                backlog -= take
                for _ in range(take):
                    reqs.append(Request(
                        uid=uid,
                        prompt=rng.integers(1, self.vocab, self.prompt_len),
                        max_new=self.max_new, arrived=i * self.tick_ms))
                    uid += 1
            yield encode_requests(reqs, lanes=self.lanes,
                                  prompt_cap=self.prompt_len,
                                  n_inputs=self.n_inputs,
                                  k_virt=self.k_virt, tau=i * self.tick_ms)
        self.total_requests = uid


# ------------------------------------------------------------- pipeline --

@dataclasses.dataclass(frozen=True)
class _ServingOp:
    """The slice of the operator contract the runtime reads."""
    n_inputs: int
    k_virt: int


class ServingPipeline:
    """``AsyncStreamRuntime``-compatible pipeline whose sigma is the KV
    slot pool.  ``epoch`` is the pool itself (``fmu`` + ``active`` are the
    live ownership tables); an injected ``Reconfiguration`` commits within
    the same tick.  ``stage`` keeps the request tuples on the host, where
    admission parses them; ``sg`` is None, so the runtime seeds the
    watermark frontier from zeros."""

    device_inst_load = True      # step returns inst_load; skip the host hist
    sg = None

    def __init__(self, engine: ServingEngine, *, n_inputs: int = 1,
                 mode: str = "vsn"):
        if mode not in ("vsn", "sn"):
            raise ValueError(f"unknown reconfig mode {mode!r}")
        self.engine = engine
        self.device = engine.device
        self.mode = mode
        self.op = _ServingOp(n_inputs, engine.pool.n_slots)
        self.epoch = engine.pool
        self.finished: List[Request] = []
        self.reconfig_events: List[Dict[str, Any]] = []

    def stage(self, b: T.TupleBatch) -> T.TupleBatch:
        return b

    def step_staged(self, staged: T.TupleBatch, reconfig=None,
                    frontier=None):
        eng = self.engine
        for r in decode_request_lanes(staged):
            eng.submit(r)
        switched = False
        if reconfig is not None:
            moved, ms = eng.reconfigure(int(reconfig.n_active),
                                        mode=self.mode)
            self.reconfig_events.append(dict(
                n_active=int(reconfig.n_active), kv_bytes_moved=int(moved),
                ms=ms, epoch=int(reconfig.epoch)))
            switched = True          # the f_mu rewrite commits immediately
        done = eng.tick()
        self.finished.extend(done)
        uids = np.asarray([r.uid for r in done], np.int32)
        toks = np.full((len(done), max((len(r.out) for r in done),
                                       default=0)), -1, np.int32)
        for i, r in enumerate(done):
            toks[i, :len(r.out)] = r.out
        return uids, toks, np.bool_(switched), eng.inst_load()

    def import_state(self, tree):
        raise NotImplementedError(
            "serving tier has no checkpoint/restore support yet")


@dataclasses.dataclass
class ServingConfig:
    """JSON-serializable description of the serving pipeline (rides inside
    ``RuntimeConfig.serving``).  ``device`` is where the engine runs
    (None: the device ``build_serving_pipeline`` is handed, which
    ``RuntimeConfig.device`` decides; both None: the card).  The reference's ``chunk`` (its jnp attention's KV
    chunk) has no counterpart."""
    arch: str = "qwen3-14b"
    reduced: bool = True
    n_slots: int = 8
    max_seq: int = 64
    n_instances: int = 4
    mode: str = "vsn"            # reconfiguration mode: vsn | sn baseline
    seed: int = 0
    device: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServingConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def build_serving_pipeline(scfg: ServingConfig, *, n_inputs: int = 1,
                           n_active: int = 1,
                           device=None) -> ServingPipeline:
    """The engine over ``scfg.arch`` with parameters drawn on the device
    from ``scfg.seed`` (``transformer.init_params``).  The device is
    ``scfg.device``, else ``device``, else the card."""
    from repro_torch.configs import canon, get_config, reduced
    from repro_torch.models import transformer
    mcfg = get_config(canon(scfg.arch))
    if scfg.reduced:
        mcfg = reduced(mcfg)
    dev = _device.resolve(scfg.device if scfg.device is not None else device)
    params = transformer.init_params(mcfg, seed=scfg.seed, device=dev)
    eng = ServingEngine(mcfg, params, n_slots=scfg.n_slots,
                        max_seq=scfg.max_seq, n_instances=scfg.n_instances,
                        device=dev)
    eng.pool.reconfigure_vsn(n_active)
    return ServingPipeline(eng, n_inputs=n_inputs, mode=scfg.mode)


# ----------------------------------------------------------- controller --

@dataclasses.dataclass
class SloServingController:
    """SLO-aware replica policy: windowed p99 decode latency (read straight
    from the ``span.serve.decode`` registry histogram) + in-flight queue
    depth -> replica count, emitted as the paper's f_mu rewrite.

    Scale-up: p99 over target, queue nearly full, or a fresh SLO-engine
    breach.  The provision sizes by the overshoot ratio — smallest count
    predicted to clear the target.  Scale-down: p99 well under target AND
    an empty queue.  ``cooldown`` decisions must pass between changes so
    one spike does not ring."""
    n_max: int
    k_virt: int
    target_p99_ms: float = 50.0
    low_p99_ms: Optional[float] = None
    metric: str = "span.serve.decode"
    window_s: float = 10.0
    min_count: int = 8
    cooldown: int = 4
    n_active: int = 1
    epoch: int = 0
    slo_breaches_seen: int = 0

    def __post_init__(self):
        if self.low_p99_ms is None:
            self.low_p99_ms = self.target_p99_ms / 4.0
        self._win: deque = deque()      # (t, counts, count) sketch baseline
        self._since = self.cooldown     # decisions since the last change
        self._decisions = 0

    # -- signal -------------------------------------------------------------
    def _windowed_p99_s(self) -> Optional[float]:
        """Windowed p99 over the registry sketch's bucket-count deltas, None
        while the metric is absent or under ``min_count`` observations."""
        o = _obs.get()
        h = None if o is None else o.registry.histograms.get(self.metric)
        if h is None or h.count == 0:
            return None
        t = time.time()
        self._win.append((t, list(h.counts), h.count))
        while len(self._win) > 2 and t - self._win[1][0] > self.window_s:
            self._win.popleft()
        base_t, base_counts, base_count = self._win[0]
        n = h.count - base_count
        if len(self._win) == 1 or t - base_t > 4 * self.window_s:
            base_counts = [0] * len(h.counts)
            n = h.count
        if n < self.min_count:
            return None
        deltas = [c - b for c, b in zip(h.counts, base_counts)]
        return _windowed_quantile(deltas, n, 0.99)

    # -- policy -------------------------------------------------------------
    def observe_live(self, m) -> Optional[Reconfiguration]:
        self._decisions += 1
        self._since += 1
        if m.slo_breaches:
            self.slo_breaches_seen += len(m.slo_breaches)
        p99_s = self._windowed_p99_s()
        if p99_s is None:
            # tracing off (no span histogram): the bus's tick latency is
            # the fallback signal, gated by the same warmup count
            if self._decisions < self.min_count:
                return None
            p99_s = m.tick_latency_s
        p99_ms = p99_s * 1e3
        qr = (m.queue_depth / m.queue_cap) if m.queue_cap else 0.0
        desired = self.n_active
        if p99_ms > self.target_p99_ms or qr >= 0.75 or m.slo_breaches:
            over = max(p99_ms / self.target_p99_ms, 1.0)
            desired = min(self.n_max,
                          max(self.n_active + 1,
                              int(np.ceil(self.n_active * (over + qr)))))
        elif p99_ms < self.low_p99_ms and m.queue_depth == 0:
            desired = max(1, self.n_active - 1)
        if desired == self.n_active or self._since < self.cooldown:
            return None
        self._since = 0
        self.n_active = desired
        self.epoch += 1
        _obs.event("controller_decide", policy="slo", p99_ms=p99_ms,
                   queue_depth=m.queue_depth, epoch=int(self.epoch),
                   n_active=int(desired),
                   breaches=len(m.slo_breaches))
        return Reconfiguration(
            epoch=self.epoch, n_active=desired,
            fmu=balanced_fmu(self.k_virt, desired, self.n_max),
            active=active_mask(desired, self.n_max))
