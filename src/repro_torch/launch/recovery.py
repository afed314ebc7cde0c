"""Kill-and-restore recovery drills: the measured fault-tolerance loop.

Held against ``src/repro/launch/recovery.py``.  One shared harness for
every recovery scenario:

* ``mode="sigkill"``: a *process*-worker ingest leaf is SIGKILLed mid-run
  (unplanned host loss).  The tier's liveness check raises ``LeafFailure``
  promptly (stamped ``t_detected``), the victim run dies, and the drill
  restores from the latest complete checkpoint;
* ``mode="stop"``: the whole runtime "crashes" after N ticks (process exit
  or power loss);
* ``crash_mid_save=True`` additionally plants a torn save (a newer step
  directory with array files but **no manifest**), and the restore must
  fall back to the previous complete step (the atomic-commit contract).

Recovery is *measured*: ``detect_to_recover_ms`` spans from the failure
detection stamp to the first output the restored runtime delivers (stack
rebuild + state restore + replay ramp included).

Correctness contract (exactly-once): with S the restored step,

    sorted(victim.results(before_tick=S) + restored.results())
        == sorted(uninterrupted oracle results)

tuple for tuple.  The pipeline and the tier run on ``cfg.device`` (None:
the card), the oracle and the restored run included.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch import api
from repro_torch import obs as _obs
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.io.sinks import CollectSink
from repro_torch.io.sources import ReplaySource


class StampedSink(CollectSink):
    """CollectSink that stamps the wall-clock of its first accepted output:
    the "recovered" end of the detection→recovered interval."""

    def __init__(self):
        super().__init__()
        self.t_first: Optional[float] = None

    def accept(self, tick_id, outs_pre, outs_post) -> None:
        if self.t_first is None:
            self.t_first = time.perf_counter()
        super().accept(tick_id, outs_pre, outs_post)


@dataclasses.dataclass
class RecoveryReport:
    mode: str
    restored_step: int
    detect_to_recover_ms: float
    parity: bool
    n_committed: int
    n_replayed: int
    n_oracle: int

    def summary(self) -> str:
        return (f"{self.mode}: restored step {self.restored_step}, "
                f"detection->recovered {self.detect_to_recover_ms:.1f} ms, "
                f"parity={self.parity} ({self.n_committed} committed + "
                f"{self.n_replayed} replayed == {self.n_oracle} oracle)")


def oracle_results(cfg: api.RuntimeConfig, batches) -> List:
    """The uninterrupted run's output multiset (checkpointing off: the
    contract is that snapshots never perturb outputs, and the drills prove
    it by comparing a checkpointing victim against this)."""
    ocfg = dataclasses.replace(cfg, checkpoint_dir=None, checkpoint_every=0)
    full = api.build_runtime(
        ocfg, ReplaySource(batches, n_inputs=max(cfg.n_sources, 1)))
    full.run()
    return full.sink.results()


def _kill_leaf_when(tier, after_rounds: int) -> None:
    """Watchdog: SIGKILL the highest-id live ingest leaf once the tier has
    merged ``after_rounds`` rounds (so at least one checkpoint boundary has
    passed and the kill lands mid-stream, under real backpressure)."""
    while not (tier._handles and tier._rounds_emitted >= after_rounds):
        time.sleep(0.005)
    for lid in sorted(tier._handles, reverse=True):
        h = tier._handles[lid]
        if h.proc is not None and h.proc.pid is not None:
            os.kill(h.proc.pid, signal.SIGKILL)
            return
    raise AssertionError("sigkill drill: no process-worker leaf to kill")


def kill_restore_drill(cfg: api.RuntimeConfig, batches, *,
                       mode: str = "stop", crash_after: int = 6,
                       crash_mid_save: bool = False,
                       oracle: Optional[List] = None) -> RecoveryReport:
    """Run the victim, fail it, restore from the latest complete manifest,
    and check the exactly-once contract against the uninterrupted oracle.
    ``crash_after``: ticks survived before the stop (``mode="stop"``) or
    tier rounds merged before the SIGKILL (``mode="sigkill"``); keep it
    past ``cfg.checkpoint_every`` or there is nothing to restore."""
    if mode not in ("stop", "sigkill"):
        raise ValueError(f"unknown drill mode {mode!r}")
    if not (cfg.checkpoint_dir and cfg.checkpoint_every):
        raise ValueError("the drill needs checkpoint_dir and "
                         "checkpoint_every")
    n_inputs = max(cfg.n_sources, 1)
    if oracle is None:
        oracle = oracle_results(cfg, batches)

    victim = api.build_runtime(cfg, ReplaySource(batches,
                                                 n_inputs=n_inputs))
    if mode == "sigkill":
        if not (cfg.ingest_hosts and cfg.ingest_worker == "process"):
            raise ValueError("sigkill mode needs process-worker ingest "
                             "leaves")
        from repro_torch.ingest import LeafFailure
        wd = threading.Thread(target=_kill_leaf_when,
                              args=(victim.tier, crash_after),
                              daemon=True)
        wd.start()
        try:
            victim.run()
            raise AssertionError("sigkill drill: victim survived the kill")
        except LeafFailure as e:
            t_detected = e.t_detected
    else:
        victim.run(max_ticks=crash_after)
        t_detected = time.perf_counter()      # the "crash" instant
    _obs.event("recovery_detected", mode=mode, crash_after=crash_after)
    victim.checkpointer.wait()

    if crash_mid_save:
        # a save torn mid-write: array files on disk, no manifest; it must
        # be invisible to latest_step (the atomic os.replace commit point)
        latest = Checkpointer(cfg.checkpoint_dir).latest_step()
        assert latest is not None, "victim died before any checkpoint"
        torn = os.path.join(cfg.checkpoint_dir,
                            f"step_{latest + cfg.checkpoint_every:08d}")
        os.makedirs(torn, exist_ok=True)
        np.save(os.path.join(torn, "leaf_00000.npy"), np.zeros(3))

    sink = StampedSink()
    restored = api.resume_runtime(
        cfg.checkpoint_dir, ReplaySource(batches, n_inputs=n_inputs),
        sink=sink)
    restored.run()
    S = restored.restored_step
    committed = victim.sink.results(before_tick=S)
    replayed = sink.results()
    parity = sorted(committed + replayed) == sorted(oracle)
    ms = (float("nan") if sink.t_first is None
          else (sink.t_first - t_detected) * 1e3)
    _obs.event("recovery_restored", mode=mode, restored_step=S,
               detect_to_recover_ms=ms, parity=parity)
    if ms == ms:                             # NaN-safe: only real latencies
        _obs.observe("recovery.detect_to_recover_s", ms / 1e3)
    return RecoveryReport(mode=mode, restored_step=S,
                          detect_to_recover_ms=ms, parity=parity,
                          n_committed=len(committed),
                          n_replayed=len(replayed), n_oracle=len(oracle))
