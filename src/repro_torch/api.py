"""The runtime-config API: one dataclass, one facade.

Held against ``src/repro/api.py``.  ``RuntimeConfig`` is the single
declarative description of a run (operator + windows, parallelism, ingest
tier, runtime knobs, serving tier, observability) and ``build_runtime``
is the one constructor:

    cfg = RuntimeConfig(n_sources=4, ingest_hosts=2)
    rt = build_runtime(cfg, source)
    report = rt.run()

The config is JSON-serializable.  ``device`` says where the pipeline and
the ingest tier run (None: the card); the serving engine runs there too
unless ``ServingConfig.device`` names another device.  ``super_batch > 1``
runs the pipeline's persistent K-tick driver (a CUDA graph per
super-batch shape on the card, which refuses a tick function that cannot
be captured).  Not ported yet, and refused by ``build_runtime``:
checkpointing (``checkpoint_dir``; with it ``resume_runtime``) and the
device mesh (``mesh_devices``).  The reference's ``backend`` switch has
no counterpart: the port picks a kernel by the data's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import obs as _obs
from repro_torch.core.async_runtime import AsyncStreamRuntime, RunReport
from repro_torch.core.windows import WindowSpec
from repro_torch.obs import ObsConfig


@dataclasses.dataclass
class RuntimeConfig:
    """Declarative description of one streaming run.  JSON-serializable
    (``to_json``/``from_json``)."""
    # -- operator ----------------------------------------------------------
    op: str = "count"              # registry key: count | longest
    wa: int = 500                  # window advance
    ws: int = 1000                 # window size
    wt: str = "multi"              # window type
    k_virt: int = 256
    out_cap: int = 1024
    extra_slots: int = 2
    # -- parallelism -------------------------------------------------------
    n_max: int = 16
    n_active: int = 2
    stash_cap: int = 256
    mesh_devices: int = 0          # 0 = single-device VSNPipeline
    device: Optional[str] = None   # None = the card
    # -- sources / ingest tier --------------------------------------------
    n_sources: int = 1
    ingest_hosts: int = 0          # 0 = no tier (source feeds the runtime)
    ingest_worker: str = "thread"  # thread | process | inline
    leaf_cap: int = 128
    root_cap: int = 256
    chan_cap: int = 4
    max_leaves: int = 0            # 0 = IngestTier's default headroom
    out_pad: int = 32
    root_device: Optional[bool] = None   # None: fused on the card
    # -- runtime -----------------------------------------------------------
    queue_cap: int = 4
    super_batch: int = 1
    controller: str = "none"       # none | threshold | predictive | slo
    capacity_per_instance: float = 4000.0
    # -- serving tier ------------------------------------------------------
    # non-None switches the pipeline to the elastic LLM serving tier: the
    # operator is continuous-batching decode, sigma is the KV slot pool,
    # and scale-up/down is the f_mu rewrite.  Pairs with controller="slo".
    serving: Optional[Any] = None  # ServingConfig | dict
    slo_target_p99_ms: float = 50.0
    # -- fault tolerance (not ported yet) ----------------------------------
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # -- observability -----------------------------------------------------
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    def __post_init__(self):
        # JSON round-trips hand obs and serving back as plain dicts
        if isinstance(self.obs, dict):
            self.obs = ObsConfig.from_dict(self.obs)
        if isinstance(self.serving, dict):
            from repro_torch.serving import ServingConfig
            self.serving = ServingConfig.from_dict(self.serving)

    @property
    def effective_max_leaves(self) -> int:
        """What ``IngestTier`` actually allocates for the leaf axis."""
        n = self.ingest_hosts
        return self.max_leaves or max(2 * n, n + 4)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "RuntimeConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# ---------------------------------------------------------------- pieces --

def make_op(cfg: RuntimeConfig):
    from repro_torch.core import aggregate
    window = WindowSpec(wa=cfg.wa, ws=cfg.ws, wt=cfg.wt)
    kw = dict(k_virt=cfg.k_virt, out_cap=cfg.out_cap,
              extra_slots=cfg.extra_slots, n_inputs=max(cfg.n_sources, 1))
    if cfg.op == "count":
        return aggregate.count_aggregate(window, **kw)
    if cfg.op == "longest":
        return aggregate.longest_aggregate(window, **kw)
    raise ValueError(f"unknown operator {cfg.op!r}")


def make_pipeline(cfg: RuntimeConfig):
    if cfg.serving is not None:
        from repro_torch.serving import build_serving_pipeline
        return build_serving_pipeline(cfg.serving,
                                      n_inputs=max(cfg.n_sources, 1),
                                      n_active=cfg.n_active,
                                      device=cfg.device)
    if cfg.mesh_devices:
        raise NotImplementedError(
            "mesh_devices: MeshPipeline is not ported yet (ROADMAP.md "
            "queue 1 item 8)")
    from repro_torch.core.runtime import VSNPipeline
    return VSNPipeline(make_op(cfg), n_max=cfg.n_max, n_active=cfg.n_active,
                       stash_cap=cfg.stash_cap, device=cfg.device)


def make_controller(cfg: RuntimeConfig):
    from repro_torch.core.controller import (PredictiveController,
                                             ThresholdController)
    if cfg.controller == "none":
        return None
    if cfg.controller == "slo":
        from repro_torch.serving import SloServingController
        if cfg.serving is None:
            raise ValueError('controller="slo" requires a serving config')
        # the serving pipeline's k_virt is the slot count, its replica
        # ceiling is the serving tier's instance count
        return SloServingController(
            n_max=cfg.serving.n_instances, k_virt=cfg.serving.n_slots,
            target_p99_ms=cfg.slo_target_p99_ms, n_active=cfg.n_active)
    if cfg.controller == "threshold":
        return ThresholdController(
            n_max=cfg.n_max, k_virt=cfg.k_virt,
            capacity_per_instance=cfg.capacity_per_instance,
            n_active=cfg.n_active)
    if cfg.controller == "predictive":
        return PredictiveController(
            n_max=cfg.n_max, k_virt=cfg.k_virt,
            comparisons_per_s_per_instance=3e7, ws_seconds=1.0,
            n_active=cfg.n_active)
    raise ValueError(f"unknown controller {cfg.controller!r}")


def make_tier(cfg: RuntimeConfig, source, *, record: bool = False):
    from repro_torch.ingest import IngestTier
    return IngestTier(
        source, cfg.n_sources, cfg.ingest_hosts, worker=cfg.ingest_worker,
        leaf_cap=cfg.leaf_cap, root_cap=cfg.root_cap,
        chan_cap=cfg.chan_cap, max_leaves=cfg.effective_max_leaves,
        record=record, schedule=getattr(source, "schedule", None),
        out_pad=cfg.out_pad, root_device=cfg.root_device, device=cfg.device)


# ---------------------------------------------------------------- facade --

@dataclasses.dataclass
class Runtime:
    """The assembled stack: everything ``build_runtime`` constructed, with
    the run entry point.  ``tier`` is None without an ingest tier."""
    config: RuntimeConfig
    pipeline: Any
    runtime: AsyncStreamRuntime
    tier: Any = None

    @property
    def sink(self):
        return self.runtime.sink

    def run(self, max_ticks: Optional[int] = None) -> RunReport:
        report = self.runtime.run(max_ticks=max_ticks)
        o = _obs.get()
        if o is not None and self.config.obs.export_dir:
            o.export(self.config.obs.export_dir)
        return report


def build_runtime(cfg: RuntimeConfig, source, *, pipeline=None, sink=None,
                  controller=None, metrics=None,
                  record_tier: bool = False) -> Runtime:
    """Construct IngestTier -> AsyncStreamRuntime -> pipeline from one
    config."""
    if cfg.checkpoint_dir or cfg.checkpoint_every:
        raise NotImplementedError(
            "checkpoint_dir/checkpoint_every: checkpointing (and "
            "resume_runtime) is not ported yet (ROADMAP.md queue 1 item 4)")
    # observability first: the layers built below record into the global
    # Obs from their constructors onward.  Only install when the config
    # asks for it — callers that installed an Obs themselves keep theirs.
    if cfg.obs.enabled:
        o = _obs.install(cfg.obs)
        if cfg.obs.serve_port is not None:
            o.start_server()
    if pipeline is None:
        pipeline = make_pipeline(cfg)
    tier = None
    src = source
    if cfg.ingest_hosts:
        tier = make_tier(cfg, source, record=record_tier)
        src = tier
    if controller is None:
        controller = make_controller(cfg)
    rt = AsyncStreamRuntime(
        pipeline, src, sink=sink, controller=controller,
        queue_cap=cfg.queue_cap, metrics=metrics,
        super_batch=cfg.super_batch)
    return Runtime(config=cfg, pipeline=pipeline, runtime=rt, tier=tier)
