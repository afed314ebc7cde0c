"""The runtime-config API: one dataclass, one facade, one resume.

Held against ``src/repro/api.py``.  ``RuntimeConfig`` is the single
declarative description of a run (operator + windows, parallelism, ingest
tier, runtime knobs, serving tier, fault tolerance, observability) and
``build_runtime`` is the one constructor:

    cfg = RuntimeConfig(n_sources=4, ingest_hosts=2,
                        checkpoint_dir="/tmp/ck", checkpoint_every=8)
    rt = build_runtime(cfg, source)
    report = rt.run()

The config is JSON-serializable and rides inside every checkpoint
manifest, which is what makes restore *closed*: ``resume_runtime`` reads
the manifest, rebuilds the identical stack from the embedded config,
restores pipeline + ingest-tier state from the latest complete step, and
replays the source from the snapshot's frontier: exactly-once when the
victim's outputs below the restored step are treated as committed
(``CollectSink.results(before_tick=step)``).  The manifest format is the
reference's, so a directory either package wrote resumes in the other.

``device`` says where the pipeline and the ingest tier run (None: the
card); the serving engine runs there too unless ``ServingConfig.device``
names another device.  ``super_batch > 1`` runs the pipeline's persistent
K-tick driver (a CUDA graph per super-batch shape on the card, which
refuses a tick function that cannot be captured).  ``mesh_devices = N``
builds a ``MeshPipeline`` over ``launch.mesh.make_stream_mesh(N,
device)``: N key-block shards round-robin over the visible devices of
``device``'s type, driven by this one process (all N on the one card
there is).  The reference's ``backend`` switch has no counterpart: the
port picks a kernel by the data's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch import obs as _obs
from repro_torch.checkpoint import stream as ckstream
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.core.async_runtime import AsyncStreamRuntime, RunReport
from repro_torch.core.windows import WindowSpec
from repro_torch.io.sources import ReplaySource, load_stream
from repro_torch.obs import ObsConfig


@dataclasses.dataclass
class RuntimeConfig:
    """Declarative description of one streaming run.  JSON-serializable
    (``to_json``/``from_json``) so a checkpoint manifest can carry it and
    ``resume_runtime`` can rebuild an identical stack."""
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
    # -- fault tolerance ---------------------------------------------------
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0      # pipeline ticks between snapshots
    # -- observability -----------------------------------------------------
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)

    def __post_init__(self):
        if (self.checkpoint_every and self.super_batch > 1
                and self.checkpoint_every % self.super_batch):
            # the reference's assert, kept under python -O
            raise AssertionError(
                "checkpoint_every must be a multiple of super_batch: "
                "boundaries inside a super-batch group are never cut")
        # JSON round-trips hand obs and serving back as plain dicts
        if isinstance(self.obs, dict):
            self.obs = ObsConfig.from_dict(self.obs)
        if isinstance(self.serving, dict):
            from repro_torch.serving import ServingConfig
            self.serving = ServingConfig.from_dict(self.serving)

    @property
    def effective_max_leaves(self) -> int:
        """What ``IngestTier`` actually allocates for the leaf axis: the
        restore templates need the real array shapes."""
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
    from repro_torch.core.runtime import MeshPipeline, VSNPipeline
    op = make_op(cfg)
    if cfg.mesh_devices:
        from repro_torch.launch.mesh import make_stream_mesh
        mode = "fast-agg" if cfg.op == "count" else "general"
        return MeshPipeline(op, make_stream_mesh(cfg.mesh_devices,
                                                 cfg.device),
                            stash_cap=cfg.stash_cap, mode=mode,
                            agg_kind="count", n_max=cfg.n_max,
                            n_active=cfg.n_active)
    return VSNPipeline(op, n_max=cfg.n_max, n_active=cfg.n_active,
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


def make_tier(cfg: RuntimeConfig, source, *, record: bool = False,
              restore: Optional[Dict] = None):
    from repro_torch.ingest import IngestTier
    return IngestTier(
        source, cfg.n_sources, cfg.ingest_hosts, worker=cfg.ingest_worker,
        leaf_cap=cfg.leaf_cap, root_cap=cfg.root_cap,
        chan_cap=cfg.chan_cap, max_leaves=cfg.effective_max_leaves,
        record=record, schedule=getattr(source, "schedule", None),
        out_pad=cfg.out_pad, root_device=cfg.root_device, device=cfg.device,
        snapshot_every=cfg.checkpoint_every, restore=restore)


# ---------------------------------------------------------------- facade --

@dataclasses.dataclass
class Runtime:
    """The assembled stack: everything ``build_runtime`` constructed, with
    the run entry point.  ``tier`` is None without an ingest tier;
    ``checkpointer`` is None without fault tolerance configured."""
    config: RuntimeConfig
    pipeline: Any
    runtime: AsyncStreamRuntime
    tier: Any = None
    checkpointer: Optional[ckstream.StreamCheckpointer] = None
    restored_step: Optional[int] = None   # set by resume_runtime

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
                  restore: Optional[Dict] = None,
                  record_tier: bool = False) -> Runtime:
    """Construct IngestTier -> AsyncStreamRuntime -> pipeline from one
    config.  ``restore`` (from ``resume_runtime``) installs snapshot state
    into every layer *before* the runtime is built: the runtime seeds its
    epoch shadows and host frontier from the pipeline at construction."""
    if cfg.serving is not None and cfg.checkpoint_dir:
        raise ValueError(
            "serving tier has no checkpoint/restore support yet")
    # observability first: the layers built below record into the global
    # Obs from their constructors onward.  Only install when the config
    # asks for it — callers that installed an Obs themselves keep theirs.
    if cfg.obs.enabled:
        o = _obs.install(cfg.obs)
        if cfg.obs.serve_port is not None:
            o.start_server()
    if pipeline is None:
        pipeline = make_pipeline(cfg)
    if restore is not None:
        pipeline.import_state_np(restore["pipe"])
    tier = None
    src = source
    if cfg.ingest_hosts:
        tier = make_tier(cfg, source, record=record_tier,
                         restore=(restore or {}).get("tier"))
        src = tier
    if controller is None:
        controller = make_controller(cfg)
    sck = None
    if cfg.checkpoint_dir and cfg.checkpoint_every:
        sck = ckstream.StreamCheckpointer(
            Checkpointer(cfg.checkpoint_dir), cfg.checkpoint_every,
            pipeline, tier=tier, config=cfg)
    rt = AsyncStreamRuntime(
        pipeline, src, sink=sink, controller=controller,
        queue_cap=cfg.queue_cap, metrics=metrics,
        super_batch=cfg.super_batch, checkpointer=sck,
        tick0=(restore or {}).get("tick0", 0))
    return Runtime(config=cfg, pipeline=pipeline, runtime=rt, tier=tier,
                   checkpointer=sck)


def resume_runtime(checkpoint_dir: str, batches, *, sink=None,
                   controller=None, metrics=None, step: Optional[int] = None,
                   device=None) -> Runtime:
    """Rebuild and restore the stack from the latest complete checkpoint
    under ``checkpoint_dir`` (or an explicit ``step``).

    ``batches`` is the replay log, the full original stream (a
    ``ReplaySource``, a list of ticks, or a ``.npz`` path recorded by
    ``io.sources.save_stream``); the suffix at or past the snapshot's
    source frontier is replayed, everything before it is already in the
    snapshot.  A crash mid-save left no manifest, so ``latest_step`` lands
    on the previous complete step automatically.  ``device`` overrides
    the manifest config's device (a manifest the reference wrote names
    none, which means the card).
    """
    ck = Checkpointer(checkpoint_dir)
    if step is None:
        step = ck.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"no complete checkpoint under {checkpoint_dir}")
    extra = ck.manifest(step)["extra"]
    cfg = RuntimeConfig.from_json(extra["config"])
    if device is not None:
        cfg = dataclasses.replace(cfg, device=str(device))
    pipeline = make_pipeline(cfg)
    like = ckstream.like_tree(
        pipeline, extra, n_sources=cfg.n_sources, leaf_cap=cfg.leaf_cap,
        root_cap=cfg.root_cap, max_leaves=cfg.effective_max_leaves,
        out_pad=cfg.out_pad, root_device=cfg.root_device)
    tree = ck.restore(step, like)
    restore: Dict[str, Any] = {"pipe": tree["pipe"], "tick0": int(step)}
    if extra.get("tier") is not None:
        restore["tier"] = ckstream.tier_restore_dict(tree, extra["tier"])
    source_ticks = int(extra["source_ticks"])
    if isinstance(batches, str):
        src = load_stream(batches, from_tick=source_ticks, device=cfg.device)
    elif isinstance(batches, ReplaySource):
        src = batches.from_tick(source_ticks)
    else:
        src = ReplaySource(list(batches),
                           n_inputs=max(cfg.n_sources, 1)).from_tick(
                               source_ticks)
    rt = build_runtime(cfg, src, pipeline=pipeline, sink=sink,
                       controller=controller, metrics=metrics,
                       restore=restore)
    rt.restored_step = int(step)
    return rt
