"""Meshes and their copy accounting.

Held against ``src/repro/launch/mesh.py`` (``make_stream_mesh``,
``make_host_mesh``, ``make_production_mesh``, ``collective_bytes``,
``host_transfer_ops``).  The reference builds ``jax`` meshes and reads its
witnesses out of compiled HLO.  Here the stream mesh and the host model
mesh are devices in one controller process, one a shard
(``core.runtime.MeshPipeline`` and the ``vsn`` MoE drive them); shards may
share a device, as the reference's CI shares one CPU among devices forced
by ``XLA_FLAGS``.  On one card every shard is on ``cuda:0``: that run
shows the partitioning and the zero-byte switch, not a speed-up.  The
production mesh is a placeholder, as the reference's 256 or 512 forced
host devices are: a ``DeviceMesh`` over a fake process group that only
the dry-run traces against, on the meta device.

``collective_bytes`` sums the bytes that the copies recorded during a
step (``record_copies``: every aten copy whose source and destination
are different devices of the mesh) moved between shards' devices: the
zero-state-transfer witness of Theorem 3.  ``host_transfer_ops`` counts
the memory copies touching host memory in a pipeline's captured CUDA
graphs (``core.runtime.graph_nodes``): the device-residency witness of
the persistent K-tick driver.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """``devices[j]`` holds shard j's key block.  ``groups`` are the
    distinct physical devices in order of first use, each with its shards:
    the replicated state (ScaleGate, epoch tables) lives once a group."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        kinds = {d.type for d in self.devices}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's shards share one device type, not "
                             f"{sorted(kinds)}")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device: where outputs are gathered."""
        return self.devices[0]

    @property
    def groups(self) -> List[Tuple[torch.device, Tuple[int, ...]]]:
        order: Dict[torch.device, List[int]] = {}
        for j, d in enumerate(self.devices):
            order.setdefault(d, []).append(j)
        return [(d, tuple(js)) for d, js in order.items()]

    def replicate(self, tree) -> list:
        """``tree`` on each group's device (the tensors already there are
        not copied): what the reference's replicated in_spec places."""
        return [tree_map(lambda a: a.to(d, non_blocking=True)
                         if isinstance(a, torch.Tensor) else a, tree)
                for d, _ in self.groups]


def make_stream_mesh(n_shards: Optional[int] = None,
                     device=None) -> StreamMesh:
    """``n_shards`` shards placed round-robin over the visible devices of
    ``device``'s type (None: the card): the CUDA devices from
    ``device``'s index on, or the one CPU.  ``n_shards`` defaults to
    the number of those devices."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        start = dev.index or 0
        visible = [torch.device("cuda", (start + i) % count)
                   for i in range(count)]
    else:
        visible = [dev]
    n = n_shards or len(visible)
    return StreamMesh(tuple(visible[j % len(visible)] for j in range(n)))


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """A host mesh: ``devices[i][j]`` runs the shard at data index i and
    model index j, all from one process."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> ModelMesh:
    """A ``(data, model)`` grid over the visible devices of ``device``'s
    type (None: the card), round-robin in row-major order as
    ``make_stream_mesh`` places its shards: on one card every shard is
    ``cuda:0``."""
    flat = make_stream_mesh(data * model, device).devices
    return ModelMesh(tuple(flat[i * model:(i + 1) * model]
                           for i in range(data)))


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A placeholder mesh: ``device_mesh`` spans the ranks of a fake
    process group, and tensors placed on it live on the meta device."""
    device_mesh: object
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None):
    """The reference's production mesh, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` over ``("pod", "data", "model")``, as a
    placeholder: a fake process group of 256 or 512 ranks is created on
    entry and destroyed on exit (``shape`` overrides the sizes, keeping
    the axes: the tests trace on ``(2, 2)`` and ``(2, 2, 2)``).  One
    process group at a time: entering raises if one exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = tuple(shape or ((2, 16, 16) if multi_pod else (16, 16)))
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    size = 1
    for n in shape:
        size *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield ProductionMesh(init_device_mesh("cpu", shape,
                                              mesh_dim_names=axes), axes)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Copy accounting
# ---------------------------------------------------------------------------

# aten copies and the argument each copies from (the result is the
# destination)
_COPIES = {"aten::_to_copy": 0, "aten::copy_": 1, "aten::_copy_from": 0,
           "aten::_copy_from_and_resize": 0}


@contextlib.contextmanager
def record_copies():
    """Inside this block every copy between two devices is appended to the
    yielded list as ``(source, destination, bytes)`` (a
    ``TorchDispatchMode``: every aten call of the block passes through
    it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    log: list = []

    class CopyLog(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            src = _COPIES.get(func._schema.name)
            if (src is not None and isinstance(out, torch.Tensor)
                    and args[src].device != out.device):
                log.append((args[src].device, out.device,
                            out.numel() * out.element_size()))
            return out

    with CopyLog():
        yield log


def collective_bytes(copies, devices) -> Dict[str, int]:
    """Bytes ``copies`` (from ``record_copies``) moved between two distinct
    devices of ``devices`` (a mesh's), keyed ``"device-to-device"``;
    ``{}`` when none did."""
    mesh = set(devices)
    moved = sum(b for src, dst, b in copies
                if src in mesh and dst in mesh and src != dst)
    return {"device-to-device": moved} if moved else {}


def host_transfer_ops(graphs: Dict[tuple, dict]) -> Optional[int]:
    """Memory copies touching host memory in a pipeline's captured graphs
    (``persistent_graphs()``); None where the driver could not read a
    graph's nodes."""
    counts = [(g.get("nodes") or {}).get("host_copies")
              for g in graphs.values()]
    return None if any(c is None for c in counts) else sum(counts)
