"""The stream mesh and its copy accounting.

Held against ``src/repro/launch/mesh.py`` (``make_stream_mesh``,
``collective_bytes``, ``host_transfer_ops``).  The reference builds a 1-D
``jax`` mesh and reads its witnesses out of compiled HLO.  Here a mesh is
a list of devices in one controller process, one a shard
(``core.runtime.MeshPipeline`` drives it); shards may share a device, as
the reference's CI shares one CPU among devices forced by ``XLA_FLAGS``.
On one card every shard is on ``cuda:0``: that run shows the
partitioning and the zero-byte switch, not a speed-up.

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
