"""Kernel registry: one entry per kernel, dispatched on the tensor's device.

Held against ``src/repro/kernels/dispatch.py``.  The reference picks a
backend by an explicit argument, an environment variable or the hardware.
Here the choice is the data's own: a kernel entry runs its plain PyTorch
version for CPU tensors and launches its CUDA kernel for CUDA tensors.
There is no backend switch, so nothing can send a CUDA tensor to the plain
version; a CUDA launch that fails raises.

A backward kernel (``flash_attention_bwd``, ``linear_scan_bwd``) is an
entry like any other; its ``replaces`` names the reference function whose
``jax.grad`` it computes, since the reference has no backward Pallas
kernel.

Each entry counts its launches in a plain integer, ``Kernel.launches``,
incremented once per kernel launch and nowhere else, so a run can show that
its path went through the kernel.  The ingest tier launches from several
threads at once, so the increment holds a lock.  A call made while a CUDA
graph is captured launches nothing: inside ``recording()`` it goes to the
capturing thread's tally instead, and ``add_launches`` adds that tally
each time the graph is replayed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict

import torch

_COUNT_LOCK = threading.Lock()
_CAPTURE = threading.local()


@dataclasses.dataclass
class Kernel:
    name: str
    plain: Callable      # plain PyTorch version (CPU tensors)
    cuda: Callable       # launcher of the CUDA kernel (CUDA tensors)
    replaces: str        # file:line of the Pallas TPU kernel it replaces;
                         # a backward kernel, which no Pallas kernel has,
                         # names the reference function whose jax.grad
                         # it computes
    source: str          # CUDA source, relative to the repo root
    launches: int = 0

    def __call__(self, *args, **kwargs):
        dev = args[0].device
        if dev.type == "cpu":
            return self.plain(*args, **kwargs)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {dev}")
        out = self.cuda(*args, **kwargs)
        tally = getattr(_CAPTURE, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + 1
            return out
        with _COUNT_LOCK:
            self.launches += 1
        return out


_REGISTRY: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    _REGISTRY[kernel.name] = kernel
    return kernel


def registered() -> Dict[str, Kernel]:
    """name -> Kernel for every kernel module imported so far."""
    return dict(_REGISTRY)


def reset_launches() -> None:
    for k in _REGISTRY.values():
        k.launches = 0


@contextlib.contextmanager
def recording():
    """Inside this block this thread's kernel calls are being captured into
    a CUDA graph: they are tallied by name in the yielded dict, not
    counted as launches."""
    prev = getattr(_CAPTURE, "tally", None)
    _CAPTURE.tally = tally = {}
    try:
        yield tally
    finally:
        _CAPTURE.tally = prev


def add_launches(tally: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture tallied
    ``tally``."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            _REGISTRY[name].launches += n


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Validate a kernel argument before its pointer is handed to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
