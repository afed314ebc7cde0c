"""Checkpoints: async save, atomic manifests, shape-checked restore.

Held against ``src/repro/checkpoint/checkpoint.py``, and byte-compatible
with it: a directory written by either package restores in the other.

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per tree leaf plus a
``MANIFEST.json`` written *last* (the commit point): a crash mid-save
leaves no manifest and the step is invisible to ``latest_step``, so a
restart resumes from the previous complete step.  Saves run on a
background thread (its time is the ``checkpoint.write`` span); ``wait()``
joins the pending one, and a second save joins the first (one pending
save at a time per ``Checkpointer``).

Leaves are numbered in the reference's flatten order (``flatten``): dict
keys sorted, dataclass fields in declared order, tuples (NamedTuples
such as ``adamw.OptState`` among them) and lists in order, ``None`` an
empty subtree.  bfloat16 and float8 leaves, which
``.npy`` has no codec for, are stored as unsigned integer views with a
dtype tag (``"bfloat16"``) and restored through torch's view of the same
bits.  ``restore`` returns torch tensors on the CPU.

The module-level ``save``/``wait``/... functions are thin wrappers over a
lock-guarded per-directory registry of ``Checkpointer`` objects.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs

_MANIFEST = "MANIFEST.json"

# the dtypes ``.npy`` stores as they are; any other is an unsigned view
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool")
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


# ------------------------------------------------------------ tree order --

def flatten(tree: Any) -> List[Any]:
    """The tree's leaves in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in flatten(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure filled with ``leaves`` (``flatten``'s order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            items = [build(v) for v in t]
            return (type(t)(*items) if hasattr(t, "_fields")   # NamedTuple
                    else type(t)(items))
        return next(it)

    out = build(like)
    assert next(it, None) is None, "more leaves than the tree holds"
    return out


# ------------------------------------------------------------ dtype codec --

def host_copy(leaf: Any):
    """A host copy the caller's later writes cannot reach: a CUDA tensor
    is copied to the CPU (synchronously), a CPU tensor or array cloned."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """bf16/f8 have no stable npy codec: store as uint views + dtype tag."""
    if isinstance(leaf, torch.Tensor):
        tag = str(leaf.dtype).removeprefix("torch.")
        if tag in _NATIVE:
            return leaf.numpy(), tag
        size = leaf.element_size()
        return (leaf.contiguous().view(_SIGNED[size]).numpy()
                .view(_UINT[size]), tag)
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) not in _NATIVE:
        return arr.view(_UINT[arr.dtype.itemsize]), str(arr.dtype)
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    if dtype_tag in _NATIVE:
        return torch.from_numpy(arr.astype(dtype_tag, copy=False))
    signed = arr.view(np.dtype(f"int{8 * arr.dtype.itemsize}"))
    return torch.from_numpy(signed).view(getattr(torch, dtype_tag))


# ----------------------------------------------------------- Checkpointer --

class Checkpointer:
    """Per-instance checkpoint manager: one pending async save at a time,
    atomic manifest commits, shape-checked restore."""

    def __init__(self, ckpt_dir: str):
        self.dir = str(ckpt_dir)
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, async_: bool = True,
             extra: Optional[dict] = None):
        """Snapshot ``tree`` as step ``step``.  Leaves are copied to the
        host *before* returning (the caller may overwrite its tensors
        right after); the disk write happens on a background thread unless
        ``async_=False``."""
        host_leaves = [host_copy(leaf) for leaf in flatten(tree)]

        def _write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            with _obs.span("checkpoint.write"):
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
                dtype_tags = []
                for i, leaf in enumerate(host_leaves):
                    store, tag = _to_storable(leaf)
                    dtype_tags.append(tag)
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), store)
                manifest = {
                    "step": step,
                    "n_leaves": len(host_leaves),
                    "shapes": [list(a.shape) for a in host_leaves],
                    "dtypes": dtype_tags,
                    "extra": extra or {},
                }
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f)
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)                 # atomic commit

        if async_:
            t = threading.Thread(target=_write, daemon=True)
            with self._lock:
                # publish and start atomically: anything wait() pops from
                # _pending has been started
                prev, self._pending = self._pending, t
                t.start()
            if prev is not None:
                prev.join()        # one pending save at a time
        else:
            _write()

    def wait(self):
        """Join the in-flight async save, if any."""
        with self._lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def manifest(self, step: int) -> dict:
        """The committed manifest of ``step`` (includes caller ``extra``)."""
        path = os.path.join(self.dir, f"step_{step:08d}", _MANIFEST)
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, like: Any) -> Any:
        return restore(self.dir, step, like)

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)


# -------------------------------------------------- module-level wrappers --
_registry: dict = {}
_registry_lock = threading.Lock()


def _for_dir(ckpt_dir: str) -> Checkpointer:
    with _registry_lock:
        ck = _registry.get(ckpt_dir)
        if ck is None:
            ck = _registry[ckpt_dir] = Checkpointer(ckpt_dir)
        return ck


def save(ckpt_dir: str, step: int, tree: Any, *, async_: bool = True,
         extra: Optional[dict] = None):
    _for_dir(ckpt_dir).save(step, tree, async_=async_, extra=extra)


def wait(ckpt_dir: str):
    _for_dir(ckpt_dir).wait()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step with a committed manifest (incomplete saves invisible)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            continue
        try:
            s = int(name.split("_")[1])
        except ValueError:
            continue
        best = s if best is None else max(best, s)
    return best


def read_manifest(ckpt_dir: str, step: int) -> dict:
    return _for_dir(ckpt_dir).manifest(step)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Step ``step`` in ``like``'s structure, as CPU tensors; each leaf's
    shape must equal ``like``'s."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = flatten(like)
    assert manifest["n_leaves"] == len(leaves), "tree structure changed"
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        t = _from_storable(arr, manifest["dtypes"][i])
        want = ref.shape if hasattr(ref, "shape") else np.shape(ref)
        assert list(t.shape) == list(want), f"leaf {i} shape mismatch"
        out.append(t)
    return unflatten(like, out)


def restore_latest(ckpt_dir: str, like: Any):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, restore(ckpt_dir, step, like)
