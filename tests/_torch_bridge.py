"""Numpy bridge between the JAX reference (``repro``) and the PyTorch port
(``repro_torch``) for the ``test_torch_*`` files: the same inputs go to
both packages, and their results come back as numpy."""

import dataclasses

import numpy as np
import torch

from repro_torch.core import tuples as PT


def np_tree(tree):
    """A reference or port state tree as nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: np_tree(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return np.asarray(tree)


def assert_tree_equal(a, b, skip=(), path=""):
    """Exact equality of two ``np_tree``s (values and dtypes)."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            if k not in skip:
                assert_tree_equal(a[k], b[k], skip, f"{path}.{k}")
        return
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def to_port(batch) -> PT.TupleBatch:
    """A reference TupleBatch as a port TupleBatch on the CPU."""
    return PT.TupleBatch(**{f: torch.from_numpy(np.array(getattr(batch, f)))
                            for f in PT.FIELDS})


def port_reconfig(rc):
    from repro_torch.core.controller import Reconfiguration
    return None if rc is None else Reconfiguration(
        epoch=rc.epoch, n_active=rc.n_active, fmu=np.asarray(rc.fmu),
        active=np.asarray(rc.active))
