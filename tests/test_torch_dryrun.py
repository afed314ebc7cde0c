"""The port's dry-run and roofline on the CPU (``launch/dryrun.py``,
``launch/roofline.py``), at reduced size.

Each cell of the four served architectures (qwen3-14b, rwkv6-7b,
deepseek-moe-16b, hymba-1.5b) reduced, at the four shapes, is traced on a
``(2, 2)`` placeholder mesh, and rwkv6-7b's and deepseek-moe-16b's decode
on ``(2, 2, 2)`` (pod, data, model): each reports ``ok`` or the
reference's skip, and its argument bytes per device equal those computed
from the reference's own spec trees (``repro.launch.specs``) and shapes.
A process group exists only inside a cell; a fixture destroys any left
behind, since other files run in this worker after this one.  The
roofline's ``analyse`` and two-point ``solve`` equal the reference's on
the same record with the reference module's constants set to the H100
figures the port uses."""

import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.configs import get_config as rget, reduced as rreduced
from repro.launch import specs as RS
from repro.models import model as RM, transformer as RT
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as D, roofline as PR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as PSH

ARCHS = ["qwen3_14b", "rwkv6_7b", "deepseek_moe_16b", "hymba_1_5b"]


@pytest.fixture(autouse=True)
def no_process_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group was left behind")


def _ref_argument_bytes(arch, shape_name, multi_pod):
    """The bytes a device holds of the cell's arguments, from the
    reference's spec trees and abstract shapes."""
    cfg = rreduced(rget(arch))
    shape = D.SHAPES[shape_name]
    sizes = ({"pod": 2, "data": 2, "model": 2} if multi_pod
             else {"data": 2, "model": 2})
    mesh = types.SimpleNamespace(shape=sizes)
    dp = ("pod", "data") if multi_pod else "data"
    P = jax.sharding.PartitionSpec
    is_p = lambda x: isinstance(x, P)

    def nbytes(spec, leaf):
        spec = RS.fit_spec(spec, leaf.shape, mesh)
        n = 1
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * len(
                leaf.shape)):
            axes = ax if isinstance(ax, tuple) else (ax,)
            n *= dim // math.prod(sizes[a] for a in axes if a)
        return n * np.dtype(leaf.dtype).itemsize

    def total(specs, tree):
        return sum(jax.tree.leaves(jax.tree.map(nbytes, specs, tree,
                                                is_leaf=is_p)))

    aparams = RM.abstract_params(cfg)
    pspecs = RS.fit_tree(RS.param_specs(cfg), aparams, mesh)
    out = total(pspecs, aparams)
    rules = RS.make_rules(cfg, tp=2)
    b, s = shape["batch"], shape["seq"]
    if shape["kind"] == "train":
        dp_size = 4 if multi_pod else 2
        z = RS.opt_specs(aparams, pspecs, dp_size,
                         ("pod", "data") if multi_pod else ("data",))
        mu = RM.abstract_opt(aparams).mu                  # float32
        out += 2 * total(z, mu) + 4
        batch = RM.make_train_batch_shapes(cfg, b, s)
        out += total({k: P(dp) for k in batch}, batch)
    elif shape["kind"] == "prefill":
        out += total(P(dp), jax.ShapeDtypeStruct((b, s), np.int32))
    else:
        caches, states = jax.eval_shape(
            lambda: RT.init_caches(cfg, b, s))
        cspec, sspec = RS.cache_specs(cfg, dict(
            rules, batch=("pod", "data") if multi_pod else ("data",)))
        if caches is not None:
            out += total({k: cspec[k] for k in caches}, caches)
        if states is not None:
            out += (total(sspec, states) if not is_p(sspec) else
                    nbytes(sspec, states))
        out += total(P(dp), jax.ShapeDtypeStruct((b,), np.int32))
    return out


CELLS = [(a, s, False) for a in ARCHS for s in D.SHAPES] + [
    ("rwkv6_7b", "decode_32k", True), ("deepseek_moe_16b", "decode_32k",
                                       True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x2x2' if m else '2x2'}"
                              for a, s, m in CELLS])
def test_dryrun_cell_of_a_reduced_config(arch, shape, multi_pod):
    cfg = reduced(get_config(arch))
    r = D.run_cell(arch, shape, multi_pod, cfg=cfg,
                   mesh_shape=(2, 2, 2) if multi_pod else (2, 2))
    if shape == "long_500k" and cfg.kind not in D.LONG_OK_KINDS:
        assert r["status"] == "skipped (full attention)"
        return
    assert r["status"] == "ok", r
    assert r["argument_bytes_per_device"] == _ref_argument_bytes(
        arch, shape, multi_pod)
    assert r["flops"] > 0 and r["hlo_bytes"] > 0
    assert r["peak_bytes_per_device"] == (
        r["argument_bytes_per_device"] + r["output_bytes_per_device"]
        + r["temp_bytes_per_device"] - r["alias_bytes_per_device"])
    n = cfg.n_layers
    kinds = {"dense": ("flash_attention",), "moe": ("flash_attention",),
             "rwkv": ("linear_scan",),
             "hybrid": ("flash_attention", "linear_scan")}[cfg.kind]
    if D.SHAPES[shape]["kind"] == "train":
        # forward and the per-block recompute, then one backward
        want = {k: 2 * n for k in kinds} | {k + "_bwd": n for k in kinds}
    else:
        want = {k: n for k in kinds}
    assert r["kernels"] == want
    if cfg.kind == "moe":
        # the expert shards' partials meet in one bfloat16 all-reduce
        assert r["collective_bytes"].get("all-reduce", 0) > 0


def test_shard_under_a_placeholder_mesh():
    """``shard`` redistributes a ``DTensor`` to the resolved placements,
    keeps the no-opinion guard, and leaves a dimension its axes do not
    divide alone."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with make_production_mesh(shape=(2, 2)) as mesh:
        x = distribute_tensor(torch.empty(4, 6, 8, device="meta"),
                              mesh.device_mesh, [Replicate(), Replicate()])
        with PSH.use_rules(mesh):
            y = PSH.shard(x, "batch", "seq", "mlp")
            assert list(y.placements) == [Shard(0), Shard(2)]
            assert PSH.shard(x, "seq", "embed", None) is x
            one = distribute_tensor(torch.empty(1, 6, device="meta"),
                                    mesh.device_mesh, [Replicate()] * 2)
            assert list(PSH.shard(one, "batch", "mlp").placements) == [
                Replicate(), Shard(1)]
            assert PSH.axis_resolves("batch")
            assert not PSH.axis_resolves("seq")


def test_roofline_matches_the_reference_with_h100_constants(monkeypatch):
    """``analyse`` on one record and ``solve`` on two depths, against the
    reference's with its constants monkeypatched to the H100 figures
    (``LINKS * ICI_BW`` = the port's one-way NVLink rate)."""
    jax.devices()                     # the backend is up before the import
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as RD, roofline as RR
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    for name, value in (("PEAK_FLOPS", PR.PEAK_FLOPS), ("HBM_BW", PR.HBM_BW),
                        ("ICI_BW", PR.NVLINK_BW), ("LINKS", 1)):
        monkeypatch.setattr(RR, name, value)
    for arch in ("qwen3_14b", "rwkv6_7b", "deepseek_moe_16b", "hymba_1_5b",
                 "gemma3_4b"):
        for shape in D.SHAPES:
            rec = {"arch": arch, "shape": shape, "status": "ok",
                   "flops_dev": 3.1e13, "bytes_dev": 2.2e11,
                   "bytes_dev_raw": 4.4e11, "coll_dev": 7.0e9}
            assert PR.analyse(rec, 12.5) == RR.analyse(rec, 12.5)
            cfg, rcfg = get_config(arch), rget(arch)
            for f in ("model_flops_per_device", "recurrence_flops_per_device",
                      "attention_interior_bytes", "recurrence_interior_bytes",
                      "min_bytes_per_device"):
                assert getattr(PR, f)(cfg, shape) == getattr(RR, f)(rcfg,
                                                                    shape)

    # the reference's two-point solve, fed the same two traces
    points = {2: (1.0e12, 5.0e10, 3.0e8), 4: (1.9e12, 9.0e10, 5.5e8)}

    def fake(arch, shape, multi_pod=False, cfg=None, **kw):
        f, b, c = points[cfg.n_layers]
        return {"status": "ok", "flops": f, "hlo_bytes": b,
                "collective_bytes": {"all-reduce": c}}
    monkeypatch.setattr(RD, "run_cell", fake)
    monkeypatch.setattr(D, "run_cell", fake)
    for arch in ("qwen3_14b", "deepseek_moe_16b"):
        want = RR.measure_cell(arch, "decode_32k")
        got = PR.measure_cell(arch, "decode_32k")
        n = get_config(arch).n_layers
        assert [PR.solve(points, n, i) for i in range(3)] == [
            want["flops_dev"], want["bytes_dev_raw"], want["coll_dev"]]
        assert got == want
