"""The port's model-mesh layer against the reference on the CPU:
``launch/specs.py`` (the rules at TP 16 and 4, the parameter, ZeRO-1
optimizer and cache spec trees of all ten architectures at full size, as
shapes only), ``models/sharding.py`` (``resolve``, ``shard``'s
no-opinion guard, ``axis_resolves``), ``fit_spec``, and
``compressed_psum`` over the ``data`` axis of a host mesh against the
reference's under ``jax.vmap(axis_name="data")``.  A spec is compared as
a tuple (the reference's ``PartitionSpec``, the port's ``P``)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import ARCHS, get_config
from repro.launch import specs as RS
from repro.models import model as RM, sharding as RSH
from repro.optim import compress as RC
from repro_torch import configs as pconfigs
from repro_torch.launch import specs as PS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert, model as PM, sharding as PSH
from repro_torch.optim import compress as PC


def _tuples(tree):
    """A spec tree with every spec as a plain tuple (jax's
    ``PartitionSpec`` or the port's ``P``)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    if tree is None:
        return None
    return tuple(tree)


def _ref_tuples(tree):
    return _tuples(jax.tree.map(
        lambda s: s, tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references(arch):
    """``make_rules`` at TP 16 and 4, ``param_specs`` (the reference's
    layout with ``stacked``, and the port's per-layer tree: each layer's
    specs without the stacked layer axis), ``opt_specs`` over the
    reference's layout of the port's abstract parameters, and
    ``cache_specs``."""
    cfg, pcfg = get_config(arch), pconfigs.get_config(arch)
    for tp in (16, 4):
        assert PS.make_rules(pcfg, tp) == RS.make_rules(cfg, tp)
    want = _ref_tuples(RS.param_specs(cfg))
    assert _tuples(PS.param_specs(pcfg, stacked=True)) == want
    mine = _tuples(PS.param_specs(pcfg))
    layer = (jax.tree.map(lambda s: s[1:], want["layers"],
                          is_leaf=lambda x: isinstance(x, tuple))
             if cfg.scan_layers else want["layers"][0])
    assert mine["layers"] == [layer] * cfg.n_layers
    assert {k: v for k, v in mine.items() if k != "layers"} == \
        {k: v for k, v in want.items() if k != "layers"}

    aparams = RM.abstract_params(cfg)
    pparams = convert.to_reference(PM.abstract_params(pcfg), pcfg)
    for size, axes in ((16, ("data",)), (32, ("pod", "data"))):
        assert _tuples(PS.opt_specs(pparams, PS.param_specs(
            pcfg, stacked=True), size, axes)) == _ref_tuples(RS.opt_specs(
                aparams, RS.param_specs(cfg), size, axes))
    for tp in (16, 4):
        rc, rs = RS.cache_specs(cfg, RS.make_rules(cfg, tp))
        pc, ps = PS.cache_specs(pcfg, PS.make_rules(pcfg, tp))
        assert _tuples(pc) == _ref_tuples(rc)
        assert _tuples(ps) == _ref_tuples(rs)


def test_resolve_shard_and_axis_resolves_match_the_reference():
    """Under a (1, 1) mesh and several rule sets: ``resolve`` of every
    logical name (tuples filtered by the mesh's axes), ``axis_resolves``,
    and ``shard``'s no-opinion guard (a spec resolving to all-None gives
    the input itself, ``tests/test_sliced_layouts.py``'s check); without a
    mesh, ``shard`` returns its input and nothing resolves."""
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    pmesh = make_host_mesh(1, 1, "cpu")
    names = list(RSH.DEFAULT_RULES) + [None, "unknown"]
    rule_sets = [None, dict(heads=None, head_dim=None),
                 dict(batch=("pod", "data", "model"), seq="model"),
                 dict(batch=("pod",), vocab="data")]
    for rules in rule_sets:
        with RSH.use_rules(rmesh, rules), PSH.use_rules(pmesh, rules):
            for n in names:
                assert tuple(PSH.resolve(n)) == tuple(RSH.resolve(n)), n
                if n is not None:
                    assert PSH.axis_resolves(n) == RSH.axis_resolves(n), n
            assert tuple(PSH.resolve(*names)) == tuple(RSH.resolve(*names))
            x = torch.ones(4, 4)
            assert PSH.shard(x, "heads", "head_dim") is x
            assert PSH.shard(x, "batch", "mlp") is x   # a host mesh
            assert PSH.named_sharding("batch").spec == tuple(
                RSH.named_sharding("batch").spec)
    x = torch.ones(2)
    assert PSH.current_mesh() is None and PSH.shard(x, "batch") is x
    assert not PSH.axis_resolves("mlp") and PSH.named_sharding() is None


def test_fit_spec_matches_the_reference():
    rng = np.random.default_rng(0)
    choices = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model"), "missing"]
    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16},
                  {"data": 2, "model": 1}):
        mesh = types.SimpleNamespace(shape=shape)
        for _ in range(200):
            nd = int(rng.integers(1, 5))
            dims = tuple(int(d) for d in rng.choice(
                [1, 2, 3, 16, 32, 48, 64, 100, 512], nd))
            entries = [choices[i] for i in rng.integers(0, len(choices),
                                                        int(rng.integers(0, nd + 1)))]
            want = RS.fit_spec(jax.sharding.PartitionSpec(*entries), dims,
                               mesh)
            got = PS.fit_spec(PSH.P(*entries), dims, mesh)
            assert tuple(got) == tuple(want), (entries, dims, shape)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_over_data_matches_reference(n):
    """One gradient tree a replica along ``data`` (host mesh n x 1 on the
    CPU) against the reference's ``compressed_psum(..., "data")`` under
    ``jax.vmap(axis_name="data")``: the reduced gradients (int8 summed as
    int32, the largest scale) equal on every replica, each replica's
    residual its own."""
    rng = np.random.default_rng(n)
    grads = {"a": rng.normal(0, 1, (n, 8, 5)).astype(np.float32),
             "b": (rng.normal(0, 1e-3, (n, 33)) * rng.choice(
                 [1, 50], (n, 33))).astype(np.float32)}
    res = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
           for k, v in grads.items()}
    dec, res2 = jax.vmap(lambda g, r: RC.compressed_psum(g, r, "data"),
                         axis_name="data")(grads, res)
    per = lambda t, i: {k: torch.from_numpy(v[i].copy())
                        for k, v in t.items()}
    with PSH.use_rules(make_host_mesh(n, 1, "cpu")):
        pdec, pres = PC.compressed_psum([per(grads, i) for i in range(n)],
                                        [per(res, i) for i in range(n)],
                                        axis_name="data")
        with pytest.raises(ValueError, match="replicas"):
            PC.compressed_psum([per(grads, 0)], [per(res, 0)], "data")
    for i in range(n):
        for k in grads:
            np.testing.assert_array_equal(pdec[i][k].numpy(),
                                          np.asarray(dec[k][i]))
            np.testing.assert_allclose(pres[i][k].numpy(),
                                       np.asarray(res2[k][i]), atol=1e-7)


def test_vsn_moe_on_a_host_mesh_splits_tokens_over_data():
    """Under a (2, 2) host mesh the ``vsn`` MoE routes each data row's
    block of tokens on its own (capacity a block, as the reference's
    ``P(dp)`` token spec gives each data shard), over 2 expert shards:
    the two halves of the token block, each through 2 shards, side by
    side."""
    import dataclasses
    from repro_torch.models import moe as PMOE
    pcfg = pconfigs.reduced(pconfigs.get_config("qwen3_moe_30b_a3b"))
    pcfg = dataclasses.replace(pcfg, dtype="float32")
    p = PMOE.init_moe(torch.Generator().manual_seed(0), pcfg, torch.float32,
                      "cpu")
    x = torch.randn(1, 24, pcfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with PSH.use_rules(make_host_mesh(2, 2, "cpu")):
        y, dropped = PMOE._vsn_moe(p, x, pcfg)
    halves = [PMOE._vsn_moe(p, x[:, h * 12:(h + 1) * 12], pcfg, 2)
              for h in (0, 1)]
    assert torch.equal(y, torch.cat([h[0] for h in halves], dim=1))
    assert int(dropped.sum()) == sum(int(h[1].sum()) for h in halves) > 0
    whole, _ = PMOE._vsn_moe(p, x, pcfg, 2)
    assert not torch.equal(y, whole)
