"""The port's training path against the reference on the CPU, at reduced
sizes: ``datagen.token_batches``, ``transformer.loss_fn`` and its
gradient, ``model.train_step`` (m = 1 and m = 2 microbatches), AdamW,
int8 gradient compression, ``scan_utils.chunked_scan`` and the abstract
shapes.  The reference's parameters are carried across with
``convert.from_reference``; its ``train_step`` is ``jax.jit``ted.

Limits, float32 (reduced qwen3-14b, rwkv6-7b, deepseek-moe-16b and
hymba-1.5b, where the kernels are their plain versions):
- loss within 2e-6 relative, gradients within ``GRAD_RTOL`` of each leaf's
  largest magnitude (1e-4; deepseek's ``vsn`` MoE rounds its expert sum
  to bfloat16 even in float32, so its gradients get 2^-7 (measured
  2.2e-3 on one leaf));
- each of three ``train_step``s starts from the reference's state after
  the step before (the port's state would drift: AdamW's first step
  moves every element by about lr whatever its gradient's size, so a
  gradient near rounding noise may flip sign and move a parameter by up
  to 2 lr, and the MoE's routing turns such a move into another expert
  choice).  Loss within 1e-5 relative and gradient norm within 5e-5
  (measured 1.3e-5, rwkv6-7b; MoE both 1e-3), lr and the dropped count
  equal; parameters within 2.5 lr of the reference's everywhere and
  within 1e-6 on all but ``PARAM_SHARE`` (1e-3; measured at most 3.4e-4)
  of their elements; the moments within 2^-7 of each leaf's largest (the
  gradients are cast to bfloat16 before the update, so a gradient may
  round to the neighbouring bfloat16).
In bfloat16 (hymba-1.5b, m = 2): loss within 1e-3 relative (measured
1.3e-4), gradient norm within 1e-2 (3.1e-3), parameters within 2.5 lr
plus one bfloat16 ulp of the parameter and on all but 5 % of elements
within 1e-6, the moments within 2^-3 of each leaf's largest (4.6e-2: the
two frameworks round the bfloat16 gradients' sums, the tied embedding's
gather and unembedding among them, at other places) and on all but 2 %
of elements within 2^-7 (1.0 %).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import canon, get_config, reduced
from repro.data import datagen as RD
from repro.models import model as RM, scan_utils as RS, transformer as RT
from repro.optim import adamw as RA, compress as RC
from repro_torch import configs as pconfigs
from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.data import datagen as PD
from repro_torch.models import convert, model as PM, scan_utils as PS
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA, compress as PC

ARCHS = ["qwen3-14b", "rwkv6-7b", "deepseek-moe-16b", "hymba-1.5b"]
GRAD_RTOL = 1e-4
MOE_GRAD_RTOL = 2 ** -7
PARAM_SHARE = 1e-3
LR = 3e-4
B, S = 4, 16


def _configs(arch, dtype="float32", m=1):
    upd = dict(dtype=dtype, n_microbatches=m)
    return (dataclasses.replace(reduced(get_config(canon(arch))), **upd),
            dataclasses.replace(
                pconfigs.reduced(pconfigs.get_config(canon(arch))), **upd))


def _np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _port_np(tree, cfg):
    return [x.detach().float().numpy()
            for x in flatten(convert.to_reference(tree, cfg))]


def _batches(vocab, n=3, seed=0):
    return list(RD.token_batches(np.random.default_rng(seed), vocab=vocab,
                                 batch=B, seq=S, n_batches=n))


def test_token_batches_equal_reference():
    for seed in (0, 10):
        want = RD.token_batches(np.random.default_rng(seed), vocab=32001,
                                batch=3, seq=17, n_batches=4)
        got = PD.token_batches(np.random.default_rng(seed), vocab=32001,
                               batch=3, seq=17, n_batches=4)
        for w, g in zip(want, got, strict=True):
            assert w.keys() == g.keys()
            for k in w:
                assert w[k].dtype == g[k].dtype
                np.testing.assert_array_equal(w[k], g[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grad_match_reference(arch):
    cfg, pcfg = _configs(arch)
    params = RT.init_params(jax.random.PRNGKey(1), cfg)
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    batch = _batches(cfg.vocab, 1, seed=3)[0]
    batch["mask"][0, : S // 2] = 0.0                # a masked prefix
    (want, want_aux), want_g = jax.value_and_grad(
        lambda p: RT.loss_fn(p, cfg, jnp.asarray(batch["inputs"]),
                             jnp.asarray(batch["labels"]),
                             jnp.asarray(batch["mask"]), jnp.arange(S),
                             chunk=S), has_aux=True)(params)
    leaves = [x.requires_grad_() for x in flatten(pp)]
    loss, aux = PT.loss_fn(pp, pcfg, *(torch.from_numpy(batch[k]) for k in
                                       ("inputs", "labels", "mask")),
                           torch.arange(S))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=2e-6)
    assert float(aux) == float(want_aux)
    rtol = MOE_GRAD_RTOL if arch.startswith("deepseek") else GRAD_RTOL
    ref_g = _np(want_g)
    got_g = _port_np(unflatten(pp, list(grads)), pcfg)
    assert len(ref_g) == len(got_g)
    for i, (g, w) in enumerate(zip(got_g, ref_g)):
        assert g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-3)
        assert np.abs(g - w).max() <= rtol * scale, (i, np.abs(g - w).max(),
                                                     scale)
        # every gradient reaches its parameter (the router's through the
        # MoE's gates among them)
        assert np.abs(w).max() > 0 or np.abs(g).max() == 0, i


def _port_state(params, opt, pcfg):
    """The reference's (params, opt) as the port's, on the CPU."""
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    po = convert.opt_from_reference(jax.tree.map(np.asarray, opt), pcfg,
                                    "cpu")
    return pp, po


def _run_steps(arch, m, dtype):
    """Three steps, each from the reference's state before it: ->
    [(reference (params, opt, metrics), port (params, opt, metrics))]."""
    cfg, pcfg = _configs(arch, dtype, m)
    ocfg = RA.AdamWConfig(lr=LR, total_steps=3, warmup_steps=1)
    pocfg = PA.AdamWConfig(lr=LR, total_steps=3, warmup_steps=1)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    opt = RA.init_opt(params)
    step = jax.jit(functools.partial(RM.train_step, cfg=cfg, opt_cfg=ocfg,
                                     chunk=S))
    out = []
    for batch in _batches(cfg.vocab):
        pp, po = _port_state(params, opt, pcfg)
        got = PM.train_step(pp, po, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                            cfg=pcfg, opt_cfg=pocfg)
        params, opt, met = step(params, opt, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        out.append(((params, opt, met), got))
    return pcfg, out


def _check_steps(pcfg, out, *, loss_rtol, gn_rtol, p_ulp, share,
                 mom_tol=2 ** -7, mom_share=0.0):
    for n, ((params, opt, met), (pp, po, pmet)) in enumerate(out, 1):
        assert set(pmet) == set(met)
        np.testing.assert_allclose(float(pmet["loss"]), float(met["loss"]),
                                   rtol=loss_rtol, err_msg=f"step {n}")
        np.testing.assert_allclose(float(pmet["grad_norm"]),
                                   float(met["grad_norm"]), rtol=gn_rtol,
                                   err_msg=f"step {n}")
        assert float(pmet["lr"]) == float(met["lr"])
        assert float(pmet["dropped"]) == float(met["dropped"])
        assert int(po.step) == int(opt.step) == n
        lr = float(met["lr"])
        past, total = 0, 0
        for i, (g, w) in enumerate(zip(_port_np(pp, pcfg), _np(params))):
            d = np.abs(g - w)
            assert (d <= 2.5 * lr + p_ulp * np.abs(w)).all(), (n, i,
                                                               d.max())
            past += int((d > 1e-6).sum())
            total += d.size
        assert past <= share * total, (n, past / total)
        for tree, ptree in ((opt.mu, po.mu), (opt.nu, po.nu)):
            past, total = 0, 0
            for i, (g, w) in enumerate(zip(_port_np(ptree, pcfg),
                                           _np(tree))):
                scale = max(float(np.abs(w).max()), 1e-12)
                d = np.abs(g - w)
                assert d.max() <= mom_tol * scale, (n, i, d.max() / scale)
                past += int((d > 2 ** -7 * scale).sum())
                total += d.size
            assert past <= mom_share * total, (n, past / total)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, m):
    pcfg, out = _run_steps(arch, m, "float32")
    moe = arch.startswith("deepseek")
    _check_steps(pcfg, out, loss_rtol=1e-3 if moe else 1e-5,
                 gn_rtol=1e-3 if moe else 5e-5, p_ulp=0.0,
                 share=PARAM_SHARE)


def test_train_steps_bfloat16():
    pcfg, out = _run_steps("hymba-1.5b", 2, "bfloat16")
    _check_steps(pcfg, out, loss_rtol=1e-3, gn_rtol=1e-2, p_ulp=2 ** -7,
                 share=0.05, mom_tol=2 ** -3, mom_share=0.02)
    for g, w in zip(_port_np(out[-1][1][0], pcfg), _np(out[-1][0][0])):
        assert g.dtype == w.dtype


# ------------------------------------------------------------- AdamW --

def test_adamw_matches_reference():
    ocfg = RA.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    pocfg = PA.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)
    for s in range(0, 13):
        assert float(PA.schedule(pocfg, torch.tensor(s, dtype=torch.int32))) \
            == float(RA.schedule(ocfg, jnp.int32(s)))
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
              "b": {"c": rng.normal(0, 1, (3,)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.normal(0, 3, p.shape).astype(
        np.float32), params)
    want = RA.global_norm(grads)
    got = PA.global_norm(jax.tree.map(torch.from_numpy, grads))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    ropt = RA.init_opt(params)
    popt = PA.init_opt(jax.tree.map(torch.from_numpy, params))
    rp, pp = params, jax.tree.map(torch.from_numpy, params)
    for _ in range(4):
        rp, ropt, rm = RA.apply_updates(rp, grads, ropt, ocfg)
        pp, popt, pm = PA.apply_updates(pp, jax.tree.map(torch.from_numpy,
                                                         grads), popt, pocfg)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert float(pm["lr"]) == float(rm["lr"])
        for g, w in zip(jax.tree.leaves(jax.tree.map(np.asarray, pp)),
                        jax.tree.leaves(rp)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-6)
    assert popt.step.dtype == torch.int32 and int(popt.step) == 4


# ------------------------------------------------------- compression --

def test_compress_round_trip_matches_reference():
    rng = np.random.default_rng(4)
    grads = {"w": rng.normal(0, 1, (6, 9)).astype(np.float32),
             "v": rng.normal(0, 1e-3, (11,)).astype(np.float32)}
    res = jax.tree.map(lambda g: rng.normal(0, 1e-2, g.shape).astype(
        np.float32), grads)
    tg = jax.tree.map(torch.from_numpy, grads)
    tr = jax.tree.map(torch.from_numpy, res)
    q, s, r = RC.compress(grads, res)
    pq, ps, pr = PC.compress(tg, tr)
    for k in grads:
        np.testing.assert_array_equal(pq[k].numpy(), np.asarray(q[k]))
        assert pq[k].dtype == torch.int8
        assert float(ps[k]) == float(s[k])
        np.testing.assert_allclose(pr[k].numpy(), np.asarray(r[k]),
                                   atol=1e-7)
    dec, res2 = RC.compressed_psum(grads, res)
    pdec, pres2 = PC.compressed_psum(tg, tr)
    for k in grads:
        np.testing.assert_allclose(pdec[k].numpy(), np.asarray(dec[k]),
                                   atol=1e-7)
        np.testing.assert_allclose(pres2[k].numpy(), np.asarray(res2[k]),
                                   atol=1e-7)
    zero = PC.init_residual(tg)
    assert all(not z.any() and z.dtype == torch.float32
               for z in zero.values())
    # a named axis reduces over the installed mesh's replicas
    # (tests/test_torch_sharding.py); without a mesh there is none
    with pytest.raises(ValueError, match="no installed mesh"):
        PC.compressed_psum(tg, tr, axis_name="data")


# ------------------------------------------------------ chunked_scan --

@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_scan_matches_reference(chunk):
    rng = np.random.default_rng(5)
    xs = (rng.normal(0, 1, (12, 3)).astype(np.float32),
          rng.uniform(0.5, 1, (12, 3)).astype(np.float32))
    init = rng.normal(0, 1, (3,)).astype(np.float32)

    def jf(c, x):
        return c * x[1] + jnp.tanh(x[0]), c * x[0]

    def tf(c, x):
        return c * x[1] + torch.tanh(x[0]), c * x[0]

    def jloss(init, xs):
        c, ys = RS.chunked_scan(jf, init, xs, chunk=chunk if chunk < 12
                                else 12)
        return jnp.sum(c) + jnp.sum(ys ** 2), (c, ys)

    (_, (wc, wys)), wg = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(init, xs)
    ti = torch.from_numpy(init).requires_grad_()
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    c, ys = PS.chunked_scan(tf, ti, txs, chunk=chunk if chunk < 12 else 12)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(wc), atol=1e-5)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(wys),
                               atol=1e-5)
    g = torch.autograd.grad(c.sum() + (ys ** 2).sum(), (ti, *txs))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(wg[0]), atol=1e-5)
    for a, b in zip(g[1:], wg[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ---------------------------------------------------- abstract shapes --

@pytest.mark.parametrize("arch", ARCHS + ["gemma3-4b"])
def test_abstract_shapes_match_reference(arch):
    cfg, pcfg = _configs(arch, dtype="bfloat16")
    want = RM.abstract_params(cfg)
    got = PM.abstract_params(pcfg)
    leaves = flatten(convert.to_reference(got, pcfg))
    assert all(x.device.type == "meta" for x in leaves)
    ref = jax.tree.leaves(want)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in ref]
    assert [str(x.dtype).removeprefix("torch.") for x in leaves] == \
        [str(x.dtype) for x in ref]
    opt = PM.abstract_opt(got)
    ropt = RM.abstract_opt(want)
    assert [tuple(x.shape) for x in flatten(convert.opt_to_reference(
        opt, pcfg))] == [x.shape for x in jax.tree.leaves(ropt)]
    shapes = PM.make_train_batch_shapes(pcfg, 8, 32)
    rshapes = RM.make_train_batch_shapes(cfg, 8, 32)
    for k in rshapes:
        assert tuple(shapes[k].shape) == rshapes[k].shape
        assert str(shapes[k].dtype).removeprefix("torch.") == \
            str(rshapes[k].dtype)
