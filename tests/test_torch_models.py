"""The port's models against the reference on the CPU: reduced qwen3-14b
(dense GQA, qk-norm), rwkv6-7b (the linear-scan recurrence), gemma3-4b
(sliding windows; 6 layers so that the 6th is global), deepseek-moe-16b
and qwen3-moe-30b-a3b (MoE; the ``vsn`` dispatch on one expert shard
and, against the reference's shard body, on 2 and 4; shared experts in
deepseek) and hymba-1.5b (hybrid: attention and SSM heads in parallel,
the SSM's recurrence through the linear-scan kernel), with the
reference's own parameters carried across by ``convert.from_reference``.

``forward``, ``prefill_with_cache`` and several ``decode_step``s agree
with the reference's logits within 1e-4 in float32, with equal greedy
tokens.  At the configs' own bfloat16 both sides are fed the reference's
tokens and agree within 4e-2 on logits of magnitude < 1: the reference
rounds attention logits to bfloat16 (its einsums return bfloat16) where
the kernel keeps them in float32, and XLA fuses elementwise chains in
float32 where PyTorch rounds each operation, so the two differ by a few
bfloat16 ulps (measured up to 1.3e-2).  The MoE archs' ``vsn`` dispatch
rounds its expert sum to bfloat16 even in float32 (the reference's
cross-shard sum dtype), so a float32 rounding difference upstream now and
then moves one MoE output by a bfloat16 ulp: their float32 logits agree
within ``MOE_F32_LOGITS_ATOL`` and their caches within
``MOE_F32_CACHE_ATOL`` (measured up to 1.2e-4 on the logits and 6.5e-4 on
the keys after a prefill), with equal greedy tokens; ``moe_forward`` alone
agrees within 1e-5.  A port that left the bfloat16 rounding out differs
by 3.8e-4 to 9.1e-4 on every logits case and 3.6e-3 to 5.7e-3 on the
caches, past both limits."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import canon, get_config, reduced
from repro.models import model as RM, transformer as RT
from repro_torch import configs as pconfigs
from repro_torch.models import convert, model as PM, moe as PMOE
from repro_torch.models import transformer as PT

ARCHS = ["qwen3-14b", "rwkv6-7b", "gemma3-4b", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b", "hymba-1.5b"]
BF16_ATOL = 4e-2
MOE_F32_LOGITS_ATOL = 3e-4
MOE_F32_CACHE_ATOL = 1.5e-3
S, MAX_SEQ, N_DECODE = 12, 24, 4


def _configs(arch, dtype=None):
    cfg = reduced(get_config(canon(arch)))
    pcfg = pconfigs.reduced(pconfigs.get_config(pconfigs.canon(arch)))
    upd = {} if dtype is None else {"dtype": dtype}
    if arch.startswith("gemma3"):
        upd["n_layers"] = 6
    return (dataclasses.replace(cfg, **upd),
            dataclasses.replace(pcfg, **upd))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """The reference's parameters and the port's copy of them."""
    cfg, pcfg = _configs(arch, dtype)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    return cfg, params, pcfg, pp


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return _pair(*request.param)


def _named(tree):
    """Caches or states as a dict of leaves (the hybrid's SSM state is
    one array)."""
    if tree is None or isinstance(tree, dict):
        return tree or {}
    return {"ssm_state": tree}


def _logits_close(want, got, dtype, kind="dense"):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(
            got, want, atol=MOE_F32_LOGITS_ATOL if kind == "moe" else 1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)


def test_configs_are_the_references():
    from repro.configs import ARCHS as REF_ARCHS
    assert pconfigs.ARCHS == REF_ARCHS
    for arch in REF_ARCHS:
        a, b = get_config(arch), pconfigs.get_config(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
        assert dataclasses.asdict(reduced(a)) == \
            dataclasses.asdict(pconfigs.reduced(b)), arch
        assert a.param_count() == b.param_count()


def test_forward_matches_reference(pair):
    cfg, params, pcfg, pp = pair
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, S))
    want, _, _, _ = RT.forward(params, cfg, jnp.asarray(toks, jnp.int32),
                               jnp.arange(S))
    got, _, _, _ = PT.forward(pp, pcfg, torch.from_numpy(toks),
                              torch.arange(S))
    _logits_close(want, got, cfg.dtype, cfg.kind)
    last = PM.prefill_step(pp, torch.from_numpy(toks), cfg=pcfg)
    _logits_close(RM.prefill_step(params, jnp.asarray(toks, jnp.int32),
                                  cfg=cfg), last, cfg.dtype, cfg.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_references_slot_pool(arch):
    """The reference fills a 3-slot pool (prefill into slots 0 and 2);
    ``from_reference_caches`` hands that pool to the port, and one decode
    step over lanes 2 and 0 from it gives the reference's logits
    (float32) as its serving engine computes them: each lane alone (its
    per-lane ``vmap``), so an MoE's capacity is a lane's, not shared."""
    cfg, params, pcfg, pp = _pair(arch, "float32")
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (2, S))
    rc, rs = RT.init_caches(cfg, 3, MAX_SEQ)
    for slot, row in ((0, 0), (2, 1)):
        c1 = jax.tree.map(lambda a: a[:, slot:slot + 1], rc)
        s1 = jax.tree.map(lambda a: a[:, slot:slot + 1], rs)
        _, c1, s1 = RM.prefill_with_cache(
            params, jnp.asarray(toks[row:row + 1], jnp.int32), c1, s1,
            cfg=cfg)
        rc = jax.tree.map(lambda a, b: a.at[:, slot:slot + 1].set(b), rc, c1)
        rs = jax.tree.map(lambda a, b: a.at[:, slot:slot + 1].set(b), rs, s1)
    pc, ps = convert.from_reference_caches(
        jax.tree.map(np.asarray, rc), jax.tree.map(np.asarray, rs), "cpu")
    tok = np.array([5, 7], np.int32)
    lanes = np.array([2, 0])
    want = np.concatenate([np.asarray(RM.decode_step(
        params, jax.tree.map(lambda a: a[:, [lane]], rc),
        jax.tree.map(lambda a: a[:, [lane]], rs), jnp.asarray(tok[[i]]),
        jnp.int32(S), cfg=cfg)[0]) for i, lane in enumerate(lanes)])
    got, _, _ = PM.decode_step(pp, pc, ps, torch.from_numpy(tok).long(),
                               torch.tensor([S, S]), cfg=pcfg,
                               lanes=torch.from_numpy(lanes))
    _logits_close(want, got, "float32", cfg.kind)


def test_prefill_and_decode_match_reference(pair):
    """Prefill into fresh caches, then ``N_DECODE`` single-token steps.  In
    float32 each side feeds its own argmax, which must agree, and the
    caches/states end equal within 1e-4; in bfloat16 both take the
    reference's tokens and the logits are compared."""
    cfg, params, pcfg, pp = pair
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, S))
    rc, rs = RT.init_caches(cfg, 2, MAX_SEQ)
    pc, ps = PT.init_caches(pcfg, 2, MAX_SEQ, "cpu")
    want, rc, rs = RM.prefill_with_cache(params, jnp.asarray(toks, jnp.int32),
                                         rc, rs, cfg=cfg)
    got, pc, ps = PM.prefill_with_cache(pp, torch.from_numpy(toks), pc, ps,
                                        cfg=pcfg)
    for step in range(N_DECODE + 1):
        _logits_close(want, got, cfg.dtype, cfg.kind)
        if step == N_DECODE:
            break
        tok = np.asarray(jnp.argmax(want, axis=-1))
        want, rc, rs = RM.decode_step(params, rc, rs,
                                      jnp.asarray(tok, jnp.int32),
                                      jnp.int32(S + step), cfg=cfg)
        got, pc, ps = PM.decode_step(pp, pc, ps, torch.tensor(tok),
                                     S + step, cfg=pcfg)
    if cfg.dtype != "float32":
        return            # bfloat16 rounding differences accumulate in state
    for ref_tree, port_tree in ((rc, pc), (rs, ps)):
        assert (ref_tree is None) == (port_tree is None)
        ref_tree, port_tree = _named(ref_tree), _named(port_tree)
        assert set(ref_tree) == set(port_tree)
        for name in ref_tree:
            np.testing.assert_allclose(
                port_tree[name].numpy(), np.asarray(ref_tree[name]),
                atol=MOE_F32_CACHE_ATOL if cfg.kind == "moe" else 1e-4,
                err_msg=name)


def test_per_lane_positions_and_lanes_equal_one_lane_at_a_time():
    """A decode batch whose lanes sit at different depths of a slot pool
    (``lanes``) gives each lane what a batch-1 decode at its own depth
    gives (float32)."""
    _, pcfg = _configs("qwen3-14b", "float32")
    pp = PT.init_params(pcfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, pcfg.vocab, n) for n in (3, 7, 5)]
    pool_c, _ = PT.init_caches(pcfg, 5, MAX_SEQ, "cpu")
    slots = [4, 0, 2]
    singles, firsts = [], []
    for p, slot in zip(prompts, slots):
        c, _ = PT.init_caches(pcfg, 1, MAX_SEQ, "cpu")
        lg, c, _ = PM.prefill_with_cache(pp, torch.from_numpy(p[None]), c,
                                         None, cfg=pcfg)
        PM.prefill_with_cache(pp, torch.from_numpy(p[None]), pool_c, None,
                              cfg=pcfg, lanes=torch.tensor([slot]))
        tok = lg.argmax(-1)
        lg, c, _ = PM.decode_step(pp, c, None, tok, len(p), cfg=pcfg)
        singles.append(lg[0])
        firsts.append(int(tok))
    lg, _, _ = PM.decode_step(pp, pool_c, None, torch.tensor(firsts),
                              torch.tensor([len(p) for p in prompts]),
                              cfg=pcfg, lanes=torch.tensor(slots))
    torch.testing.assert_close(lg, torch.stack(singles), atol=1e-5,
                               rtol=1e-5)


def test_hoisted_cache_index_leaves_the_logits_unchanged(monkeypatch):
    """``forward`` makes the cached attention's index tensors (cache rows,
    positions, q_offset per lane, kv_index) once and hands them to every
    layer.  One decode step over lanes 2 and 0 of the reference's slot
    pool gives the reference's logits within 1e-4 (float32), and exactly
    what it gives with q_offset per (lane, head) row, as each layer made
    it before."""
    from repro_torch.models import attention as PA
    cfg, params, pcfg, pp = _pair("qwen3-14b", "float32")
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, S))
    rc, rs = RT.init_caches(cfg, 3, MAX_SEQ)
    for slot, row in ((0, 0), (2, 1)):
        c1 = jax.tree.map(lambda a: a[:, slot:slot + 1], rc)
        _, c1, _ = RM.prefill_with_cache(
            params, jnp.asarray(toks[row:row + 1], jnp.int32), c1, None,
            cfg=cfg)
        rc = jax.tree.map(lambda a, b: a.at[:, slot:slot + 1].set(b), rc, c1)
    tok = np.array([5, 7], np.int32)
    lanes = np.array([2, 0])
    want, _, _ = RM.decode_step(params,
                                jax.tree.map(lambda a: a[:, lanes], rc),
                                rs, jnp.asarray(tok), jnp.int32(S), cfg=cfg)

    def step():
        pc, ps = convert.from_reference_caches(
            jax.tree.map(np.asarray, rc), None, "cpu")
        got, _, _ = PM.decode_step(pp, pc, ps, torch.from_numpy(tok).long(),
                                   torch.tensor([S, S]), cfg=pcfg,
                                   lanes=torch.from_numpy(lanes))
        return got

    calls = []
    made = PA.cache_index
    monkeypatch.setattr(PA, "cache_index",
                        lambda *a: calls.append(1) or made(*a))
    hoisted = step()
    assert len(calls) == 1
    _logits_close(want, hoisted, "float32")
    attn = PA.attn_forward

    def per_head_rows(*a, index=None, **kw):
        rows, pos, q_offset, kv_index = index
        per_row = q_offset.repeat_interleave(pcfg.n_heads)
        return attn(*a, index=(rows, pos, per_row, kv_index), **kw)
    monkeypatch.setattr(PA, "attn_forward", per_head_rows)
    torch.testing.assert_close(hoisted, step(), rtol=0, atol=0)


def test_embedding_stub_frontend_matches_reference():
    """``frontend="embedding_stub"`` (chameleon-34b: qk-norm, dense) takes
    precomputed embeddings instead of tokens."""
    cfg, pcfg = _configs("chameleon-34b", "float32")
    params = RT.init_params(jax.random.PRNGKey(2), cfg)
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    x = np.random.default_rng(2).normal(0, 1, (2, S, cfg.d_model))
    x = x.astype(np.float32)
    want, _, _, _ = RT.forward(params, cfg, jnp.asarray(x), jnp.arange(S))
    got, _, _, _ = PT.forward(pp, pcfg, torch.from_numpy(x), torch.arange(S))
    _logits_close(want, got, "float32")


def test_layer_windows_match_reference():
    for arch in ("gemma3-4b", "gemma3-12b", "qwen3-14b"):
        cfg = get_config(arch)
        want = RT.layer_windows(cfg)
        got = PT.layer_windows(pconfigs.get_config(arch))
        if want is None:
            assert got is None
        else:
            assert got == np.asarray(want).tolist()


def test_init_params_on_the_device_has_the_references_shapes():
    """The port's own initializer (a seeded ``torch.Generator``): the
    reference's tree of shapes and dtypes, its scales, and the same draw
    for the same seed (different bits from JAX's, by design)."""
    for arch in ("qwen3-14b", "rwkv6-7b", "hymba-1.5b"):
        cfg, pcfg = _configs(arch)
        ref = jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(0),
                                                      cfg))
        ref = convert.from_reference(ref, pcfg, "cpu")
        a = PT.init_params(pcfg, seed=7, device="cpu")
        b = PT.init_params(pcfg, seed=7, device="cpu")
        flat = lambda t: jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda x: (tuple(x.shape), x.dtype), t,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)),
            is_leaf=lambda x: isinstance(x, tuple))[0]
        assert flat(a) == flat(ref)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert torch.equal(x, y)
        wq = a["layers"][0].get("attn", a["layers"][0].get("tm"))
        w = next(iter(v for k, v in wq.items() if k in ("wq", "w_r")))
        assert abs(float(w.float().std()) * pcfg.d_model ** 0.5 - 1) < 0.1
        assert abs(float(a["embedding"].float().std()) / 0.02 - 1) < 0.1


# ------------------------------------------------------------------ MoE --
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]


def _moe_pair(arch, dispatch, cf):
    from repro.models import moe as RMOE
    cfg, pcfg = _configs(arch, "float32")
    upd = dict(dispatch=dispatch, **({} if cf is None
                                     else {"capacity_factor": cf}))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **upd))
    pcfg = dataclasses.replace(pcfg,
                               moe=dataclasses.replace(pcfg.moe, **upd))
    p = RMOE.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return RMOE, cfg, p, pcfg, pp


@pytest.mark.parametrize("cf", [None, 8.0], ids=["drops", "ample"])
@pytest.mark.parametrize("dispatch", ["sn", "vsn"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, dispatch, cf):
    """``moe_forward`` for both dispatches against the reference's: the
    configs' capacity factor drops tokens (counted alike), a factor of 8
    drops none; outputs within 1e-5 (float32)."""
    RMOE, cfg, p, pcfg, pp = _moe_pair(arch, dispatch, cf)
    x = np.random.default_rng(0).normal(size=(2, 12, cfg.d_model))
    x = x.astype(np.float32)
    want, wd = RMOE.moe_forward(p, jnp.asarray(x), cfg)
    got, gd = PMOE.moe_forward(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert int(gd) == int(wd)
    assert (int(wd) > 0) == (cf is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_vsn_moe_over_expert_shards_matches_reference(arch, n, dtype):
    """The ``vsn`` dispatch over n expert shards against the reference's
    ``_vsn_body`` under ``jax.vmap(..., axis_name="model")`` (its
    ``psum``s over n shards on one CPU device), 32 tokens at the
    configs' capacity factor, ``dropped`` equal.  Float32 weights: equal
    bit for bit (the bfloat16 partials added in shard order, each sum
    rounded, as XLA adds the reference's bfloat16 ``psum``; a float32 sum
    rounded once differs).  bfloat16 weights: within ``BF16_ATOL`` (the
    expert products round differently on the two sides, as in the model
    tests; measured up to 1.2e-2).  The same through ``moe_forward``
    under a host mesh of n model shards (the shared experts added); and
    n shards differ from one."""
    RMOE, cfg, p, pcfg, pp = _moe_pair(arch, "vsn", None)
    jdt = getattr(jnp, dtype)
    p = {k: (v if k == "router" else v.astype(jdt)) for k, v in p.items()}
    pp = {k: (v if k == "router" else v.to(getattr(torch, dtype)))
          for k, v in pp.items()}
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model))
    x = jnp.asarray(x.astype(np.float32)).astype(jdt)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    e = cfg.moe.n_experts
    split = lambda w: w.reshape((n, e // n) + w.shape[1:])
    body = jax.vmap(functools.partial(RMOE._vsn_body, cfg=cfg, axis="model",
                                      n_shards=n),
                    in_axes=(None, None, 0, 0, 0), axis_name="model")
    want, wdrop = body(x.reshape(-1, cfg.d_model), p["router"],
                       split(p["wg"]), split(p["wu"]), split(p["wd"]))
    got, gdrop = PMOE._vsn_moe(pp, tx.reshape(1, -1, cfg.d_model), pcfg, n)
    want = np.asarray(want[0].astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(got[0].float().numpy(), want)
    else:
        np.testing.assert_allclose(got[0].float().numpy(), want,
                                   atol=BF16_ATOL)
    assert int(gdrop.sum()) == int(wdrop[0])
    one, _ = PMOE._vsn_moe(pp, tx.reshape(1, -1, cfg.d_model), pcfg, 1)
    assert not torch.equal(one, got)

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    with sharding.use_rules(make_host_mesh(1, n, "cpu")):
        y, dropped = PMOE.moe_forward(pp, tx, pcfg)
    shared = sum(k.startswith("shared") for k in pp)
    ref = got[0].to(tx.dtype).reshape(tx.shape)
    if shared:
        ref = ref.reshape(-1, cfg.d_model) + PMOE.swiglu(
            tx.reshape(-1, cfg.d_model), pp["shared_wg"], pp["shared_wu"],
            pp["shared_wd"])
    assert torch.equal(y, ref.reshape(tx.shape))
    assert int(dropped) == int(wdrop[0])


def test_vsn_expert_slices_move_to_another_device_once():
    """A shard on another device than its weights gets a copy of its
    expert slice made once and kept with the weight (``_on``); on the
    weight's own device, a view."""
    w = torch.randn(8, 4, 3)
    assert PMOE._on(w, w.device, 2, 2).data_ptr() == w[2].data_ptr()
    meta = torch.device("meta")
    a = PMOE._on(w, meta, 4, 2)
    assert a.device == meta and a.shape == (2, 4, 3)
    assert PMOE._on(w, meta, 4, 2) is a
    assert PMOE._on(w, meta, 0, 2) is not a
    assert PMOE._on(w, meta) is PMOE._on(w, meta)


def test_moe_route_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: ``jax.lax.top_k``'s order (lower index
    first), which ``torch.topk`` does not promise."""
    from repro.models import moe as RMOE
    router = np.zeros((4, 8), np.float32)
    router[:, 5] = 1.0
    x = np.ones((3, 4), np.float32)
    x[1] = 0.0                                         # all 8 tie
    jw, ji = RMOE._route(jnp.asarray(x), jnp.asarray(router), 3)
    pw, pi = PMOE._route(torch.from_numpy(x), torch.from_numpy(router), 3)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-7)
    assert pi[1].tolist() == [0, 1, 2]


def test_moe_vsn_equals_sn_with_headroom():
    """``tests/test_substrate.py``'s check on the port: with capacity far
    above the load both dispatchers compute the same function (to the
    vsn sum's bfloat16 rounding)."""
    from repro_torch.models.config import ModelConfig, MoEConfig

    def cfg(dispatch):
        return ModelConfig(
            name="moe-test", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, vocab=64, kind="moe", dtype="float32",
            moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1,
                          dispatch=dispatch, capacity_factor=8.0))
    p = PMOE.init_moe(torch.Generator().manual_seed(1), cfg("vsn"),
                      torch.float32, "cpu")
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(2))
    yv, dv = PMOE.moe_forward(p, x, cfg("vsn"))
    ys, ds = PMOE.moe_forward(p, x, cfg("sn"))
    assert int(dv) == 0 and int(ds) == 0
    np.testing.assert_allclose(yv.numpy(), ys.numpy(), atol=3e-2, rtol=1e-2)
    assert not torch.equal(yv, ys)          # the vsn sum's bf16 rounding


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_routes_each_lane_alone(arch):
    """A decode over lanes at mixed depths of a slot pool gives each lane
    what a batch-1 decode gives (float32): with all lanes in one group the
    capacity (1 an expert at the configs' factor) drops tokens where two
    lanes pick one expert, and the logits differ."""
    _, pcfg = _configs(arch, "float32")
    pp = PT.init_params(pcfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, pcfg.vocab, n) for n in (3, 7, 5, 4)]
    pool_c, _ = PT.init_caches(pcfg, 6, MAX_SEQ, "cpu")
    slots = [4, 0, 2, 5]
    singles, firsts = [], []
    for p, slot in zip(prompts, slots):
        c, _ = PT.init_caches(pcfg, 1, MAX_SEQ, "cpu")
        lg, c, _ = PM.prefill_with_cache(pp, torch.from_numpy(p[None]), c,
                                         None, cfg=pcfg)
        PM.prefill_with_cache(pp, torch.from_numpy(p[None]), pool_c, None,
                              cfg=pcfg, lanes=torch.tensor([slot]))
        tok = lg.argmax(-1)
        lg, c, _ = PM.decode_step(pp, c, None, tok, len(p), cfg=pcfg)
        singles.append(lg[0])
        firsts.append(int(tok))
    pos = torch.tensor([len(p) for p in prompts])
    lg, _, _, dropped = PM.decode_step(
        pp, pool_c, None, torch.tensor(firsts), pos, cfg=pcfg,
        lanes=torch.tensor(slots), with_aux=True)
    torch.testing.assert_close(lg, torch.stack(singles), atol=1e-5,
                               rtol=1e-5)
    assert float(dropped) == 0.0
    shared_c, _ = PT.init_caches(pcfg, 6, MAX_SEQ, "cpu")
    for p, slot in zip(prompts, slots):
        PM.prefill_with_cache(pp, torch.from_numpy(p[None]), shared_c, None,
                              cfg=pcfg, lanes=torch.tensor([slot]))
    one_group = [{k: v[:, slots] for k, v in shared_c.items()}, None]
    lg1, _, _, dropped1 = PM.decode_step(
        pp, one_group[0], None, torch.tensor(firsts), pos, cfg=pcfg,
        with_aux=True)
    assert float(dropped1) > 0 and not torch.allclose(lg1, lg, atol=1e-3)


@pytest.mark.parametrize("dispatch", ["sn", "vsn"])
def test_moe_counts_the_drops_of_live_rows_only(dispatch):
    """Routed per row, the rows ``live`` leaves out (the serving engine's
    pad lanes) still compute but add nothing to ``dropped``: the count is
    the live rows' own, each row's as it drops alone, and the outputs are
    those of the unmasked call."""
    _, _, _, pcfg, pp = _moe_pair("deepseek-moe-16b", dispatch, None)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 12, pcfg.d_model)).astype(np.float32))
    live = torch.tensor([True, False, True])
    y_all, d_all = PMOE.moe_forward(pp, x, pcfg, per_row=True)
    y, d = PMOE.moe_forward(pp, x, pcfg, per_row=True, live=live)
    alone = [int(PMOE.moe_forward(pp, x[i:i + 1], pcfg, per_row=True)[1])
             for i in range(3)]
    assert min(alone) > 0 and int(d_all) == sum(alone)
    assert int(d) == alone[0] + alone[2]
    assert torch.equal(y, y_all)
    with pytest.raises(ValueError, match="per_row"):
        PMOE.moe_forward(pp, x, pcfg, live=live)
