"""The port's core modules on the CPU against the JAX reference: the same
numpy inputs through ``repro`` and ``repro_torch``, compared exactly
(values and dtypes).  The reference's kernels run on its ``xla`` backend
(the CPU default); the port's run their plain versions."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_bridge import assert_tree_equal, np_tree, to_port
from repro.core import aggregate as JA
from repro.core import join as JJ
from repro.core import scalegate as JSG
from repro.core import tuples as JT
from repro.core import watermark as JW
from repro.core.operator import tick as j_tick
from repro.core.windows import WindowSpec as JWS
from repro.data import datagen as jdg
from repro_torch.core import aggregate as PA
from repro_torch.core import join as PJ
from repro_torch.core import scalegate as PSG
from repro_torch.core import tuples as PT
from repro_torch.core import watermark as PW
from repro_torch.core.operator import tick as p_tick
from repro_torch.core.vsn import stack
from repro_torch.core.windows import WindowSpec as PWS
from repro_torch.data import datagen as pdg
from repro_torch.io.sinks import flatten_outputs

CPU = "cpu"


# ---------------------------------------------------------------- data model
@pytest.mark.parametrize("gen,kw", [
    ("tweets", dict(n_ticks=3, tick=20, words_per_tweet=5, vocab=400,
                    k_virt=64)),
    ("tweets", dict(n_ticks=3, tick=20, words_per_tweet=5, vocab=400,
                    k_virt=64, mode="paircount", pair_dist=3)),
    ("tweets", dict(n_ticks=2, tick=20, words_per_tweet=4, vocab=400,
                    k_virt=64, n_sources=3)),
    ("scalejoin", dict(n_ticks=3, tick=20, k_virt=1)),
])
def test_datagen_streams_are_field_for_field_equal(gen, kw):
    jb = list(getattr(jdg, gen)(np.random.default_rng(5), **kw))
    pb = list(getattr(pdg, gen)(np.random.default_rng(5), device=CPU, **kw))
    assert len(jb) == len(pb)
    for a, b in zip(jb, pb):
        assert_tree_equal(np_tree(a), np_tree(b))


def test_watermark_operations_match_reference():
    j = JW.init_watermark(4)
    p = PW.init_watermark(4, device=CPU)
    rng = np.random.default_rng(0)
    for step in range(6):
        src = rng.integers(0, 5, 9).astype(np.int32)      # 4 is out of range
        tau = rng.integers(-3, 50, 9).astype(np.int32)
        valid = rng.random(9) < 0.8
        j = JW.observe(j, jnp.asarray(src), jnp.asarray(tau),
                       jnp.asarray(valid))
        p = PW.observe(p, torch.from_numpy(src), torch.from_numpy(tau),
                       torch.from_numpy(valid))
        mask = rng.random(4) < 0.5
        if step == 2:
            j, p = JW.remove_sources(j, mask), PW.remove_sources(
                p, torch.from_numpy(mask))
        if step == 3:
            j = JW.add_sources(j, mask, 7)
            p = PW.add_sources(p, torch.from_numpy(mask), 7)
        if step == 4:
            j = JW.clamp_frontier(j, mask, 5)
            p = PW.clamp_frontier(p, torch.from_numpy(mask), 5)
        if step == 5:
            vals = rng.integers(0, 90, 4).astype(np.int32)
            j = JW.observe_explicit(j, vals, mask)
            p = PW.observe_explicit(p, vals, torch.from_numpy(mask))
        assert_tree_equal(np_tree(j), np_tree(p))
        assert int(j.value()) == int(p.value())
    assert_tree_equal(JW.export_np(j), PW.export_np(p))
    assert_tree_equal(np_tree(p), np_tree(PW.import_np(PW.export_np(p), CPU)))


# ---------------------------------------------------------------- ScaleGate
def _source_stream(rng, n_ticks, tick, n_sources, kmax=2, p=2):
    """Per-source timestamp-sorted ticks with padding lanes."""
    fronts = np.zeros(n_sources, np.int64)
    for _ in range(n_ticks):
        src = rng.integers(0, n_sources, tick).astype(np.int32)
        tau = np.zeros(tick, np.int32)
        for s in range(n_sources):
            sel = src == s
            tau[sel] = np.sort(fronts[s] + rng.integers(0, 15, sel.sum()))
            if sel.any():
                fronts[s] = tau[sel].max()
        yield JT.make_batch(
            jnp.asarray(tau), jnp.asarray(rng.uniform(0, 9, (tick, p)),
                                          jnp.float32),
            keys=jnp.asarray(rng.integers(-1, 9, (tick, kmax)), jnp.int32),
            source=jnp.asarray(src), valid=jnp.asarray(rng.random(tick) < 0.9),
            kmax=kmax)


@pytest.mark.parametrize("n_sources,cap", [(1, 16), (3, 16), (3, 4)])
def test_push_matches_reference_tick_by_tick(n_sources, cap):
    """Ready batch, stash, frontier and overflow equal per tick; cap=4
    overflows the stash (a slow source holds W back)."""
    rng = np.random.default_rng(n_sources * 10 + cap)
    js = JSG.init_scalegate(n_sources, cap, 2, 2)
    ps = PSG.init_scalegate(n_sources, cap, 2, 2, device=CPU)
    for b in _source_stream(rng, 6, 12, n_sources):
        js, jout = JSG.push(js, b, backend="xla")
        ps, pout = PSG.push(ps, to_port(b))
        assert_tree_equal(np_tree(jout), np_tree(pout))
        assert_tree_equal(np_tree(js), np_tree(ps))
    if cap == 4:
        assert int(ps.overflow) > 0
    assert_tree_equal(JSG.export_np(js), PSG.export_np(ps))
    assert_tree_equal(np_tree(ps), np_tree(PSG.import_np(PSG.export_np(ps),
                                                         CPU)))


def test_merge_order_cpu_contract_is_the_reference_xla_contract():
    assert PSG.tie_break(CPU) == JSG.TIE_BREAK["xla"]
    assert PSG.tie_break("cuda") == JSG.TIE_BREAK["pallas"]
    keep = torch.tensor([False, True, True, False, True, False])
    np.testing.assert_array_equal(
        PSG.stable_partition(keep).numpy(),
        torch.argsort(~keep, stable=True).numpy())


# ---------------------------------------------------------------- aggregate
def _agg_stream(rng, n_ticks=3, tick=10, k=8, kmax=3, width=1):
    tau0 = 0
    for _ in range(n_ticks):
        taus = np.sort(tau0 + rng.integers(0, 8, tick)).astype(np.int32)
        tau0 = int(taus.max()) + 1
        keys = rng.integers(0, k, (tick, kmax)).astype(np.int32)
        keys[rng.random((tick, kmax)) < 0.25] = -1
        yield JT.make_batch(
            jnp.asarray(taus),
            jnp.asarray(rng.integers(0, 5, (tick, width)), jnp.float32),
            keys=jnp.asarray(keys), valid=jnp.asarray(rng.random(tick) > 0.15),
            kmax=kmax)


def _ops(kind, k, **kw):
    if kind == "sum":      # integer-valued payloads: exact under reordering
        return tuple(m.reduce_aggregate(
            ws(10, 20, "multi"), k, f_r=lambda acc, pay: acc + pay[..., :1],
            init_val=0.0, **kw) for m, ws in ((JA, JWS), (PA, PWS)))
    mk = {"count": "count_aggregate", "max": "longest_aggregate"}[kind]
    return (getattr(JA, mk)(JWS(10, 20, "multi"), k, **kw),
            getattr(PA, mk)(PWS(10, 20, "multi"), k, **kw))


@pytest.mark.parametrize("kind", ["count", "sum", "max"])
def test_aggregate_tick_fast_matches_reference(kind):
    """Outputs buffers and state equal tick by tick under a partial
    responsibility mask.  ``slot_l`` is left out: the reference writes it
    with a scatter whose duplicate indices carry different values, so its
    value depends on XLA's update order."""
    k = 16
    jop, pop = _ops(kind, k, out_cap=128, extra_slots=2)
    jop, pop = jop.resolved(), pop.resolved()
    resp = np.arange(k) % 3 != 1
    js, ps = JA.fast_init(jop), PA.fast_init(pop, CPU)
    for b in _agg_stream(np.random.default_rng(4), k=k):
        js, jo = JA.tick_fast(jop, kind, js, b, jnp.asarray(resp),
                              backend="xla")
        ps, po = PA.tick_fast(pop, kind, ps, to_port(b), torch.from_numpy(resp))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps), skip=("slot_l",))


def test_two_instances_leave_the_shared_acc_untouched():
    """Two VSN instances tick from one ``FastAggState`` (``run_tick``): the
    shared ``zeta["acc"]`` is unchanged afterwards and the merged state
    and outputs equal the reference's, so no instance writes another's
    input (the aggregate kernel is out-of-place; nothing clones ``acc``)."""
    from repro.core.vsn import merge_fast_state as j_merge
    from repro.core.vsn import run_tick as j_run_tick
    from repro_torch.core.vsn import merge_fast_state as p_merge
    from repro_torch.core.vsn import run_tick as p_run_tick
    k = 16
    jop, pop = _ops("count", k, out_cap=128, extra_slots=2)
    jop, pop = jop.resolved(), pop.resolved()
    fmu = (np.arange(k) % 2).astype(np.int32)
    active = np.ones(2, bool)
    js, ps = JA.fast_init(jop), PA.fast_init(pop, CPU)
    for b in _agg_stream(np.random.default_rng(5), k=k):
        shared = ps.op_state.zeta["acc"]
        before = shared.clone()
        js, jo = j_run_tick(
            jop, js, b, jnp.asarray(fmu), jnp.asarray(active),
            tick_fn=lambda o, s, r, m, explicit_w=None: JA.tick_fast(
                o, "count", s, r, m, backend="xla"), merge_fn=j_merge)
        ps, po = p_run_tick(
            pop, ps, to_port(b), torch.from_numpy(fmu),
            torch.from_numpy(active),
            tick_fn=lambda o, s, r, m, explicit_w=None: PA.tick_fast(
                o, "count", s, r, m), merge_fn=p_merge)
        assert torch.equal(shared, before)
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps), skip=("slot_l",))
    assert ps.op_state.zeta["acc"].sum() > 0


def test_general_tick_matches_reference():
    jop, pop = _ops("count", 8, out_cap=128)
    resp = np.arange(8) < 5
    js, ps = jop.resolved().init_state(), pop.resolved().init_state(CPU)
    for b in _agg_stream(np.random.default_rng(9)):
        js, jo = j_tick(jop, js, b, jnp.asarray(resp))
        ps, po = p_tick(pop, ps, to_port(b), torch.from_numpy(resp))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps))


# The port's fast path against its own general tick: the scenarios of
# tests/test_tick_parity.py.
def _drive_both(pop, kind, batches, k):
    pop = pop.resolved()
    resp = torch.ones(k, dtype=torch.bool)
    st_g, st_f = pop.init_state(CPU), PA.fast_init(pop, CPU)
    out_g, out_f, colls = [], [], 0
    for b in batches:
        st_g, o = p_tick(pop, st_g, b, resp)
        out_g += flatten_outputs(o)
        st_f, o = PA.tick_fast(pop, kind, st_f, b, resp)
        out_f += flatten_outputs(o)
        colls += int(st_f.collisions)
    return sorted(out_g), sorted(out_f), colls, st_g, st_f


def test_fast_path_counts_a_duplicate_key_once():
    _, pop = _ops("count", 8, out_cap=128, extra_slots=2)
    b1 = PT.make_batch([5], np.zeros((1, 1)), keys=[[4, 4]], kmax=2,
                       device=CPU)
    flush = PT.make_batch([25], np.zeros((1, 1)), keys=[[-1, -1]], kmax=2,
                          device=CPU)
    out_g, out_f, colls, _, _ = _drive_both(pop, "count", [b1, flush], 8)
    assert colls == 0 and out_g == out_f
    assert out_g == [(10, (4.0, 1.0)), (20, (4.0, 1.0))]


@pytest.mark.parametrize("extra_slots", [1, 2, 3])
@pytest.mark.parametrize("kind", ["count", "max"])
def test_fast_path_equals_general_tick(extra_slots, kind):
    _, pop = _ops(kind, 8, out_cap=512, extra_slots=extra_slots)
    batches = [to_port(b) for b in _agg_stream(
        np.random.default_rng(extra_slots))]
    out_g, out_f, colls, st_g, st_f = _drive_both(pop, kind, batches, 8)
    assert colls == 0 and out_g == out_f
    torch.testing.assert_close(st_g.zeta["acc"], st_f.op_state.zeta["acc"],
                               rtol=0, atol=0)
    assert int(st_g.next_l) == int(st_f.op_state.next_l)
    assert int(st_g.watermark) == int(st_f.op_state.watermark)


def test_fast_path_ring_overrun_is_counted():
    _, pop = _ops("count", 8, out_cap=512, extra_slots=0)
    b = PT.make_batch([0, 15, 35], np.zeros((3, 1)), keys=[[0], [1], [2]],
                      device=CPU)
    assert _drive_both(pop, "count", [b], 8)[2] > 0


# ---------------------------------------------------------------- ScaleJoin
def _join_stream(n_ticks, tick):
    return list(jdg.scalejoin(np.random.default_rng(3), n_ticks=n_ticks,
                              tick=tick, k_virt=1, rate_t_per_s=400.0))


def test_join_tick_fast_matches_reference():
    """Outputs (in the reference's order) and the stored rings equal tick by
    tick; bands are wide enough to produce matches."""
    k, ring, ws = 32, 4, JWS(wa=1, ws=20_000, wt="single")
    resp = np.arange(k) % 2 == 0
    jst, pst = JJ.fast_join_init(k, ring, 4), PJ.fast_join_init(k, ring, 4,
                                                                CPU)
    pws = PWS(wa=1, ws=20_000, wt="single")
    for b in _join_stream(4, 16):
        jst, jo = JJ.tick_fast(ws, JJ.band_predicate(2500.0, 2), jst, b,
                               jnp.asarray(resp), out_cap=256)
        pst, po = PJ.tick_fast(pws, PJ.band_predicate(2500.0, 2), pst,
                               to_port(b), torch.from_numpy(resp), out_cap=256)
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(jst), np_tree(pst))
    assert int(po.count) > 0


def test_band_join_counts_match_reference():
    k, ring = 32, 4
    ws = JWS(wa=1, ws=20_000, wt="single")
    pws = PWS(wa=1, ws=20_000, wt="single")
    jst = JJ.fast_join_init(k, ring, 4)
    pst = PJ.fast_join_init(k, ring, 4, CPU)
    resp = np.ones(k, bool)
    for b in _join_stream(3, 16):
        b = dataclasses.replace(b, valid=b.valid.at[::5].set(False))
        jc, jn = JJ.band_join_counts(jst, b, ws, band=3000.0, backend="xla")
        pc, pn = PJ.band_join_counts(pst, to_port(b), pws, band=3000.0)
        np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
        assert int(jn) == int(pn)
        jst, _ = JJ.tick_fast(ws, JJ.band_predicate(), jst, b,
                              jnp.asarray(resp), out_cap=8, emit=False)
        pst, _ = PJ.tick_fast(pws, PJ.band_predicate(), pst, to_port(b),
                              torch.from_numpy(resp), out_cap=8, emit=False)
    assert int(pn) > 0 and int(pc.sum()) > 0


def test_scalejoin_general_tick_matches_reference():
    k, ring = 6, 3
    ws, pws = JWS(1, 20_000, "single"), PWS(1, 20_000, "single")
    jop = JJ.scalejoin_def(ws, k, JJ.band_predicate(6000.0), payload_width=4,
                           ring=ring, out_cap=64)
    pop = PJ.scalejoin_def(pws, k, PJ.band_predicate(6000.0), payload_width=4,
                           ring=ring, out_cap=64)
    resp = np.arange(k) < 4
    js, ps = jop.init_state(), pop.init_state(CPU)
    matches = 0
    for b in _join_stream(2, 6):
        js, jo = j_tick(jop, js, b, jnp.asarray(resp))
        ps, po = p_tick(pop, ps, to_port(b), torch.from_numpy(resp))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps))
        matches += int(po.count)
    assert matches > 0


# ------------------------------------------------- smaller ported pieces
def test_table1_defaults_match_reference():
    """An operator with no user functions gets Table 1's defaults (store
    each tuple, emit nothing, purge stale tuples on slide)."""
    from repro.core.operator import OperatorDef as JOp
    from repro.core.operator import tuple_store_init
    from repro_torch.core.operator import OperatorDef as POp
    k, ring, p = 4, 3, 2
    jop = JOp(window=JWS(10, 20, "single"), n_inputs=1, k_virt=k,
              payload_out=p, init_zeta=lambda: tuple_store_init(k, 1, ring, p),
              out_cap=16)

    def init_zeta(device):
        return {name: torch.from_numpy(np.array(a)).to(device)
                for name, a in tuple_store_init(k, 1, ring, p).items()}

    pop = POp(window=PWS(10, 20, "single"), n_inputs=1, k_virt=k,
              payload_out=p, init_zeta=init_zeta, out_cap=16)
    resp = np.arange(k) != 2
    js, ps = jop.resolved().init_state(), pop.resolved().init_state(CPU)
    for b in _agg_stream(np.random.default_rng(2), n_ticks=3, tick=6, k=k,
                         kmax=2, width=p):
        js, jo = j_tick(jop, js, b, jnp.asarray(resp), explicit_w=None)
        ps, po = p_tick(pop, ps, to_port(b), torch.from_numpy(resp))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps))
    assert int((ps.zeta["tau"] >= 0).sum()) > 0


def test_hedge_predicate_matches_reference():
    rng = np.random.default_rng(6)
    pl = rng.normal(0, 0.05, (40, 2)).astype(np.float32)
    pr = (-pl * rng.uniform(0.9, 1.1, (40, 2))).astype(np.float32)
    pl[:, 0] = rng.integers(0, 3, 40)
    pr[:, 0] = rng.integers(0, 3, 40)
    pl[::7, 1] = 0.0                                   # the 1e-9 guard
    want = np.asarray(JJ.hedge_predicate()(jnp.asarray(pl), jnp.asarray(pr)))
    got = PJ.hedge_predicate()(torch.from_numpy(pl), torch.from_numpy(pr))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.any() and not want.all()


def test_fold_frontier_and_ctrl_lanes_match_reference():
    from repro.core import runtime as JR
    from repro_torch.core import runtime as PR
    rng = np.random.default_rng(8)
    jf, pf = np.zeros(3, np.int64), np.zeros(3, np.int64)
    for b in _source_stream(rng, 3, 10, 3):
        JR.fold_frontier(jf, b, 3)
        PR.fold_frontier(pf, to_port(b), 3)
    np.testing.assert_array_equal(jf, pf)
    assert_tree_equal(np_tree(JR.ctrl_lanes(3, jf, 2, 2, 2)),
                      np_tree(PR.ctrl_lanes(3, pf, 2, 2, 2, CPU)))


def test_scalegate_sources_and_template_match_reference():
    mask = np.array([False, True, False])
    js = JSG.remove_sources(JSG.init_scalegate(3, 4, 2, 2), mask)
    ps = PSG.remove_sources(PSG.init_scalegate(3, 4, 2, 2, device=CPU),
                            torch.from_numpy(mask))
    assert_tree_equal(np_tree(js), np_tree(ps))
    js = JSG.add_sources(js, mask, 11)
    ps = PSG.add_sources(ps, torch.from_numpy(mask), 11)
    assert_tree_equal(np_tree(js), np_tree(ps))
    assert_tree_equal(JSG.template_np(3, 4, 2, 2), PSG.template_np(3, 4, 2, 2))


def test_flatten_outputs_and_collect_sink_match_reference():
    """The executors' per-instance output merge and the parity sink."""
    from repro.core.vsn import flatten_outputs as j_vflat
    from repro.io.sinks import CollectSink as JSink
    from repro_torch.core.vsn import flatten_outputs as p_vflat
    from repro_torch.io.sinks import CollectSink as PSink
    jop, pop = _ops("count", 8, out_cap=16)
    jop, pop = jop.resolved(), pop.resolved()
    jsink, psink = JSink(), PSink()
    js, ps = jop.init_state(), pop.init_state(CPU)
    for i, b in enumerate(_agg_stream(np.random.default_rng(3))):
        j_outs, p_outs = [], []
        for inst in range(2):
            resp = np.arange(8) % 2 == inst
            j_outs.append(j_tick(jop, js, b, jnp.asarray(resp))[1])
            p_outs.append(p_tick(pop, ps, to_port(b),
                                 torch.from_numpy(resp))[1])
        js = j_tick(jop, js, b, jnp.ones(8, bool))[0]
        ps = p_tick(pop, ps, to_port(b), torch.ones(8, dtype=torch.bool))[0]
        j_st = jax.tree.map(lambda *xs: jnp.stack(xs), *j_outs)
        p_st = stack(p_outs)
        assert_tree_equal(np_tree(j_vflat(j_st)), np_tree(p_vflat(p_st)))
        jsink.accept(i, j_st, j_outs[0])
        psink.accept(i, p_st, p_outs[0])
    assert psink.results() == jsink.results() and psink.results()
    assert psink.results(since_tick=1, before_tick=2) == \
        jsink.results(since_tick=1, before_tick=2)
