"""The port's pipelines on the CPU against the JAX reference pipelines:
the same stream through ``repro.core.runtime`` and ``repro_torch.core.
runtime``, with a mid-stream ``Reconfiguration`` (2 -> 4 instances).  Per
tick: the sorted output multisets, the ``switched`` flags and the
per-instance loads are equal.  On the CPU both merge with the
``(tau, source, arrival)`` order, so even ScaleJoin's ordered output
pairs agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from _torch_bridge import assert_tree_equal, np_tree, port_reconfig, to_port
from repro.core import aggregate as JA
from repro.core import join as JJ
from repro.core.controller import Reconfiguration, active_mask, balanced_fmu
from repro.core.runtime import SNPipeline as JSN
from repro.core.runtime import VSNPipeline as JVSN
from repro.core.vsn import merge_fast_state as j_merge
from repro.core.windows import WindowSpec as JWS
from repro.data import datagen as jdg
from repro.io.sinks import flatten_outputs as j_flat
from repro_torch.core import aggregate as PA
from repro_torch.core import elastic
from repro_torch.core import join as PJ
from repro_torch.core.runtime import SNPipeline as PSN
from repro_torch.core.runtime import VSNPipeline as PVSN
from repro_torch.core.vsn import merge_fast_state as p_merge
from repro_torch.core.windows import WindowSpec as PWS
from repro_torch.io.sinks import flatten_outputs as p_flat

K, N_MAX, N_TICKS, RC_AT = 64, 4, 6, 2
RC = Reconfiguration(epoch=1, n_active=4, fmu=balanced_fmu(K, 4, N_MAX),
                     active=active_mask(4, N_MAX))


def _setup(kind):
    """(reference pipeline kwargs, port pipeline kwargs, reference op, port
    op, stream) for one workload at a small size."""
    if kind == "scalejoin":
        jws, pws = JWS(1, 20_000, "single"), PWS(1, 20_000, "single")
        jfj, pfj = JJ.band_predicate(2500.0, 2), PJ.band_predicate(2500.0, 2)
        jop = JJ.scalejoin_def(jws, K, jfj, payload_width=4, ring=4,
                               out_cap=256)
        pop = PJ.scalejoin_def(pws, K, pfj, payload_width=4, ring=4,
                               out_cap=256)
        jkw = dict(tick_fn=lambda op, st, r, resp, explicit_w=None:
                   JJ.tick_fast(jws, jfj, st, r, resp, out_cap=256),
                   init_sigma=lambda: JJ.fast_join_init(K, 4, 4))
        pkw = dict(tick_fn=lambda op, st, r, resp, explicit_w=None:
                   PJ.tick_fast(pws, pfj, st, r, resp, out_cap=256),
                   init_sigma=lambda d: PJ.fast_join_init(K, 4, 4, d))
        stream = jdg.scalejoin(np.random.default_rng(3), n_ticks=N_TICKS,
                               tick=16, k_virt=1, rate_t_per_s=400.0)
    else:
        jop = JA.count_aggregate(JWS(10, 20, "multi"), K, out_cap=256,
                                 extra_slots=2)
        pop = PA.count_aggregate(PWS(10, 20, "multi"), K, out_cap=256,
                                 extra_slots=2)
        jkw = dict(tick_fn=lambda op, st, r, resp, explicit_w=None:
                   JA.tick_fast(op, "count", st, r, resp),
                   init_sigma=lambda: JA.fast_init(jop.resolved()))
        pkw = dict(tick_fn=lambda op, st, r, resp, explicit_w=None:
                   PA.tick_fast(op, "count", st, r, resp,
                                explicit_w=explicit_w),
                   init_sigma=lambda d: PA.fast_init(pop.resolved(), d))
        stream = jdg.tweets(np.random.default_rng(7), n_ticks=N_TICKS, tick=16,
                            words_per_tweet=4, vocab=300, k_virt=K,
                            mode=kind, pair_dist=3, rate_per_tick=8)
    return jkw, pkw, jop, pop, list(stream)


def _pipes(kind):
    jkw, pkw, jop, pop, stream = _setup(kind)
    jp = JVSN(jop, n_max=N_MAX, n_active=2, stash_cap=16, merge_fn=j_merge,
              **jkw)
    pp = PVSN(pop, n_max=N_MAX, n_active=2, stash_cap=16, merge_fn=p_merge,
              device="cpu", **pkw)
    return jp, pp, stream


def _step_both(jp, pp, b, rc):
    jo1, jo2, jsw, jload = jp.step_staged(b, rc)
    po1, po2, psw, pload = pp.step_staged(to_port(b), port_reconfig(rc))
    want = sorted(j_flat(jo1) + j_flat(jo2))
    assert sorted(p_flat(po1) + p_flat(po2)) == want
    assert bool(jsw) == bool(psw)
    np.testing.assert_array_equal(np.asarray(jload), pload.numpy())
    return want, bool(psw)


@pytest.mark.parametrize("kind", ["wordcount", "paircount", "scalejoin"])
def test_vsn_pipeline_matches_reference(kind):
    jp, pp, stream = _pipes(kind)
    outs, switched = [], []
    for i, b in enumerate(stream):
        o, sw = _step_both(jp, pp, b, RC if i == RC_AT else None)
        outs += o
        switched.append(sw)
    assert outs, "the stream must produce outputs"
    assert sum(switched) == 1
    assert int(pp.epoch.reconfigs) == 1
    assert_tree_equal(np_tree(jax.tree.map(np.asarray, jp.export_state())),
                      pp.export_state_np(), skip=("slot_l",))


def test_vsn_moves_no_state_and_sn_does():
    """Theorem 3 and the state-transfer headline on the fast path: SN (with
    the explicit end-of-tick watermark) gives VSN's outputs tick by tick;
    its switch ships sigma rows, VSN's swaps the tables only."""
    _, pkw, _, pop, stream = _setup("wordcount")
    vp = PVSN(pop, n_max=N_MAX, n_active=2, stash_cap=16, merge_fn=p_merge,
              device="cpu", **pkw)
    sp = PSN(pop, n_max=N_MAX, n_active=2, stash_cap=16, device="cpu", **pkw)
    for i, b in enumerate(stream):
        rc = port_reconfig(RC) if i == RC_AT else None
        v1, v2, _ = vp.step(to_port(b), rc)
        s1, s2, _ = sp.step(to_port(b), rc)
        assert sorted(p_flat(s1) + p_flat(s2)) == sorted(p_flat(v1) +
                                                         p_flat(v2))
    assert vp.bytes_transferred == 0
    assert vp.switch_bytes() == 4 * K + N_MAX + 12
    assert sp.bytes_transferred > 0
    assert max(sp.duplication) > 1.0


def test_sn_general_tick_matches_reference():
    """SNPipeline on the general O+ tick (its default): outputs,
    duplication factors and transferred bytes equal the reference's."""
    k = 8
    jop = JA.count_aggregate(JWS(10, 20, "multi"), k, out_cap=128)
    pop = PA.count_aggregate(PWS(10, 20, "multi"), k, out_cap=128)
    jp = JSN(jop, n_max=4, n_active=2, stash_cap=16)
    pp = PSN(pop, n_max=4, n_active=2, stash_cap=16, device="cpu")
    rng = np.random.default_rng(1)
    rc = Reconfiguration(epoch=1, n_active=4, fmu=balanced_fmu(k, 4, 4),
                         active=active_mask(4, 4))
    from conftest import make_stream_batch
    tau = 0
    for i in range(4):
        taus = np.sort(tau + rng.integers(0, 12, 8))
        tau = int(taus.max()) + 1
        keys = rng.integers(0, k, (8, 3)).astype(np.int32)
        keys[rng.random((8, 3)) < 0.2] = -1
        b = make_stream_batch(taus, keys=keys, kmax=3)
        jo1, jo2, jsw = jp.step(b, rc if i == 1 else None)
        po1, po2, psw = pp.step(to_port(b), port_reconfig(rc if i == 1
                                                          else None))
        assert sorted(p_flat(po1) + p_flat(po2)) == sorted(j_flat(jo1) +
                                                           j_flat(jo2))
        assert bool(jsw) == bool(psw)
    assert pp.duplication == pytest.approx(jp.duplication, abs=0)
    assert pp.bytes_transferred == jp.bytes_transferred > 0


def test_import_state_np_roundtrips_a_reference_snapshot():
    """Both pipelines start from the reference's mid-stream snapshot
    (ScaleGate stash + watermark, EpochState, fast-path sigma) and stay
    equal through a reconfiguration."""
    jp, _, stream = _pipes("wordcount")
    for b in stream[:2]:
        jp.step(b)
    snap = jax.tree.map(np.asarray, jp.export_state())
    _, pkw, _, pop, _ = _setup("wordcount")
    pp = PVSN(pop, n_max=N_MAX, n_active=2, stash_cap=16, merge_fn=p_merge,
              device="cpu", **pkw)
    pp.import_state_np(snap)
    assert_tree_equal(np_tree(snap), pp.export_state_np())
    for i, b in enumerate(stream[2:], start=2):
        _step_both(jp, pp, b, RC if i == RC_AT else None)
    assert int(pp.epoch.reconfigs) == 1
    assert elastic.vsn_switch_bytes(pp.epoch) == pp.switch_bytes()
