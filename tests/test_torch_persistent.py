"""The port's persistent K-tick driver on the CPU against the JAX reference.

``VSNPipeline.run_persistent`` (the plain loop the CPU runs; the card
replays a CUDA graph of the same ticks) against the port's own K
sequential ``step_staged`` calls, the reference's ``run_persistent`` and
the reference's K ``step``s, on the same batches: per-tick sorted output
multisets, switch flags and instance loads.  The cases mirror
``tests/test_persistent_loop.py``, for the fast count aggregate, the fast
join and the general O+ tick.  Then the pieces the driver needed: the
aggregate's expiry with no host read, the join's fixed-size emission, and
the async runtime's super-batch grouping."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _capturing import _Capturing
from _tick_oracle import _emit as _oracle_emit
from _tick_oracle import expire_all as _oracle_expire_all
from _torch_bridge import assert_tree_equal, np_tree, port_reconfig, to_port
from repro.core import aggregate as JA
from repro.core import join as JJ
from repro.core.async_runtime import AsyncStreamRuntime as JRuntime
from repro.core.controller import Reconfiguration, active_mask, balanced_fmu
from repro.core.runtime import VSNPipeline as JVSN
from repro.core.vsn import merge_fast_state as j_merge
from repro.core.windows import WindowSpec as JWS
from repro.data import datagen as jdg
from repro.io import SyntheticSource as JSource
from repro.io.sinks import flatten_outputs as j_flatten
from repro_torch.core import aggregate as PA
from repro_torch.core import join as PJ
from repro_torch.core import operator as POP
from repro_torch.core import tuples as PT
from repro_torch.core.async_runtime import (AsyncStreamRuntime, StagedSuper,
                                            run_sync)
from repro_torch.core.runtime import VSNPipeline as PVSN
from repro_torch.core.runtime import PersistentOut, inject_ctrl
from repro_torch.core.vsn import merge_fast_state as p_merge
from repro_torch.core.windows import WindowSpec as PWS
from repro_torch.io import NullSink, SyntheticSource
from repro_torch.io.sinks import flatten_outputs as p_flatten
from repro_torch.tree import tree_map

CPU = "cpu"
K = 64
WIN = dict(wa=50, ws=100, wt="multi")
JOIN_WIN = dict(wa=1, ws=20_000, wt="single")
RING = 4


# ------------------------------------------------------------- the paths --

def _agg_ops(**kw):
    kw = dict(out_cap=512, extra_slots=2, **kw)
    return (JA.count_aggregate(JWS(**WIN), K, **kw),
            PA.count_aggregate(PWS(**WIN), K, **kw))


def _pipes(path):
    """The reference's and the port's pipeline on one path: ``count`` (the
    fast aggregate), ``join`` (the fast ScaleJoin) or ``general`` (the
    O+ tick, as ``tests/test_persistent_loop.py`` runs it)."""
    if path == "join":
        jws, pws = JWS(**JOIN_WIN), PWS(**JOIN_WIN)
        jfj, pfj = JJ.band_predicate(2500.0, 2), PJ.band_predicate(2500.0, 2)
        jop = JJ.scalejoin_def(jws, K, jfj, payload_width=4, ring=RING,
                               out_cap=256)
        pop = PJ.scalejoin_def(pws, K, pfj, payload_width=4, ring=RING,
                               out_cap=256)
        # a ready batch (stash + tick + ctrl lanes) stores at most one
        # tuple a key: 32 + 16 + 1 <= K
        jp = JVSN(jop, n_max=8, n_active=4, stash_cap=32,
                  tick_fn=lambda o, s, r, m, explicit_w=None: JJ.tick_fast(
                      jws, jfj, s, r, m, out_cap=256),
                  merge_fn=j_merge,
                  init_sigma=lambda: JJ.fast_join_init(K, RING, 4))
        pp = PVSN(pop, n_max=8, n_active=4, stash_cap=32,
                  tick_fn=lambda o, s, r, m, explicit_w=None: PJ.tick_fast(
                      pws, pfj, s, r, m, out_cap=256),
                  merge_fn=p_merge,
                  init_sigma=lambda d: PJ.fast_join_init(K, RING, 4, d),
                  device=CPU)
        return jp, pp
    jop, pop = _agg_ops()
    if path == "general":
        return (JVSN(jop, n_max=8, n_active=4, stash_cap=64),
                PVSN(pop, n_max=8, n_active=4, stash_cap=64, device=CPU))
    jp = JVSN(jop, n_max=8, n_active=4, stash_cap=64,
              tick_fn=lambda o, s, r, m, explicit_w=None: JA.tick_fast(
                  o, "count", s, r, m, backend="xla"),
              merge_fn=j_merge,
              init_sigma=lambda: JA.fast_init(jop.resolved()))
    pp = PVSN(pop, n_max=8, n_active=4, stash_cap=64,
              tick_fn=lambda o, s, r, m, explicit_w=None: PA.tick_fast(
                  o, "count", s, r, m),
              merge_fn=p_merge,
              init_sigma=lambda d: PA.fast_init(pop.resolved(), d),
              device=CPU)
    return jp, pp


def _stream(path, n_ticks):
    if path == "join":
        return list(jdg.scalejoin(np.random.default_rng(3), n_ticks=n_ticks,
                                  tick=16, k_virt=K, rate_t_per_s=400.0))
    return list(jdg.tweets(np.random.default_rng(0), n_ticks=n_ticks,
                           tick=16, words_per_tweet=3, vocab=500, k_virt=K,
                           rate_per_tick=30))


def _reconfig():
    return Reconfiguration(epoch=1, n_active=3, fmu=balanced_fmu(K, 3, 8),
                           active=active_mask(3, 8))


def _row(flatten, o1, o2, sw, il):
    return (sorted(flatten(o1) + flatten(o2)), bool(np.asarray(sw)),
            np.asarray(il).tolist())


def _sequential(pipe, batches, rc=None, rc_at=0, port=True):
    """The oracle: K single steps (the port's ``step_staged``, the
    reference's)."""
    rows = []
    for i, b in enumerate(batches):
        r = rc if (rc is not None and i == rc_at) else None
        if port:
            out = pipe.step_staged(to_port(b), reconfig=port_reconfig(r))
            rows.append(_row(p_flatten, *out))
        else:
            rows.append(_row(j_flatten, *pipe.step_staged(b, reconfig=r)))
    return rows


def _ticks(out, port=True):
    """Per-tick rows of one persistent call."""
    import jax
    rows = []
    for i in range(int(np.asarray(out.switched).shape[0])):
        if port:
            pick = [tree_map(lambda a: a[i], o)
                    for o in (out.outs_pre, out.outs_post)]
            flatten = p_flatten
        else:
            pick = [jax.tree.map(lambda a: a[i], o)
                    for o in (out.outs_pre, out.outs_post)]
            flatten = j_flatten
        rows.append(_row(flatten, *pick, np.asarray(out.switched)[i],
                         np.asarray(out.inst_load)[i]))
    return rows


def _persistent(pipe, batches, rc=None, rc_at=0, port=True):
    if port:
        return _ticks(pipe.run_persistent(
            [to_port(b) for b in batches], reconfig=port_reconfig(rc),
            reconfig_at=rc_at))
    return _ticks(pipe.run_persistent(batches, reconfig=rc,
                                      reconfig_at=rc_at), port=False)


def _check(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0], f"tick {i}: output multisets differ"
            assert g[1] == w[1], f"tick {i}: switch flag differs"
            assert g[2] == w[2], f"tick {i}: instance loads differ"


PATHS = ["count", "join", "general"]


# ------------------------------------------------ the persistent driver --

@pytest.mark.parametrize("path", PATHS)
def test_persistent_matches_sequential_and_reference(path):
    batches = _stream(path, 6)
    jp, pp = _pipes(path)
    got = _persistent(pp, batches)
    _check(got, _sequential(_pipes(path)[1], batches),
           _persistent(jp, batches, port=False),
           _sequential(_pipes(path)[0], batches, port=False))
    assert sum(len(r[0]) for r in got) > 0


@pytest.mark.parametrize("path", ["count", "join"])
def test_consecutive_super_batches_thread_state(path):
    batches = _stream(path, 8)
    jp, pp = _pipes(path)
    got = _persistent(pp, batches[:4]) + _persistent(pp, batches[4:])
    want_j = (_persistent(jp, batches[:4], port=False)
              + _persistent(jp, batches[4:], port=False))
    _check(got, _sequential(_pipes(path)[1], batches), want_j)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("rc_at", [0, 3])
def test_midscan_reconfig_matches_sequential_and_reference(path, rc_at):
    batches = _stream(path, 6)
    rc = _reconfig()
    jp, pp = _pipes(path)
    got = _persistent(pp, batches, rc, rc_at)
    assert [r[1] for r in got].count(True) == 1, "the reconfiguration " \
        "never switched"
    _check(got, _sequential(_pipes(path)[1], batches, rc, rc_at),
           _persistent(jp, batches, rc, rc_at, port=False),
           _sequential(_pipes(path)[0], batches, rc, rc_at, port=False))


@pytest.mark.parametrize("path", ["count", "join"])
def test_midscan_reconfig_matches_static_outputs(path):
    """VSN moves no state at the switch: the whole output multiset with a
    mid-scan reconfiguration equals the run that never reconfigures."""
    batches = _stream(path, 6)
    flat = lambda rows: sorted(sum((r[0] for r in rows), []))
    static = _persistent(_pipes(path)[1], batches)
    moved = _persistent(_pipes(path)[1], batches, _reconfig(), 2)
    assert flat(moved) == flat(static)


def test_inject_ctrl_writes_one_ticks_pad_lanes():
    n, kmax, p = 2, 3, 1
    stack = PT.TupleBatch(**{f: torch.stack([getattr(PT.concat(
        PT.make_batch(np.arange(4) + 10 * k, np.zeros((4, 1)),
                      kmax=kmax, device=CPU),
        PT.empty_batch(n, kmax, p, CPU)), f) for k in range(3)])
        for f in PT.FIELDS})
    ctrl = PT.make_batch([7, 8], np.zeros((2, 1)), source=[0, 1],
                         is_control=[True, True], ctrl_epoch=[5, 5],
                         kmax=kmax, device=CPU)
    out = inject_ctrl(stack, ctrl, torch.tensor([1]), n)
    for f in PT.FIELDS:
        want = getattr(stack, f).clone()
        want[1, 4:] = getattr(ctrl, f)
        assert torch.equal(getattr(out, f), want), f
    assert not stack.is_control.any()               # out of place


# ----------------------------------------------------- the async runtime --

@pytest.mark.parametrize("path", ["count", "join"])
def test_async_super_batch_matches_sync_and_reference(path):
    batches = _stream(path, 10)           # two full groups and a padded one
    jp, pp = _pipes(path)
    rt = AsyncStreamRuntime(pp, SyntheticSource(iter(
        [to_port(b) for b in batches])), queue_cap=4, super_batch=4)
    rep = rt.run()
    _, sink = run_sync(_pipes(path)[1], SyntheticSource(iter(
        [to_port(b) for b in batches])))
    jrt = JRuntime(jp, JSource(iter(batches)), queue_cap=4, super_batch=4)
    jrt.run()
    assert rep.ticks == 3
    assert rt.sink.results() == sink.results() == jrt.sink.results()
    assert rt.sink.results()


class _Recording(AsyncStreamRuntime):
    """Keeps every staged item the step loop takes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.items = []
        put = self.queue.put
        self.queue.put = lambda item, *a, **kw: (self.items.append(item),
                                                 put(item, *a, **kw))[1]


def test_ingest_super_flushes_on_shape_change_and_pads_the_tail():
    """Groups of 4: a change of tick width flushes the open group early,
    and a partial group is padded with all-invalid ticks; the outputs
    equal the per-tick loop's and the reference runtime's."""
    base = _stream("count", 7)
    widths = [16, 16, 16, 8, 8, 16, 16]
    cut = [dataclasses.replace(b, **{f: getattr(b, f)[:w] for f in (
        "tau", "keys", "payload", "source", "valid", "is_control",
        "ctrl_epoch")}) for b, w in zip(base, widths)]
    _, pp = _pipes("count")
    rt = _Recording(pp, SyntheticSource(iter([to_port(b) for b in cut])),
                    queue_cap=8, super_batch=4)
    rt.run()
    assert [(len(i.metas), i.n_pad, i.stack.tau.shape[1]) for i in rt.items
            if isinstance(i, StagedSuper)] == [(3, 1, 17), (2, 2, 9),
                                               (2, 2, 17)]
    pads = rt.items[0].stack
    assert not pads.valid[3].any() and not pads.is_control[3].any()
    assert [m.tick_id for i in rt.items for m in i.metas] == list(range(7))
    _, sink = run_sync(_pipes("count")[1], SyntheticSource(iter(
        [to_port(b) for b in cut])))
    jp, _ = _pipes("count")
    jrt = JRuntime(jp, JSource(iter(cut)), queue_cap=8, super_batch=4)
    jrt.run()
    assert rt.sink.results() == sink.results() == jrt.sink.results()


def test_super_batch_reconfiguration_through_the_runtime():
    """A controller decision lands at a super-batch's first tick: the same
    outputs and switch tick as ``run_sync`` replaying the decision.  The
    source declares its rate, so the controller is asked from the first
    super-batch on; it decides at the second (tick 4)."""
    batches = [to_port(b) for b in _stream("count", 12)]
    rc = port_reconfig(_reconfig())

    class Hinted(SyntheticSource):
        def rate_hint(self, tick_id):
            return 1000.0

    class Once:
        def __init__(self):
            self.calls = 0

        def observe_live(self, snap):
            self.calls += 1
            return rc if self.calls == 2 else None

    _, pp = _pipes("count")
    rt = AsyncStreamRuntime(pp, Hinted(iter(batches)), controller=Once(),
                            queue_cap=4, super_batch=4)
    rep = rt.run()
    assert [t for t, _ in rep.reconfig_trace] == [4] and rep.switches == 1
    srep, sink = run_sync(_pipes("count")[1], SyntheticSource(iter(batches)),
                          reconfig_trace=rep.reconfig_trace)
    assert rt.sink.results() == sink.results() and srep.switches == 1


def test_null_sink_keeps_the_last_outputs_only():
    _, pp = _pipes("count")
    sink = NullSink()
    rep = AsyncStreamRuntime(pp, SyntheticSource(iter(
        [to_port(b) for b in _stream("count", 6)])), sink=sink,
        super_batch=4).run()
    sink.finalize()
    assert sink.ticks == rep.ticks == 2 and sink.results() is None
    assert sink._last.tau.shape[0] == 4           # a [K, ...] stack


# ---------------------------------------- the expiry with no host read --

def _expiry_cases():
    """(window, batches) that exercise the expiry: a gap in event time
    longer than the ring, a tick with no live lane (between ticks and as
    the very first), and ordinary ticks."""
    def tick(taus, keys, valid=None):
        return PT.make_batch(taus, np.ones((len(taus), 1)), keys=keys,
                             valid=valid, kmax=2, device=CPU)
    empty = tick([0, 0], [[-1, -1], [-1, -1]], valid=[False, False])
    first = tick([3, 9], [[1, 2], [2, -1]])
    return [
        ("gap", [first, tick([14, 31], [[3, 1], [0, 5]]),
                 tick([400, 401], [[1, 1], [2, 3]]),
                 tick([402, 950], [[4, -1], [1, 2]])]),
        ("idle", [empty, first, empty, tick([27, 28], [[1, 6], [7, 1]]),
                  empty, tick([90, 95], [[2, 2], [3, -1]])]),
        ("first", [first, tick([12, 19], [[0, 1], [1, 2]])]),
    ]


def _while_loop_expiry(op, st, w, resp, key_ids, plan=None):
    """``tick_fast``'s expiry as it was: ``_expire_all``'s host-read
    ``while`` into an empty buffer."""
    return _oracle_expire_all(op, st, POP._empty_outputs(
        op.out_cap, op.payload_out, resp.device), w, resp, key_ids)


@pytest.mark.parametrize("case", [c[0] for c in _expiry_cases()])
@pytest.mark.parametrize("wt", ["multi", "single"])
def test_expiry_equals_the_while_loop_and_the_reference(case, wt,
                                                        monkeypatch):
    """``tick_fast`` (``expire_closed``) against the reference's
    ``tick_fast`` (its ``lax.while_loop``) and against the port's
    ``tick_fast`` with the host-read ``while`` it had before, tick by
    tick, outputs lane for lane and state, with a partial responsibility
    mask.  A gap longer than the ring inside the fast path counts ring
    overruns, as the reference's does; the general tick is left out."""
    batches = dict((c[0], c[1]) for c in _expiry_cases())[case]
    k = 8
    spec = dict(wa=10, ws=20 if wt == "multi" else 10, wt=wt)
    jop = JA.count_aggregate(JWS(**spec), k, out_cap=64,
                             extra_slots=1).resolved()
    pop = PA.count_aggregate(PWS(**spec), k, out_cap=64,
                             extra_slots=1).resolved()
    resp = np.arange(k) % 3 != 1
    js, ps = JA.fast_init(jop), PA.fast_init(pop, CPU)
    got, emitted = [], 0
    for b in batches:
        js, jo = JA.tick_fast(jop, "count", js,
                              _to_ref(b), jnp.asarray(resp), backend="xla")
        ps, po = PA.tick_fast(pop, "count", ps, b, torch.from_numpy(resp))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(js), np_tree(ps), skip=("slot_l",))
        got.append((np_tree(ps), np_tree(po)))
        emitted += int(po.count)
    monkeypatch.setattr(PA, "expire_closed", _while_loop_expiry)
    ws_ = PA.fast_init(pop, CPU)
    for b, (st, out) in zip(batches, got):
        ws_, wo = PA.tick_fast(pop, "count", ws_, b, torch.from_numpy(resp))
        assert_tree_equal(np_tree(wo), out)
        assert_tree_equal(np_tree(ws_), st)
    assert emitted > 0


def _to_ref(b):
    from repro.core import tuples as JT
    return JT.TupleBatch(**{f: jnp.asarray(getattr(b, f).numpy())
                            for f in PT.FIELDS})


@pytest.mark.parametrize("wt", ["multi", "single"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expire_closed_equals_expire_all(wt, seed):
    """The vectorised expiry against the round-by-round loop on random
    rings: outputs (lane for lane, a non-empty buffer's overflow
    included) and state, for gaps from none to several rings."""
    rng = np.random.default_rng(seed)
    k = 6
    spec = PWS(wa=10, ws=30 if wt == "multi" else 10, wt=wt)
    op = PA.count_aggregate(spec, k, out_cap=12, extra_slots=1).resolved()
    key_ids = torch.arange(k, dtype=torch.int32)
    for gap in (0, 1, 2, op.slots, 3 * op.slots + 1):
        st = op.init_state(CPU)
        n0 = int(rng.integers(0, 5))
        st = dataclasses.replace(
            st, zeta={"acc": torch.from_numpy(rng.integers(
                1, 9, (k, op.slots, 1)).astype(np.float32))},
            occupied=torch.from_numpy(rng.random((k, op.slots)) < 0.7),
            next_l=torch.tensor(n0, dtype=torch.int32))
        w = torch.tensor(spec.right_of(n0 + gap) - 1 + int(rng.integers(0, 2)),
                         dtype=torch.int32)
        resp = torch.from_numpy(rng.random(k) < 0.8)
        want_st, want = _oracle_expire_all(
            op, st, POP._empty_outputs(op.out_cap, op.payload_out, CPU), w,
            resp, key_ids)
        got_st, got = POP.expire_closed(op, st, w, resp, key_ids)
        assert_tree_equal(np_tree(want), np_tree(got))
        assert_tree_equal(np_tree(want_st), np_tree(got_st))
    unset = dataclasses.replace(op.init_state(CPU))
    got_st, got = POP.expire_closed(op, unset, torch.tensor(500), resp,
                                    key_ids)
    assert int(got_st.next_l) == POP.UNSET_L and int(got.count) == 0


# ---------------------------------------- the join's fixed-size emission --

def _join_nonzero(window, f_j, st, ready, resp, out_cap):
    """The emission ``join.tick_fast`` used before: ``nonzero`` over each
    phase's hit mask, then ``_emit`` twice."""
    k_virt, ring = st.tau.shape
    b = ready.batch
    live_in = ready.valid & ~ready.is_control
    li = live_in.to(torch.int32)
    store_key = ((st.c + torch.cumsum(li, 0, dtype=torch.int32) - li)
                 % k_virt).long()
    fresh = st.tau[None] + window.ws >= ready.tau[:, None, None]
    opp = ((st.tau[None] >= 0) & fresh
           & (st.stream[None] != ready.source[:, None, None])
           & resp[None, :, None] & live_in[:, None, None])
    ii = torch.arange(b)
    pair = ((ii[None, :] < ii[:, None])
            & (ready.source[:, None] != ready.source[None, :])
            & resp[store_key][None, :] & live_in[:, None] & live_in[None, :])
    hit1 = opp & PJ._directed(f_j, ready.payload[:, None, None, :],
                              ready.source[:, None, None], st.pay[None])
    hit2 = (pair & (ready.tau[:, None] - ready.tau[None, :] <= window.ws)
            & PJ._directed(f_j, ready.payload[:, None, :],
                           ready.source[:, None], ready.payload[None]))
    outs = POP._empty_outputs(out_cap, 2 * ready.payload.shape[-1], CPU)
    idx = hit1.reshape(-1).nonzero().squeeze(1)
    bi, rest = idx // (k_virt * ring), idx % (k_virt * ring)
    pay1 = torch.cat([ready.payload[bi], st.pay[rest // ring, rest % ring]],
                     dim=-1)
    outs = _oracle_emit(outs, ready.tau[bi] + window.wa, pay1,
                     torch.ones_like(idx, dtype=torch.bool))
    idx = hit2.reshape(-1).nonzero().squeeze(1)
    pay2 = torch.cat([ready.payload[idx // b], ready.payload[idx % b]],
                     dim=-1)
    return _oracle_emit(outs, ready.tau[idx // b] + window.wa, pay2,
                     torch.ones_like(idx, dtype=torch.bool))


@pytest.mark.parametrize("out_cap", [4, 24, 256])
def test_join_emission_equals_nonzero_and_reference(out_cap):
    """Lane for lane, with the buffer overflowing in phase 1 (4), in
    phase 2 (24) and not at all (256)."""
    k, ring = 16, 4
    jws, pws = JWS(**JOIN_WIN), PWS(**JOIN_WIN)
    jfj, pfj = JJ.band_predicate(4000.0, 2), PJ.band_predicate(4000.0, 2)
    resp = np.arange(k) % 2 == 0
    jst = JJ.fast_join_init(k, ring, 4)
    pst = PJ.fast_join_init(k, ring, 4, CPU)
    overflowed = 0
    for b in _stream("join", 4):
        pb = to_port(b)
        old = _join_nonzero(pws, pfj, pst, pb, torch.from_numpy(resp),
                            out_cap)
        jst, jo = JJ.tick_fast(jws, jfj, jst, b, jnp.asarray(resp),
                               out_cap=out_cap)
        pst, po = PJ.tick_fast(pws, pfj, pst, pb, torch.from_numpy(resp),
                               out_cap=out_cap)
        assert_tree_equal(np_tree(old), np_tree(po))
        assert_tree_equal(np_tree(jo), np_tree(po))
        assert_tree_equal(np_tree(jst), np_tree(pst))
        overflowed += int(po.overflow)
    assert (overflowed > 0) == (out_cap < 256)


def test_compact_takes_the_first_rows_in_order():
    valid = torch.tensor([0, 1, 1, 0, 1, 0, 1, 1], dtype=torch.bool)
    rows, ok, n = POP.compact(valid, 3)
    assert rows.tolist() == [1, 2, 4] and ok.all() and int(n) == 5
    rows, ok, n = POP.compact(valid, 7)
    assert rows.tolist()[:5] == [1, 2, 4, 6, 7] and ok.tolist() == \
        [True] * 5 + [False] * 2 and int(n) == 5


def test_instances_share_builds_once_per_key():
    built = []
    key = (object(), object())
    with POP.instances_share():
        a = POP.shared(key, lambda: built.append(1) or "x")
        b = POP.shared(key, lambda: built.append(1) or "y")
        c = POP.shared((object(),), lambda: built.append(1) or "z")
    d = POP.shared(key, lambda: built.append(1) or "w")
    assert (a, b, c, d) == ("x", "x", "z", "w") and len(built) == 3


def _capture_first_call(pipe, batches):
    """``run_persistent_staged``'s first call on the card: stage, then
    ``_replay`` (warm-up, then capture) with no reconfiguration."""
    stack = pipe.stage_super(batches)
    k, width = stack.tau.shape
    kmax, p = stack.keys.shape[-1], stack.payload.shape[-1]
    operands = (stack, PT.empty_batch(pipe.op.n_inputs, kmax, p, CPU),
                torch.tensor([0]), pipe.epoch.fmu, pipe.epoch.active)
    return pipe._replay((k, width, kmax, p), operands)


def test_a_tick_that_reads_the_host_cannot_be_captured(monkeypatch):
    """The persistent driver captures the general O+ tick, which reads
    nothing back to the host, as it captures the fast ones; a tick
    function that calls ``.item()`` makes the call raise
    ``GraphCaptureError``, naming the cause (the capture acted out on
    the CPU, ``_Capturing``; ``chip_smoke.py`` captures and replays the
    general tick on the card)."""
    from repro_torch.core.runtime import GraphCaptureError
    batches = [to_port(b) for b in _stream("general", 2)]
    _, pp = _pipes("general")
    want = _sequential(_pipes("general")[1], _stream("general", 2))
    _Capturing(monkeypatch)
    first = _capture_first_call(pp, batches)
    assert list(pp.persistent_graphs()) == [(2, 16 + 1, 3, 1)]
    got = _ticks(PersistentOut(*first[3:8]))
    _check(got, want)

    def reads_the_host(o, s, r, m, explicit_w=None):
        if int(r.valid.sum().item()) < 0:
            raise AssertionError
        return PA.tick_fast(o, "count", s, r, m)
    _, fast = _pipes("count")
    fast._tick = reads_the_host
    with pytest.raises(GraphCaptureError, match="reads nothing back"):
        _capture_first_call(fast, batches)
