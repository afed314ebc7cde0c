"""The port's general O+ tick, one device program over every instance,
against the reference's ``repro.core.operator.tick`` and
``repro.core.vsn.run_tick`` and against the host-loop oracle it replaced
(``_tick_oracle``), on the CPU: outputs lane for lane (count and overflow
included) and state, exactly, tick by tick.

Each case is one operator and window type, run over a stream whose ticks
are separated by gaps of 0, 1, 2, ``slots`` and 2 or 3 * ``slots`` + 1
window generations (the expiry's bound), with a partial responsibility
mask on the single-instance tick and disjoint masks (one instance
inactive) on ``run_tick``.  The operators: the count and longest
aggregates (``lazy_expiry`` too), the Table-1 defaults, user functions
that the port calls under ``torch.func.vmap`` (they read their window
index as a scalar), ScaleJoin (lazy, a user ``f_U``), multi-key tuples,
first contact from ``UNSET_L`` and the explicit end-of-tick watermark;
the state handed to a tick is left as it was.
Three cases close more than two rounds on a slot with a user ``f_S``
under WT=single, past what the bounded expiry can show exact: one keeps
the slot occupied, one empties it but goes on halving its sums (which a
later ``f_U`` reads), and one halves them only at bounds left of
``EARLY``, so that f_S is exact at the last due round but not at the
earliest skipped one.  The eager tick sees its flag and runs every due
round, so these equal the reference too (``-raises`` names the two that
raised ``ExpiryBoundError`` before), through ``tick``, ``run_tick`` and a
``VSNPipeline`` against the reference's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import _tick_oracle as oracle
from _capturing import _Capturing
from _torch_bridge import assert_tree_equal, np_tree, to_port
from repro.core import aggregate as JA
from repro.core import join as JJ
from repro.core import operator as JOP
from repro.core import tuples as JT
from repro.core import vsn as JV
from repro.core.windows import WindowSpec as JWS
from repro_torch.core import aggregate as PA
from repro_torch.core import join as PJ
from repro_torch.core import operator as POP
from repro_torch.core import vsn as PV
from repro_torch.core.windows import WindowSpec as PWS

K, KMAX, B, P = 6, 2, 7, 2
EARLY = 60          # the "early" f_S halves the sums left of this bound


# ------------------------------------------------ user functions, twice --
def _user(xp, mode):
    """A sum aggregate written for one slot (its window index is a scalar
    it computes with), in ``xp`` = jnp or torch.  ``f_U`` emits a key's
    running sum on its second tuple; ``f_S`` clears the slot (``clear``),
    halves the sums and keeps every counted key occupied (``keep``),
    halves the sums and marks no key occupied (``decay``), or halves them
    only at bounds left of ``EARLY`` and marks no key occupied
    (``early``)."""
    where = xp.where

    def f_u(z, tup, l, mask):
        scale = (l % 3 + 1).astype(xp.float32) if xp is jnp else \
            (l % 3 + 1).to(torch.float32)
        acc = z["acc"] + tup.payload[0] * scale
        n = z["n"] + 1
        pay = xp.stack([acc[:, 0], acc[:, 0] * 0 + scale], axis=-1) \
            if xp is jnp else torch.stack([acc[:, 0], acc[:, 0] * 0 + scale],
                                          dim=-1)
        return {"acc": acc, "n": n}, pay, n == 2

    def f_o(z, l, key_ids):
        kf = key_ids.astype(xp.float32) if xp is jnp else key_ids.to(
            torch.float32)
        lf = (l * 0 + l).astype(xp.float32) if xp is jnp else l.to(
            torch.float32)
        pay = (xp.stack([kf, z["acc"][:, 0] + lf], axis=-1) if xp is jnp
               else torch.stack([kf, z["acc"][:, 0] + lf], dim=-1))
        return pay, z["n"] > 0

    def f_s(z, new_left):
        if mode == "keep":
            return {"acc": z["acc"] * 0.5, "n": z["n"]}, z["n"] > 0
        if mode == "decay":
            return {"acc": z["acc"] * 0.5, "n": z["n"]}, z["n"] > 100
        if mode == "early":
            return ({"acc": where(new_left < EARLY, z["acc"] * 0.5,
                                  z["acc"]), "n": z["n"]}, z["n"] > 100)
        return ({"acc": z["acc"] * 0, "n": z["n"] * 0},
                where(z["n"] > 100, True, False))
    return f_u, f_o, f_s


def _user_ops(spec, mode):
    slots = (spec["ws"] // spec["wa"] if spec["wt"] == "multi" else 1) + 1
    jfu, jfo, jfs = _user(jnp, mode)
    pfu, pfo, pfs = _user(torch, mode)
    jop = JOP.OperatorDef(
        window=JWS(**spec), n_inputs=1, k_virt=K, payload_out=P,
        init_zeta=lambda: {"acc": jnp.zeros((K, slots, 1), jnp.float32),
                           "n": jnp.zeros((K, slots), jnp.int32)},
        f_u=jfu, f_o=jfo, f_s=jfs, out_cap=24, extra_slots=1)
    pop = POP.OperatorDef(
        window=PWS(**spec), n_inputs=1, k_virt=K, payload_out=P,
        init_zeta=lambda d: {"acc": torch.zeros((K, slots, 1), device=d),
                             "n": torch.zeros((K, slots), dtype=torch.int32,
                                              device=d)},
        f_u=pfu, f_o=pfo, f_s=pfs, out_cap=24, extra_slots=1)
    return jop, pop


def _table1_ops(spec):
    slots = (spec["ws"] // spec["wa"] if spec["wt"] == "multi" else 1) + 1
    ring = 3

    def init(device=None):
        return JOP.tuple_store_init(K, slots, ring, P)
    jop = JOP.OperatorDef(window=JWS(**spec), n_inputs=1, k_virt=K,
                          payload_out=P, init_zeta=init, out_cap=24,
                          extra_slots=1)
    pop = POP.OperatorDef(
        window=PWS(**spec), n_inputs=1, k_virt=K, payload_out=P,
        init_zeta=lambda d: {n: torch.from_numpy(np.array(a)).to(d)
                             for n, a in init().items()},
        out_cap=24, extra_slots=1)
    return jop, pop


def _ops(name, wt, lazy):
    spec = dict(wa=10, ws=20 if wt == "multi" else 10, wt=wt)
    if name in ("count", "longest"):
        kw = dict(out_cap=24, extra_slots=1)
        jop = getattr(JA, f"{name}_aggregate")(JWS(**spec), K, **kw)
        pop = getattr(PA, f"{name}_aggregate")(PWS(**spec), K, **kw)
    elif name == "table1":
        jop, pop = _table1_ops(spec)
    elif name == "scalejoin":
        spec = dict(wa=1, ws=40, wt="single")
        jop = JJ.scalejoin_def(JWS(**spec), K, JJ.band_predicate(3.0, 1),
                               payload_width=1, ring=3, out_cap=24)
        pop = PJ.scalejoin_def(PWS(**spec), K, PJ.band_predicate(3.0, 1),
                               payload_width=1, ring=3, out_cap=24)
        return jop.resolved(), pop.resolved()
    else:
        jop, pop = _user_ops(spec, name.removeprefix("user_"))
    jop = dataclasses.replace(jop, lazy_expiry=lazy).resolved()
    pop = dataclasses.replace(pop, lazy_expiry=lazy).resolved()
    return jop, pop


# -------------------------------------------------------------- streams --
def _stream(seed, wa, gaps, width=1):
    """One tick per gap: sorted taus a few deltas apart, the first a gap
    of ``gaps[i]`` window generations after the last tick's last tau;
    invalid lanes, a control lane, keys out of range, repeated and -1."""
    rng = np.random.default_rng(seed)
    tau, out = 3, []
    for i, gap in enumerate(gaps):
        tau += gap * wa
        taus = tau + np.cumsum(rng.integers(0, 4, B))
        tau = int(taus[-1])
        keys = rng.integers(-1, K + 2, (B, KMAX)).astype(np.int32)
        keys[0, 1] = keys[0, 0]                  # a repeated key
        valid = rng.random(B) < 0.85
        ctrl = np.zeros(B, bool)
        ctrl[B // 2] = i % 2 == 1
        pay = rng.integers(1, 6, (B, width)).astype(np.float32)
        src = (rng.random(B) < 0.5).astype(np.int32)
        out.append(JT.make_batch(taus, pay, source=src, valid=valid,
                                 keys=keys, kmax=KMAX,
                                 is_control=ctrl))
    return out


def _jit_tick(jop):
    return jax.jit(lambda st, b, resp, w: JOP.tick(jop, st, b, resp,
                                                   explicit_w=w))


def _jit_run_tick(jop):
    return jax.jit(lambda st, b, fmu, active: JV.run_tick(jop, st, b, fmu,
                                                          active))


CASES = [
    # (operator, wt, lazy, explicit_w every other tick, past the bound:
    #  "" or the id's suffix)
    ("count", "multi", False, False, ""),
    ("count", "single", False, True, ""),
    ("count", "multi", True, False, ""),
    ("longest", "multi", False, True, ""),
    ("longest", "single", True, False, ""),
    ("table1", "multi", False, False, ""),
    ("table1", "single", False, True, ""),
    ("user_clear", "multi", False, False, ""),
    ("user_clear", "single", False, True, ""),
    ("user_keep", "single", False, False, ""),
    ("scalejoin", "single", True, False, ""),
    ("user_keep", "single", False, False, "raises"),
    ("user_decay", "single", False, False, ""),
    ("user_decay", "single", False, False, "raises"),
    ("user_early", "single", False, False, "past"),
]


@pytest.mark.parametrize(
    "name,wt,lazy,explicit,past", CASES,
    ids=[f"{c[0]}-{c[1]}{'-lazy' if c[2] else ''}"
         f"{'-explicit' if c[3] else ''}{'-' + c[4] if c[4] else ''}"
         for c in CASES])
def test_general_tick_equals_reference_and_oracle(name, wt, lazy, explicit,
                                                  past):
    jop, pop = _ops(name, wt, lazy)
    s = pop.slots
    # a user f_S that keeps its slot occupied or changing is exact up to
    # two rounds a slot under the bound, and run round by round past them
    gaps = ([0, 1, 2, s, 3 * s + 1] if not name.startswith(
        ("user_keep", "user_decay", "user_early")) else [0, 1, 2, s, 2 * s])
    if past:
        gaps = [0, 3 * s + 1]
    width = 1 if name == "scalejoin" else P
    batches = _stream(7, pop.window.wa, gaps, width)
    resp = np.arange(K) % 3 != 1
    fmu = (np.arange(K) % 3).astype(np.int32)
    active = np.array([True, False, True])
    jt, jr = _jit_tick(jop), _jit_run_tick(jop)
    js = jop.init_state()
    ps = os_ = pop.init_state("cpu")
    jv, pv = js, ps
    emitted = 0
    for i, b in enumerate(batches):
        pb = to_port(b)
        w = int(np.asarray(b.tau).max()) + 15 if explicit and i % 2 else None
        js, jo = jt(js, b, jnp.asarray(resp),
                    None if w is None else jnp.int32(w))
        inputs = (ps, pv)
        before = [np_tree(x) for x in inputs]
        ps, po = POP.tick(pop, ps, pb, torch.from_numpy(resp), explicit_w=w)
        os_, oo = oracle.tick(pop, os_, pb, torch.from_numpy(resp),
                              explicit_w=w)
        for want in (np_tree(jo), np_tree(oo)):
            assert_tree_equal(want, np_tree(po))
        for want in (np_tree(js), np_tree(os_)):
            assert_tree_equal(want, np_tree(ps))
        jv, jvo = jr(jv, b, jnp.asarray(fmu), jnp.asarray(active))
        pv, pvo = PV.run_tick(pop, pv, pb, torch.from_numpy(fmu),
                              torch.from_numpy(active))
        assert_tree_equal(np_tree(jvo), np_tree(pvo))
        assert_tree_equal(np_tree(jv), np_tree(pv))
        for want, x in zip(before, inputs):     # the input is only read
            assert_tree_equal(want, np_tree(x))
        emitted += int(po.count) + int(pvo.count.sum())
    if name == "table1":            # stores tuples, emits nothing
        assert int((ps.zeta["tau"] >= 0).sum()) > 0 and emitted == 0
    elif not lazy or name == "scalejoin":
        assert emitted > 0
    if past:
        _pipeline_equals_reference(jop, pop, batches)


def _pipeline_equals_reference(jop, pop, batches):
    """The same stream through the port's ``VSNPipeline.step`` and the
    reference's: equal outputs and switch flags, tick for tick."""
    from repro.core.runtime import VSNPipeline as JVSN
    from repro_torch.core.runtime import VSNPipeline
    jpipe = JVSN(jop, n_max=3, n_active=2, stash_cap=2 * B)
    pipe = VSNPipeline(pop, n_max=3, n_active=2, stash_cap=2 * B,
                       device="cpu")
    for b in batches:
        for want, got in zip(jpipe.step(b), pipe.step(to_port(b))):
            assert_tree_equal(np_tree(want), np_tree(got))


def _captured(monkeypatch, fn):
    """``fn`` with every call run as a capture acted out on the CPU
    (``_Capturing``): the bounded expiry, its flag collected, computing
    what a replay of the call's graph computes."""
    def call(*a, **kw):
        with torch.cuda.graph(None):
            return fn(*a, **kw)
    _Capturing(monkeypatch)
    return call


def test_the_earliest_skipped_bound_is_checked(monkeypatch):
    """The ``early`` f_S returns the state unchanged at the last due
    round's bound but halves it at the earliest skipped one: a captured
    tick's bounded expiry sets its flag there, while a check of the last
    bound alone would have passed."""
    _, pop = _ops("user_early", "single", False)
    s = pop.slots
    batches = [to_port(b) for b in _stream(7, pop.window.wa,
                                           [0, 3 * s + 1], P)]
    resp = torch.from_numpy(np.arange(K) % 3 != 1)
    tick = _captured(monkeypatch, POP.tick)
    seen = []
    st = pop.init_state("cpu")
    for b in batches:
        with POP.expiry_faults() as flags:
            st, _ = tick(pop, st, b, resp)
        seen.append(bool(POP.any_fault(flags)))
    assert seen == [False, True]


def test_a_captured_tick_past_the_bound_raises_after_the_replay(
        monkeypatch):
    """The persistent driver, its ticks captured (acted out on the CPU):
    ``user_keep`` under WT=single past what the bounded expiry can show
    exact sets the flag, ``run_persistent`` raises ``ExpiryBoundError``
    after the call, and the live runtime's super-batch holding that tick
    reaches no sink; the super-batch before it does.  Run eagerly, the
    same stream equals the reference's pipeline."""
    from repro_torch.core.async_runtime import AsyncStreamRuntime
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.io.sinks import CollectSink
    from repro_torch.io.sources import ReplaySource
    jop, pop = _ops("user_keep", "single", False)
    s = pop.slots
    raw = _stream(7, pop.window.wa, [0, 1, 3 * s + 1, 0], P)
    batches = [to_port(b) for b in raw]
    _pipeline_equals_reference(jop, pop, raw)

    def pipe():
        p = VSNPipeline(pop, n_max=3, n_active=2, stash_cap=2 * B,
                        device="cpu")
        monkeypatch.setattr(p, "_persistent_ticks",
                            _captured(monkeypatch, p._persistent_ticks))
        return p
    p = pipe()
    assert p.run_persistent(batches[:2]).fault is not None
    with pytest.raises(POP.ExpiryBoundError):
        p.run_persistent(batches[2:])
    sink = CollectSink()
    rt = AsyncStreamRuntime(pipe(), ReplaySource(batches), sink=sink,
                            super_batch=2)
    with pytest.raises(POP.ExpiryBoundError):
        rt.run()
    assert [t for t, _, _ in sink._held] == [0]


@pytest.mark.parametrize("every", [0, 1], ids=["no-checkpoint",
                                               "checkpoint-every-tick"])
def test_a_flagged_tick_reaches_neither_sink_nor_checkpoint(tmp_path, every,
                                                          monkeypatch):
    """The live runtime reads a tick's expiry flag before its outputs go
    to the sink and before the state after it is saved.  Eagerly the
    stream past the bound sets no flag (the tick runs every due round):
    all three ticks reach the sink.  With its ticks captured (acted out on
    the CPU), tick 1 sets the flag: the sink holds tick 0's outputs alone
    and the last checkpoint is the boundary before tick 1."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.stream import StreamCheckpointer
    from repro_torch.core.async_runtime import AsyncStreamRuntime
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.io.sinks import CollectSink
    from repro_torch.io.sources import ReplaySource
    _, pop = _ops("user_keep", "single", False)
    s = pop.slots
    batches = [to_port(b) for b in _stream(7, pop.window.wa,
                                           [0, 3 * s + 1, 0], P)]
    pipe = VSNPipeline(pop, n_max=3, n_active=2, stash_cap=2 * B,
                       device="cpu")
    sink = CollectSink()
    AsyncStreamRuntime(pipe, ReplaySource(batches), sink=sink).run()
    assert [t for t, _, _ in sink._held] == [0, 1, 2]

    pipe = VSNPipeline(pop, n_max=3, n_active=2, stash_cap=2 * B,
                       device="cpu")
    monkeypatch.setattr(pipe, "step_staged",
                        _captured(monkeypatch, pipe.step_staged))
    sck = (StreamCheckpointer(Checkpointer(str(tmp_path)), every, pipe)
           if every else None)
    sink = CollectSink()
    rt = AsyncStreamRuntime(pipe, ReplaySource(batches), sink=sink,
                            checkpointer=sck)
    with pytest.raises(POP.ExpiryBoundError):
        rt.run()
    assert [t for t, _, _ in sink._held] == [0]
    if every:
        assert sck.saved_steps == [1]
