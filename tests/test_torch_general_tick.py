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
Two cases must raise, each a user ``f_S`` under WT=single with more than
two rounds closing on a slot: one keeps the slot occupied, the other
empties it but goes on halving its sums (which a later ``f_U`` reads)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import _tick_oracle as oracle
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


# ------------------------------------------------ user functions, twice --
def _user(xp, mode):
    """A sum aggregate written for one slot (its window index is a scalar
    it computes with), in ``xp`` = jnp or torch.  ``f_U`` emits a key's
    running sum on its second tuple; ``f_S`` clears the slot (``clear``),
    halves the sums and keeps every counted key occupied (``keep``), or
    halves the sums and marks no key occupied (``decay``)."""
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
    # (operator, wt, lazy, explicit_w every other tick, raises)
    ("count", "multi", False, False, False),
    ("count", "single", False, True, False),
    ("count", "multi", True, False, False),
    ("longest", "multi", False, True, False),
    ("longest", "single", True, False, False),
    ("table1", "multi", False, False, False),
    ("table1", "single", False, True, False),
    ("user_clear", "multi", False, False, False),
    ("user_clear", "single", False, True, False),
    ("user_keep", "single", False, False, False),
    ("scalejoin", "single", True, False, False),
    ("user_keep", "single", False, False, True),
    ("user_decay", "single", False, False, False),
    ("user_decay", "single", False, False, True),
]


@pytest.mark.parametrize(
    "name,wt,lazy,explicit,raises", CASES,
    ids=[f"{c[0]}-{c[1]}{'-lazy' if c[2] else ''}"
         f"{'-explicit' if c[3] else ''}{'-raises' if c[4] else ''}"
         for c in CASES])
def test_general_tick_equals_reference_and_oracle(name, wt, lazy, explicit,
                                                  raises):
    jop, pop = _ops(name, wt, lazy)
    s = pop.slots
    # a user f_S that keeps its slot occupied or changing is exact up to
    # two rounds a slot, and flagged past them
    gaps = ([0, 1, 2, s, 3 * s + 1] if name not in ("user_keep", "user_decay")
            else [0, 1, 2, s, 2 * s])
    if raises:
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
        if raises and i == len(batches) - 1:
            with pytest.raises(POP.ExpiryBoundError):
                POP.tick(pop, ps, pb, torch.from_numpy(resp))
            with pytest.raises(POP.ExpiryBoundError):
                PV.run_tick(pop, pv, pb, torch.from_numpy(fmu),
                            torch.from_numpy(active))
            with pytest.raises(POP.ExpiryBoundError):
                _flag_in_a_pipeline(pop, batches)
            return
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


def _flag_in_a_pipeline(pop, batches):
    """The same stream through a VSN pipeline's ``step``: the flag raised
    at the end of the step that set it."""
    from repro_torch.core.runtime import VSNPipeline
    pipe = VSNPipeline(pop, n_max=3, n_active=2, stash_cap=2 * B,
                       device="cpu")
    for b in batches:
        pipe.step(to_port(b))


@pytest.mark.parametrize("every", [0, 1], ids=["no-checkpoint",
                                               "checkpoint-every-tick"])
def test_a_flagged_tick_reaches_neither_sink_nor_checkpoint(tmp_path, every):
    """The live runtime reads a tick's expiry flag before its outputs go
    to the sink and before the state after it is saved: with the flag set
    at tick 1, the sink holds tick 0's outputs alone and the last
    checkpoint is the boundary before tick 1."""
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
