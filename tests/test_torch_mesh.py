"""The port's stream mesh (``MeshPipeline`` over ``launch.mesh.StreamMesh``)
held against the JAX reference on the CPU.

All shards of a port mesh are on ``"cpu"`` here (the reference's 8-way
cases need ``XLA_FLAGS``-forced devices; the port's mesh is a device list
in one process, so N shards may share one device).  The reference's
``VSNPipeline`` host run is the oracle, as in ``tests/test_mesh_runtime.py``;
the reference's 1-shard ``MeshPipeline`` and its monolithic join are the
other references.  The reference's own persistent mesh loop fails on this
tree (ROADMAP.md queue 3), so ``run_persistent`` is held against its
sequential ``MeshPipeline.run`` at 1 shard.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _capturing import _Capturing  # noqa: E402
from _torch_bridge import (assert_tree_equal, np_tree, port_reconfig,  # noqa
                           to_port)
from repro import api as japi  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import stream as jckstream  # noqa: E402
from repro.core import aggregate as JA  # noqa: E402
from repro.core import join as JJ  # noqa: E402
from repro.core import operator as JOP  # noqa: E402
from repro.core import vsn as JV  # noqa: E402
from repro.core.controller import (Reconfiguration, active_mask,  # noqa
                                   balanced_fmu)
from repro.core.runtime import MeshPipeline as JMesh  # noqa: E402
from repro.core.runtime import VSNPipeline as JVSN  # noqa: E402
from repro.core.windows import WindowSpec as JWS  # noqa: E402
from repro.data import datagen  # noqa: E402
from repro.io import ReplaySource as JReplay  # noqa: E402
from repro.io.sinks import flatten_outputs as j_flatten  # noqa: E402
from repro.launch.mesh import make_stream_mesh as j_make_mesh  # noqa: E402
from repro_torch import api as papi  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import stream as ckstream  # noqa: E402
from repro_torch.core import aggregate as PA  # noqa: E402
from repro_torch.core import join as PJ  # noqa: E402
from repro_torch.core import operator as POP  # noqa: E402
from repro_torch.core import vsn as PV  # noqa: E402
from repro_torch.core.runtime import (GraphCaptureError,  # noqa: E402
                                      MeshPipeline, SNPipeline, VSNPipeline)
from repro_torch.core.windows import WindowSpec as PWS  # noqa: E402
from repro_torch.io.sinks import flatten_outputs as p_flatten  # noqa: E402
from repro_torch.io.sources import ReplaySource  # noqa: E402
from repro_torch.launch import recovery as prec  # noqa: E402
from repro_torch.launch.mesh import make_stream_mesh  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
K = 64
WIN = dict(wa=50, ws=100, wt="multi")
SHARDS = [1, 2, 4, 8]
MODES = ["general", "fast-agg"]
# the ready batch's lanes are the stash's plus the tick's: the general
# tick's cost grows with them (one tuple lane at a time, every shard)
STASH = 32


def _ops():
    kw = dict(k_virt=K, out_cap=512, extra_slots=2)
    return (JA.count_aggregate(JWS(**WIN), **kw),
            PA.count_aggregate(PWS(**WIN), **kw))


def _stream(n_ticks=6, seed=0):
    return list(datagen.tweets(np.random.default_rng(seed), n_ticks=n_ticks,
                               tick=16, words_per_tweet=3, vocab=500,
                               k_virt=K, rate_per_tick=30))


def _reconfig():
    """``tests/test_mesh_runtime.py``'s drain: instance 2 leaves, its keys
    go to the others."""
    fmu = balanced_fmu(K, 3, 8)
    fmu = np.where(fmu >= 2, fmu + 1, fmu).astype(np.int32)
    active = active_mask(4, 8)
    active[2] = False
    return Reconfiguration(epoch=1, n_active=3, fmu=fmu, active=active)


RC_AT = 2


def _mesh(n, mode="fast-agg"):
    return MeshPipeline(_ops()[1], make_stream_mesh(n, CPU), stash_cap=STASH,
                        mode=mode, n_max=8, n_active=4)


def _jmesh(mode="fast-agg"):
    return JMesh(_ops()[0], j_make_mesh(1), stash_cap=STASH, mode=mode,
                 n_max=8, n_active=4)


def _rows(flatten, o1, o2, sw):
    return sorted(flatten(o1) + flatten(o2)), bool(np.asarray(sw))


def _steps(pipe, batches, port=True, rc_at=RC_AT):
    """Per tick: (sorted outputs, switched), one ``step`` a tick."""
    rows = []
    for i, b in enumerate(batches):
        rc = _reconfig() if i == rc_at else None
        if port:
            rows.append(_rows(p_flatten, *pipe.step(
                to_port(b), reconfig=port_reconfig(rc))))
        else:
            rows.append(_rows(j_flatten, *pipe.step(b, reconfig=rc)))
    return rows


@pytest.fixture(scope="module")
def oracle():
    """The reference's ``VSNPipeline`` host run over the stream, with the
    drain at tick 2: the sorted output multiset."""
    batches = _stream()
    pipe = JVSN(_ops()[0], n_max=8, n_active=4, stash_cap=STASH)
    out = []
    for i, b in enumerate(batches):
        o1, o2, _ = pipe.step(b, reconfig=_reconfig() if i == RC_AT
                              else None)
        out += j_flatten(o1) + j_flatten(o2)
    return batches, sorted(out)


# ------------------------------------------------------- parity, switch --

@pytest.mark.parametrize("batched", [False, True],
                         ids=["per-tick", "batched"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", SHARDS)
def test_mesh_equals_reference_vsn_oracle(oracle, n, mode, batched):
    """1, 2, 4 and 8 shards, both tick paths, one ``step`` a tick or all
    six ticks in one ``run``: the reference ``VSNPipeline``'s output
    multiset across the drain, one switch, 0 bytes between devices, and
    the tables-only switch bytes."""
    batches, want = oracle
    pipe = _mesh(n, mode)
    if batched:
        o1, o2, sw = pipe.run([to_port(b) for b in batches],
                              reconfig=port_reconfig(_reconfig()),
                              reconfig_at=RC_AT)
        got, switched = sorted(p_flatten(o1) + p_flatten(o2)), int(sw.sum())
    else:
        rows = _steps(pipe, batches)
        got = sorted(o for r in rows for o in r[0])
        switched = sum(r[1] for r in rows)
    assert got == want
    assert switched == 1 and int(pipe.epoch.reconfigs) == 1
    assert pipe.collective_bytes() == {}
    assert pipe.switch_bytes() == 4 * K + 8 + 12


@pytest.mark.parametrize("mode", MODES)
def test_mesh1_equals_reference_mesh1(mode):
    """Tick for tick, the drain included: the port's 1-shard mesh equals
    the reference's ``MeshPipeline`` on one device."""
    batches = _stream()
    assert (_steps(_mesh(1, mode), batches)
            == _steps(_jmesh(mode), batches, port=False))


def test_sn_pays_for_the_switch_the_mesh_does_not():
    """The same drain moves sigma rows in the port's ``SNPipeline``; the
    mesh's switch touches the tables alone, and every shard's block keeps
    its storage across it."""
    batches = [to_port(b) for b in _stream()]
    pipe = _mesh(8)
    ptrs = [[a.data_ptr() for a in tree_leaves(b)] for b in pipe.blocks]
    for i, b in enumerate(batches):
        pipe.step(b, reconfig=port_reconfig(_reconfig()) if i == RC_AT
                  else None)
    assert ptrs == [[a.data_ptr() for a in tree_leaves(b)]
                    for b in pipe.blocks]
    sn = SNPipeline(_ops()[1], n_max=8, n_active=4, stash_cap=STASH,
                    device=CPU)
    for i, b in enumerate(batches):
        sn.step(b, reconfig=port_reconfig(_reconfig()) if i == RC_AT
                else None)
    assert sn.bytes_transferred > 0 and pipe.switch_bytes() == 4 * K + 8 + 12


def test_two_devices_equal_one():
    """Four shards over two devices (``cpu`` and ``cpu:0`` are two devices
    to torch, so the step replicates the gate and the tables per device
    and records its copies between them) give the one-device mesh's
    ticks, per tick and through ``run_persistent``, and copy no state."""
    from repro_torch.launch.mesh import StreamMesh
    two = StreamMesh((torch.device("cpu"), torch.device("cpu", 0)) * 2)
    assert [s for _, s in two.groups] == [(0, 2), (1, 3)]
    batches = _stream(5)
    pipe = MeshPipeline(_ops()[1], two, stash_cap=STASH, mode="fast-agg",
                        n_max=8, n_active=4)
    want = _steps(_mesh(4), batches)
    assert _steps(pipe, batches) == want
    assert pipe.collective_bytes() == {} and len(pipe._copies) == 1
    pipe = MeshPipeline(_ops()[1], two, stash_cap=STASH, mode="fast-agg",
                        n_max=8, n_active=4)
    assert _persistent_rows(pipe.run_persistent(
        [to_port(b) for b in batches], reconfig=port_reconfig(_reconfig()),
        reconfig_at=RC_AT)) == want


def test_copy_accounting():
    """``record_copies`` sees a copy between two devices; ``collective_
    bytes`` sums those between two of the mesh's devices only."""
    from repro_torch.launch.mesh import collective_bytes, record_copies
    with record_copies() as log:
        torch.ones(3).to("meta")
        torch.empty(2, device="meta").copy_(torch.ones(2))
        torch.ones(4).clone()
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert log == [(cpu, meta, 12), (cpu, meta, 8)]
    assert collective_bytes(log, [cpu, meta]) == {"device-to-device": 20}
    assert collective_bytes(log, [cpu]) == {}


# ------------------------------------------------------------ the join --

JWIN = dict(wa=1, ws=5000, wt="single")
JRING, JP = 8, 4


def _join_stream():
    return list(datagen.scalejoin(np.random.default_rng(3), n_ticks=5,
                                  tick=32, k_virt=1))


def _join_rows(flatten, outs):
    return sorted((t, tuple(np.round(np.asarray(p, np.float64), 3)))
                  for t, p in flatten(outs))


@pytest.mark.parametrize("n", [1, 8])
def test_sliced_join_partitions_the_work(n):
    """``shard_tick`` + ``join_local_tick`` at 1 and 8 shards: the
    reference's monolithic ``join.tick_fast`` output pairs, and the shards'
    comparisons partition its total exactly, each shard doing a share."""
    batches = _join_stream()
    fj = JJ.band_predicate(500.0, 2)
    st = JJ.fast_join_init(K, JRING, JP)
    resp = jnp.ones((K,), bool)
    want, comps = [], 0.0
    for b in batches:
        st, outs = JJ.tick_fast(JWS(**JWIN), fj, st, b, resp, out_cap=2048)
        want += _join_rows(j_flatten, outs)
        comps += float(st.comparisons)

    mesh = make_stream_mesh(n, CPU)
    sigma = dataclasses.replace(PJ.fast_join_init(K, JRING, JP, CPU),
                                comparisons=torch.zeros((n,)))
    step = PV.shard_tick(mesh, K, PV.join_local_tick(
        PWS(**JWIN), PJ.band_predicate(500.0, 2), K, out_cap=2048))
    stack = PV.stack([to_port(b) for b in batches])
    blocks, outs = step(PV.mesh_device_put(sigma, mesh, K), stack)
    got_comps = PV.mesh_gather(blocks, PV.mesh_state_spec(sigma, K),
                               CPU).comparisons
    assert _join_rows(p_flatten, outs) == sorted(want)
    assert float(got_comps.sum()) == comps
    assert bool((got_comps > 0).all())


def _block_case(path, lo, rows):
    """The reference's and the port's tick on the key block ``[lo, lo +
    rows)``: ``(j_tick, p_tick, j_state, p_state)``."""
    if path == "join":
        jws, pws = JWS(**JWIN), PWS(**JWIN)
        jfj, pfj = JJ.band_predicate(500.0, 2), PJ.band_predicate(500.0, 2)
        jt = lambda s, r: JJ.tick_fast(jws, jfj, s, r, jnp.ones((rows,),
                                                                bool),
                                       2048, k_global=K, k_offset=lo)
        pt = lambda s, r: PJ.tick_fast(pws, pfj, s, r, torch.ones(rows,
                                                                  dtype=bool),
                                       2048, k_global=K, k_offset=lo)
        return (jt, pt, JJ.fast_join_init(rows, JRING, JP),
                PJ.fast_join_init(rows, JRING, JP, CPU))
    jop, pop = _ops()
    jl, pl = JV.localize_op(jop, lo, rows), PV.localize_op(pop, lo, rows)
    jresp, presp = jnp.ones((rows,), bool), torch.ones(rows, dtype=bool)
    if path == "aggregate":
        return (lambda s, r: JA.tick_fast(jl, "count", s, r, jresp,
                                          backend="xla", key_offset=lo),
                lambda s, r: PA.tick_fast(pl, "count", s, r, presp,
                                          key_offset=lo),
                JA.fast_init(jl.resolved()), PA.fast_init(pl.resolved(), CPU))
    return (lambda s, r: JOP.tick(jl, s, r, jresp, key_offset=lo),
            lambda s, r: POP.tick(pl, s, r, presp, key_offset=lo),
            jl.resolved().init_state(), pl.resolved().init_state(CPU))


@pytest.mark.parametrize("path", ["join", "aggregate", "operator"])
def test_sliced_tick_equals_reference_at_a_block(path):
    """``join.tick_fast`` (``k_global``/``k_offset``),
    ``aggregate.tick_fast`` and ``operator.tick`` (``key_offset``) on the
    key block [24, 40) of 64: the reference's outputs and state, tick for
    tick."""
    batches = _join_stream() if path == "join" else _stream(4)
    jt, pt, js, ps = _block_case(path, 24, 16)
    emitted = 0
    for b in batches:
        js, jo = jt(js, b)
        ps, po = pt(ps, to_port(b))
        assert_tree_equal(np_tree(js), np_tree(ps))
        assert_tree_equal(np_tree(jo), np_tree(po))
        emitted += int(po.count)
    assert emitted > 0


# ----------------------------------------------------------- persistent --

def _persistent_rows(out):
    return [_rows(p_flatten, *(tree_map(lambda a: a[i], o)
                               for o in (out.outs_pre, out.outs_post)),
                  out.switched[i])
            for i in range(out.switched.shape[0])]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [1, 8])
def test_run_persistent_equals_sequential_and_reference(n, mode):
    """Five ticks in one ``run_persistent`` call, the drain mid-scan at
    tick 2: tick for tick the port's own five ``step``s and the
    reference's 1-shard ``MeshPipeline`` run one tick a call."""
    batches = _stream(5)
    got = _persistent_rows(_mesh(n, mode).run_persistent(
        [to_port(b) for b in batches], reconfig=port_reconfig(_reconfig()),
        reconfig_at=RC_AT))
    assert sum(sw for _, sw in got) == 1
    assert got == _steps(_mesh(n, mode), batches)
    assert got == _steps(_jmesh(mode), batches, port=False)


def _capture_first_call(pipe, batches, ticks=None):
    """``run_persistent_staged``'s first call on the card for the mesh's
    one device: its ticks run on a side stream, then are captured (acted
    out on the CPU by ``_Capturing``)."""
    key, operands = pipe._operands(pipe.stage_super(batches), None, 0, None)
    state = (pipe._sgs[0], pipe._epochs[0], list(pipe.blocks))
    fn = functools.partial(pipe._group_ticks, ticks or pipe._ticks)
    return pipe._graphs[0].run(key, fn, state, operands, fixed=True)


def test_a_host_read_in_a_mesh_tick_cannot_be_captured(monkeypatch):
    """The general O+ tick on 4 shards is captured (acted out on the CPU)
    and gives its eager outputs, written into the pipeline's own state
    buffers; a local tick calling ``.item()`` makes the capture raise
    ``GraphCaptureError``."""
    batches = [to_port(b) for b in _stream(2)]
    eager = _mesh(4, "general")
    want = [_rows(p_flatten, *eager.step(b)) for b in batches]
    pipe = _mesh(4, "general")
    _Capturing(monkeypatch)
    res = _capture_first_call(pipe, batches)
    assert [id(b) for b in res[2]] == [id(b) for b in pipe.blocks]
    o1, o2 = (PV.gather_outs(pipe.mesh, r) for r in res[3:5])
    got = [_rows(p_flatten, *(tree_map(lambda a: a[i], o) for o in (o1, o2)),
                 res[5][i]) for i in range(2)]
    assert got == want
    assert list(pipe.persistent_graphs()) == [("cpu", 2, 16 + 1, 3, 1)]

    def reads_the_host(state, ready):
        if int(ready.valid.sum().item()) < 0:
            raise AssertionError
        return pipe._ticks[0](state, ready)
    pipe = _mesh(4, "general")
    with pytest.raises(GraphCaptureError, match="reads nothing back"):
        _capture_first_call(pipe, batches,
                            [reads_the_host] + pipe._ticks[1:])


# ------------------------------------------------- snapshots and restore --

def _cfg(tmp, mesh, **over):
    kw = dict(op="count", wa=50, ws=100, k_virt=K, out_cap=512, n_max=8,
              n_active=4, stash_cap=STASH, checkpoint_dir=str(tmp),
              checkpoint_every=4, mesh_devices=mesh)
    kw.update(over)
    return kw


def _tail(pipe, batches, start, port=True):
    """Per-tick rows of ``batches[start:]`` through ``pipe.step``."""
    return _steps(pipe, batches[start:], port=port, rc_at=None)


def _restore(pipe, tmp, step, port=True):
    ck = (Checkpointer if port else JCheckpointer)(str(tmp))
    extra = ck.manifest(step)["extra"]
    like = (ckstream if port else jckstream).like_tree(
        pipe, extra, n_sources=1, leaf_cap=1, root_cap=1, max_leaves=1,
        out_pad=1, root_device=False)
    tree = ck.restore(step, like)
    if port:
        pipe.import_state_np(tree["pipe"])
    else:
        pipe.import_state(tree["pipe"])
    return pipe


def _port_vsn_fast():
    pop = _ops()[1]
    return VSNPipeline(
        pop, n_max=8, n_active=4, stash_cap=STASH,
        tick_fn=lambda o, s, r, m, explicit_w=None: PA.tick_fast(
            o, "count", s, r, m, explicit_w=explicit_w),
        merge_fn=PV.merge_fast_state,
        init_sigma=functools.partial(PA.fast_init, pop.resolved()),
        device=CPU)


@pytest.mark.parametrize("target", ["mesh1", "mesh2", "mesh4", "vsn",
                                    "reference-mesh1"])
def test_mesh8_snapshot_restores_elsewhere(tmp_path, target):
    """A checkpoint directory the port's 8-shard mesh wrote (step 4 of 8
    ticks) restores on the port's 1-, 2- and 4-shard meshes, on its
    ``VSNPipeline`` in the same (fast count) mode and on the reference's
    1-shard ``MeshPipeline``; each then gives the uninterrupted 8-shard
    run's ticks 4-7 tick for tick."""
    batches = _stream(8, seed=19)
    want = _steps(_mesh(8), batches, rc_at=None)[4:]
    victim = papi.build_runtime(
        papi.RuntimeConfig(device=CPU, **_cfg(tmp_path, 8)),
        ReplaySource([to_port(b) for b in batches]))
    victim.run(max_ticks=6)
    victim.checkpointer.wait()
    if target == "reference-mesh1":
        pipe = _restore(_jmesh(), tmp_path, 4, port=False)
        assert _tail(pipe, batches, 4, port=False) == want
        return
    pipe = (_port_vsn_fast() if target == "vsn"
            else _mesh(int(target[-1])))
    assert _tail(_restore(pipe, tmp_path, 4), batches, 4) == want


@pytest.mark.parametrize("n", SHARDS)
def test_reference_mesh_snapshot_restores_on_port_meshes(tmp_path, n):
    """The reference's 1-shard ``MeshPipeline`` writes the directory (its
    ``build_runtime`` with ``mesh_devices=1``); the port's meshes of 1,
    2, 4 and 8 shards restore step 4 and give the reference's ticks 4-7."""
    batches = _stream(8, seed=19)
    victim = japi.build_runtime(japi.RuntimeConfig(**_cfg(tmp_path, 1)),
                                JReplay(batches))
    victim.run(max_ticks=6)
    victim.checkpointer.wait()
    want = _steps(_jmesh(), batches, port=False, rc_at=None)[4:]
    assert _tail(_restore(_mesh(n), tmp_path, 4), batches, 4) == want


def test_kill_restore_drill_on_mesh8(tmp_path):
    """The counterpart of ``tests/test_checkpoint_restore.py``'s 8-way
    resume: a torn save, the key-blocked sigma restored on a rebuilt
    8-shard mesh, committed + replayed == the uninterrupted run."""
    batches = [to_port(b) for b in datagen.tweets(
        np.random.default_rng(19), n_ticks=12, tick=32, words_per_tweet=3,
        vocab=300, k_virt=K, rate_per_tick=30)]
    cfg = papi.RuntimeConfig(device=CPU, **_cfg(tmp_path, 8, n_active=8))
    rep = prec.kill_restore_drill(cfg, batches, mode="stop", crash_after=7,
                                  crash_mid_save=True)
    assert rep.parity, rep.summary()
    assert rep.restored_step == 4
