"""The port's ingest tier on the CPU against the JAX reference: the stacked
root-merge kernel's plain version, ``fold_reports``/``push_stacked``, the
``observe`` index repair, ``RootMerge`` (host path and fused
``device=True``), the partitioner, the single-gate oracle and
``IngestTier`` across ``add_host``/``remove_host``, all on the same numpy
inputs and compared exactly.  On the CPU the leaves merge with the
reference's ``xla`` order ``(tau, source, arrival)`` and the fused root
with ``(tau, arrival)`` in both packages, so every round agrees lane for
lane."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _torch_bridge import assert_tree_equal, np_tree, to_port
from repro.core import scalegate as JS
from repro.core import tuples as JT
from repro.core import watermark as JW
from repro.data import datagen as jdg
from repro.ingest import IngestTier as JTier
from repro.ingest import RootMerge as JRoot
from repro.ingest import SourcePartitioner as JPart
from repro.ingest import single_gate_stream as j_single
from repro.kernels.scalegate_merge.ops import \
    scalegate_merge_stacked_op as j_op
from repro_torch.core import scalegate as PS
from repro_torch.core import tuples as PT
from repro_torch.core import watermark as PW
from repro_torch.ingest import IngestTier as PTier
from repro_torch.ingest import LeafGate, RootMerge as PRoot
from repro_torch.ingest import SourcePartitioner as PPart
from repro_torch.ingest import collect_tuples, emitted_taus
from repro_torch.ingest import single_gate_stream as p_single
from repro_torch.ingest.leaf import FIELDS
from repro_torch.kernels import dispatch
from repro_torch.kernels.scalegate_merge.ops import scalegate_merge_stacked_op

INF = np.iinfo(np.int32).max


def _batch_np(b):
    return {f: np.asarray(getattr(b, f)) for f in FIELDS}


# ----------------------------------------------------- the stacked kernel --

@pytest.mark.parametrize("backend", ["pallas-interpret", "xla"])
@pytest.mark.parametrize("rows,c,seed", [(2, 32, 0), (3, 32, 1), (4, 48, 2),
                                         (6, 96, 3)])
def test_stacked_plain_equals_reference(rows, c, seed, backend):
    """The reference test's fuzzed rounds: ties across leaves, one
    all-invalid row, reports that hold some taus back."""
    rng = np.random.default_rng(seed)
    tau2 = rng.integers(0, 40, (rows, c)).astype(np.int32)
    valid2 = (rng.random((rows, c)) < 0.7).astype(np.int32)
    valid2[rng.integers(rows)] = 0
    src2 = rng.integers(0, 4, (rows, c)).astype(np.int32)
    reports = rng.integers(5, 35, (rows,)).astype(np.int32)
    want = j_op(tau2, src2, valid2, reports, backend=backend)
    before = scalegate_merge_stacked_op.launches
    got = scalegate_merge_stacked_op(*(torch.from_numpy(a) for a in
                                       (tau2, src2, valid2, reports)))
    assert scalegate_merge_stacked_op.launches == before    # plain on CPU
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ------------------------------------------------------------ watermark --

def test_observe_wraps_negative_sources_like_the_reference():
    """``frontier.at[source].max(..., mode="drop")`` wraps ids in [-n, -1]
    to n + id and drops the rest: -1 and -n land, -n-1 and n do not."""
    n = 3
    src = np.array([-1, -n, -n - 1, n, 1], np.int32)
    tau = np.array([7, 5, 11, 13, 2], np.int32)
    valid = np.array([True, True, True, True, False])
    js = JW.observe(JW.init_watermark(n), jnp.asarray(src), jnp.asarray(tau),
                    jnp.asarray(valid))
    ps = PW.observe(PW.init_watermark(n, device="cpu"), torch.from_numpy(src),
                    torch.from_numpy(tau), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(js.frontier), [5, 0, 7])
    np.testing.assert_array_equal(ps.frontier.numpy(), [5, 0, 7])


def _stacked_round(rng, t0, rows, c, n_leaves):
    tau = np.sort(t0 + rng.integers(0, 30, (rows, c)), axis=1).astype(np.int32)
    d = {"tau": tau,
         "keys": rng.integers(-1, 8, (rows, c, 2)).astype(np.int32),
         "payload": rng.integers(0, 9, (rows, c, 2)).astype(np.float32),
         "source": rng.integers(0, 4, (rows, c)).astype(np.int32),
         "valid": rng.random((rows, c)) < 0.7,
         "is_control": np.zeros((rows, c), bool),
         "ctrl_epoch": np.zeros((rows, c), np.int32)}
    reports = (t0 + rng.integers(-5, 25, n_leaves)).astype(np.int64)
    rmask = rng.random(n_leaves) < 0.8
    return d, reports, rmask


def test_fold_reports_and_push_stacked_match_reference():
    rng = np.random.default_rng(5)
    n_leaves, rows, c, cap = 4, 3, 16, 32
    active = np.array([True, True, True, False])
    js = JS.init_scalegate(n_leaves, cap, 2, 2, active=jnp.asarray(active))
    ps = PS.init_scalegate(n_leaves, cap, 2, 2, active=active, device="cpu")
    for r in range(5):
        d, reports, rmask = _stacked_round(rng, 10 * r, rows, c, n_leaves)
        jw = JW.fold_reports(js.wmark, jnp.asarray(reports, jnp.int32),
                             jnp.asarray(rmask))
        pw = PW.fold_reports(ps.wmark, reports, rmask)
        for j, q in zip(jw, pw):              # (state', eff, W)
            assert_tree_equal(np_tree(j), np_tree(q))
        js, jout = JS.push_stacked(
            js, JT.TupleBatch(**{f: jnp.asarray(v) for f, v in d.items()}),
            jnp.asarray(reports, jnp.int32), jnp.asarray(rmask),
            backend="xla")
        ps, pout = PS.push_stacked(
            ps, PT.TupleBatch(**{f: torch.from_numpy(v) for f, v in
                                 d.items()}), reports, rmask)
        assert_tree_equal(np_tree(jout), np_tree(pout))
        assert_tree_equal(np_tree(js), np_tree(ps))
    assert int(ps.overflow) > 0            # the small stash overflowed too


# ------------------------------------------------------------------ root --

def _stream(n_ticks, n_sources, seed=0, idle=None):
    """Reference tweet ticks over ``n_sources``; source ``idle`` sends
    nothing in odd ticks (its leaf then reports an idle round)."""
    out = []
    for i, b in enumerate(jdg.tweets(np.random.default_rng(seed),
                                     n_ticks=n_ticks, tick=16,
                                     words_per_tweet=3, vocab=300, k_virt=64,
                                     rate_per_tick=30, n_sources=n_sources)):
        if idle is not None and i % 2:
            b = JT.TupleBatch(**{**{f: getattr(b, f) for f in FIELDS},
                                 "valid": b.valid & (b.source != idle)})
        out.append(b)
    return out


def _leaf_rounds(batches, n_sources, n_leaves, cap=16):
    """The tier's routing without the tier: per-round LeafOuts of the
    port's leaves on the CPU, plus the final flush round."""
    part = PPart(n_sources, range(n_leaves))
    kmax, pw = batches[0].kmax, batches[0].payload_width
    gates = {l: LeafGate(l, n_sources, part.owned_mask(l), cap, kmax, pw,
                         device="cpu") for l in part.leaves}
    rounds = []
    for r, b in enumerate(batches):
        d = _batch_np(b)
        leaf_of = part.assignment[np.clip(d["source"], 0, n_sources - 1)]
        rounds.append([gates[l].push_round(
            r, {f: d[f][d["valid"] & (leaf_of == l)] for f in FIELDS})
            for l in part.leaves])
    for g in gates.values():
        g.flush_all()
    rounds.append([g.push_round(len(batches), None, final=True)
                   for g in gates.values()])
    return part, kmax, pw, rounds


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("n_leaves", [1, 2, 4])
def test_root_merge_matches_reference_round_for_round(n_leaves, fused):
    batches = _stream(6, 4, idle=3 if n_leaves == 4 else None)
    part, kmax, pw, rounds = _leaf_rounds(batches, 4, n_leaves)
    if n_leaves == 4:
        assert any(o.n_ready == 0 for outs in rounds for o in outs)
    kw = dict(out_pad=32, device=fused, check_every=1)
    max_leaves = n_leaves + 4
    jroot = JRoot(max_leaves, 32, kmax, pw, part.leaves, backend="xla", **kw)
    proot = PRoot(max_leaves, 32, kmax, pw, part.leaves, torch_device="cpu",
                  **kw)
    for outs in rounds:
        assert_tree_equal(np_tree(jroot.push(outs)), np_tree(proot.push(outs)))
    jroot.sync_stats()
    proot.sync_stats()
    for attr in ("tuples_out", "rounds", "wmark", "last_emitted_tau"):
        assert getattr(jroot, attr) == getattr(proot, attr), attr
    assert proot.tuples_out == sum(int(np.asarray(b.valid).sum())
                                   for b in batches)
    snap = proot.export_state()
    assert_tree_equal(np_tree(jroot.export_state()["sg"]), snap["sg"])
    again = PRoot(max_leaves, 32, kmax, pw, part.leaves, torch_device="cpu",
                  **kw)
    again.import_state(snap)
    assert_tree_equal(np_tree(again.state), np_tree(proot.state))
    assert again.state.capacity == PRoot.effective_cap(32, 32, fused)
    assert PRoot.effective_cap(40, 32, fused) == \
        JRoot.effective_cap(40, 32, fused)


# ---------------------------------------------------- partition + oracle --

def test_partitioner_matches_reference():
    jp, pp = JPart(7, range(3)), PPart(7, range(3))
    for change in (dict(add=[3]), dict(remove=[0]), dict(add=[5, 6]),
                   dict(remove=[1, 3])):
        assert jp.rebalance(**change) == pp.rebalance(**change)
        np.testing.assert_array_equal(jp.assignment, pp.assignment)
        assert jp.leaves == pp.leaves and jp.counts() == pp.counts()


def test_single_gate_oracle_matches_reference():
    batches = _stream(5, 3, seed=2)
    want = j_single(batches, 3, cap=32, backend="xla")
    got = p_single([to_port(b) for b in batches], 3, cap=32, device="cpu")
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert_tree_equal(np_tree(w), np_tree(g))
    np.testing.assert_array_equal(emitted_taus(got),
                                  np.concatenate([np.asarray(w.tau)[np.asarray(
                                      w.valid)] for w in want]))


# ------------------------------------------------------------------ tier --

def _tiers(worker, fused, batches, **kw):
    common = dict(worker=worker, leaf_cap=16, root_cap=32, out_pad=32,
                  root_device=fused, record=True, root_check_every=1, **kw)
    jt = JTier(batches, 4, 2, backend="xla", **common)
    pt = PTier([to_port(b) for b in batches], 4, 2, device="cpu", **common)
    for t in (jt, pt):
        t.add_host(at_tick=2)
        t.remove_host(0, at_tick=5)
    return jt, pt


@pytest.mark.parametrize("worker,fused", [("inline", False), ("inline", True),
                                          ("thread", False), ("thread", True)])
def test_tier_matches_reference_per_round(worker, fused):
    batches = _stream(8, 4, seed=1)
    jt, pt = _tiers(worker, fused, batches)
    jouts, pouts = list(jt), list(pt)
    assert len(jouts) == len(pouts) == 8 + 2 + 1   # ticks, 2 reconfigs, flush
    for w, g in zip(jouts, pouts):
        assert_tree_equal(np_tree(w), np_tree(g))
    js, ps = jt.stats(), pt.stats()
    for attr in ("leaves", "rounds", "ticks", "tuples_in", "tuples_out",
                 "watermark", "root_overflow", "leaf_overflow"):
        assert getattr(js, attr) == getattr(ps, attr), attr
    assert ps.tuples_in == ps.tuples_out > 0
    assert len(ps.attach_ms) == len(ps.detach_ms) == 1
    assert (np.diff(emitted_taus(pouts)) >= 0).all()


def test_tier_process_workers():
    """Leaves in spawned child processes (each resolves its device
    itself): the same rounds as the inline tier."""
    batches = [to_port(b) for b in _stream(4, 4, seed=3)]
    kw = dict(leaf_cap=16, root_cap=32, out_pad=32, root_device=True,
              record=True, device="cpu")
    proc = list(PTier(batches, 4, 2, worker="process", **kw))
    inline = list(PTier(batches, 4, 2, worker="inline", **kw))
    assert len(proc) == len(inline)
    for a, b in zip(proc, inline):
        assert_tree_equal(np_tree(a), np_tree(b))
    assert collect_tuples(proc) == collect_tuples(batches)


def test_fused_root_launches_no_kernel_on_the_cpu():
    batches = [to_port(b) for b in _stream(3, 2, seed=6)]
    dispatch.reset_launches()
    list(PTier(batches, 2, 2, worker="inline", leaf_cap=16, root_cap=32,
               root_device=True, device="cpu"))
    assert all(k.launches == 0 for k in dispatch.registered().values())
