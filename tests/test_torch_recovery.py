"""Exactly-once recovery in the port on the CPU against the JAX reference:
``kill_restore_drill`` on the general O+ tick
(``tests/test_checkpoint_restore.py:137-171``), resume after the stream's
end, the ingest tier's snapshot rounds against the reference's payloads,
resume over a tier and a SIGKILLed process leaf
(``tests/test_elastic_chaos.py:174-208``).  The port's general tick takes
about a second a tick here, so the streams are short; the parity oracle
is the reference's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_bridge import assert_tree_equal, np_tree, to_port
from repro import api as japi
from repro.data import datagen as jdg
from repro.ingest import IngestTier as JTier
from repro.io import ReplaySource as JReplay
from repro.launch import recovery as jrec
from repro_torch import api as papi
from repro_torch.ingest import IngestTier as PTier
from repro_torch.io.sources import ReplaySource
from repro_torch.launch import recovery as prec

K, N_SRC = 64, 4


def _stream(n_ticks=8, seed=13, n_sources=1):
    return list(jdg.tweets(np.random.default_rng(seed), n_ticks=n_ticks,
                           tick=16, words_per_tweet=3, vocab=300, k_virt=K,
                           rate_per_tick=30, n_sources=n_sources))


def _cfgs(tmp, **over):
    """The same config for both packages; the port's on the CPU."""
    kw = dict(op="count", wa=50, ws=100, k_virt=K, out_cap=512, n_max=8,
              n_active=4, stash_cap=64, checkpoint_dir=str(tmp),
              checkpoint_every=4)
    kw.update(over)
    return japi.RuntimeConfig(**kw), papi.RuntimeConfig(device="cpu", **kw)


def _report(rep):
    return (rep.restored_step, rep.parity, rep.n_committed, rep.n_replayed,
            rep.n_oracle)


def test_kill_restore_drill_matches_reference(tmp_path):
    """Same ``RecoveryReport`` fields; the port's committed + replayed
    multiset equals the reference's oracle (parity is held against it)."""
    batches = _stream()
    jcfg, _ = _cfgs(tmp_path / "j")
    _, pcfg = _cfgs(tmp_path / "p")
    jrep = jrec.kill_restore_drill(jcfg, batches, mode="stop",
                                   crash_after=6, crash_mid_save=True)
    prep = prec.kill_restore_drill(
        pcfg, [to_port(b) for b in batches], mode="stop", crash_after=6,
        crash_mid_save=True, oracle=jrec.oracle_results(jcfg, batches))
    assert prep.parity and _report(prep) == _report(jrep)
    assert prep.restored_step == 4 and prep.detect_to_recover_ms > 0


def test_resume_after_stream_end_flush_only(tmp_path):
    """A tier snapshot on the final flush round covers the whole stream:
    resume has an empty replay suffix and must still rebuild the gates at
    their restored shapes and flush; committed + resumed == the full run
    == the reference's full run."""
    batches = _stream(n_sources=N_SRC, seed=17)
    tier = dict(n_sources=N_SRC, ingest_hosts=2, leaf_cap=32, root_cap=64)
    jcfg, pcfg = _cfgs(tmp_path, **tier)
    rt = papi.build_runtime(pcfg, ReplaySource(
        [to_port(b) for b in batches], n_inputs=N_SRC))
    rt.run()
    rt.checkpointer.wait()
    saved = rt.checkpointer.saved_steps
    assert saved == [4, 8]
    resumed = papi.resume_runtime(str(tmp_path), [to_port(b)
                                                  for b in batches])
    assert resumed.runtime.pipeline.device.type == "cpu"
    resumed.run()
    assert resumed.restored_step == max(saved)
    full = rt.sink.results()
    committed = rt.sink.results(before_tick=resumed.restored_step)
    assert sorted(committed + resumed.sink.results()) == sorted(full)
    jcfg = dataclasses.replace(jcfg, checkpoint_dir=None, checkpoint_every=0)
    jrt = japi.build_runtime(jcfg, JReplay(batches, n_inputs=N_SRC))
    jrt.run()
    assert full == jrt.sink.results()


def _snapshots(tier):
    """Every cut the tier assembles, by ``emitted_rounds``."""
    out = {}
    for _ in tier:
        snap = tier.latest_snapshot()
        if snap is not None:
            out[snap["emitted_rounds"]] = tier.pop_snapshot(
                snap["emitted_rounds"])
    return out


@pytest.mark.parametrize("worker", ["inline", "thread"])
def test_tier_snapshot_rounds_match_reference(worker):
    """At each cut ``pop_snapshot`` gives the reference's payload:
    frontier, assignment, leaf states, root gate and counters, with a
    join before one cut and a leave after it.  The reference's inline
    tier is the reference: its thread tier reads the assignment when the
    consumer stores the cut, after its router may already have applied
    a later command (the port captures it with the snap round)."""
    batches = _stream(n_ticks=8, seed=5, n_sources=N_SRC)
    kw = dict(leaf_cap=32, root_cap=64, out_pad=32, snapshot_every=2)

    def churn(t):
        t.add_host(at_tick=3)
        t.remove_host(0, at_tick=6)
        return t

    want = _snapshots(churn(JTier(batches, N_SRC, 2, worker="inline",
                                  backend="xla", **kw)))
    got = _snapshots(churn(PTier([to_port(b) for b in batches], N_SRC, 2,
                                 worker=worker, device="cpu", **kw)))
    assert sorted(got) == sorted(want) == [2, 5, 7, 10]
    for key in want:
        w, g = want[key], got[key]
        for f in ("leaves", "assignment", "next_leaf_id", "source_ticks",
                  "emitted_rounds", "tuples_in"):
            assert g[f] == w[f], (key, f)
        np.testing.assert_array_equal(g["frontier"], w["frontier"])
        assert sorted(g["leaf_states"]) == sorted(w["leaf_states"])
        for lid in w["leaf_states"]:
            assert_tree_equal(np_tree(g["leaf_states"][lid]),
                              np_tree(w["leaf_states"][lid]))
        assert_tree_equal(np_tree(g["root"]["sg"]), np_tree(w["root"]["sg"]))
        assert g["root"]["meta"] == w["root"]["meta"]


def test_resume_with_a_tier_matches_reference(tmp_path):
    """The count stream through the full stack (tier + pipeline +
    checkpoints, thread workers): crash after 6 ticks with a torn newer
    save on disk; the port restores step 4 and replays to the
    reference's oracle, with the reference's report."""
    batches = _stream(n_ticks=8, seed=21, n_sources=N_SRC)
    tier = dict(n_sources=N_SRC, ingest_hosts=2, leaf_cap=32, root_cap=64)
    jcfg, _ = _cfgs(tmp_path / "j", **tier)
    _, pcfg = _cfgs(tmp_path / "p", **tier)
    jrep = jrec.kill_restore_drill(jcfg, batches, mode="stop",
                                   crash_after=6, crash_mid_save=True)
    prep = prec.kill_restore_drill(
        pcfg, [to_port(b) for b in batches], mode="stop", crash_after=6,
        crash_mid_save=True, oracle=jrec.oracle_results(jcfg, batches))
    assert prep.parity, prep.summary()
    assert _report(prep) == _report(jrep)
    assert prep.restored_step == 4


def test_sigkill_process_leaf_mid_backpressure(tmp_path):
    """A process leaf SIGKILLed with every channel full (chan_cap=1) and a
    torn save planted: the tier raises ``LeafFailure`` with its detection
    stamp, and the port restores from the latest complete manifest to the
    reference's oracle."""
    batches = _stream(n_ticks=12, seed=21, n_sources=N_SRC)
    jcfg, pcfg = _cfgs(tmp_path, n_sources=N_SRC, ingest_hosts=2,
                       leaf_cap=32, root_cap=64, ingest_worker="process",
                       chan_cap=1)
    oracle = jrec.oracle_results(dataclasses.replace(
        jcfg, ingest_worker="inline"), batches)
    rep = prec.kill_restore_drill(pcfg, [to_port(b) for b in batches],
                                  mode="sigkill", crash_after=6,
                                  crash_mid_save=True, oracle=oracle)
    assert rep.parity, rep.summary()
    assert rep.restored_step >= pcfg.checkpoint_every
    assert rep.restored_step % pcfg.checkpoint_every == 0
    assert rep.detect_to_recover_ms > 0
