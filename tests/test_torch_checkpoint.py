"""The port's checkpoint substrate on the CPU against the JAX reference
(``tests/test_substrate.py:23-34``, ``tests/test_checkpoint_restore.py:
55-117``): the same tree saved by either package gives equal manifests
and byte-equal leaf files, a directory either package wrote restores in
the other (a bfloat16 leaf among them), the atomic commit, racing async
saves, one pending save at a time, the module-level wrappers,
``RuntimeConfig``'s JSON read by both packages and its
``checkpoint_every % super_batch`` guard, a capture that later in-place
writes to the pipeline's state cannot reach, a checkpoint directory the
reference's victim wrote resumed by the port's ``resume_runtime`` (state
carried across the packages), and the CPU rehearsal of
``chip_smoke.q1_recovery``."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import ml_dtypes

from _torch_bridge import np_tree, to_port
from repro import api as japi
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import checkpoint as JC
from repro.core import watermark as JW
from repro.data import datagen as jdg
from repro.io import ReplaySource as JReplay
from repro.launch import recovery as jrec
from repro_torch import api as papi
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpoint as C
from repro_torch.checkpoint.stream import StreamCheckpointer
from repro_torch.core import watermark as PW
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 64


def _values():
    rng = np.random.default_rng(3)
    return dict(
        i64=rng.integers(-9, 9, (2, 3)).astype(np.int64),
        i32=rng.integers(-9, 9, (5,)).astype(np.int32),
        f32=rng.standard_normal((4, 2)).astype(np.float32),
        bf16=rng.standard_normal((3, 4)).astype(np.float32),
        frontier=rng.integers(0, 99, (6,)).astype(np.int32),
        active=rng.random(6) > 0.5,
        scalar=np.int32(7))


def _port_tree(v):
    """Nested dicts, a dataclass (``WatermarkState``) and every dtype of
    the reference's codec, bfloat16 included, as port tensors."""
    t = {k: torch.from_numpy(np.array(a)) for k, a in v.items()}
    return {"z": {"b": t["i64"], "a": t["f32"]},
            "bf": t["bf16"].to(torch.bfloat16),
            "wm": PW.WatermarkState(frontier=t["frontier"],
                                    active=t["active"]),
            "m": {"i32": t["i32"], "s": t["scalar"]}}


def _ref_tree(v):
    # int64 as numpy, as the reference's tier frontier (jax runs 32-bit)
    return {"z": {"b": np.asarray(v["i64"]), "a": jnp.asarray(v["f32"])},
            "bf": jnp.asarray(v["bf16"], jnp.bfloat16),
            "wm": JW.WatermarkState(frontier=jnp.asarray(v["frontier"]),
                                    active=jnp.asarray(v["active"])),
            "m": {"i32": jnp.asarray(v["i32"]),
                  "s": jnp.asarray(v["scalar"])}}


def _bits(tree):
    """Every leaf as raw bytes + dtype name, in the reference's order."""
    out = []
    for leaf in C.flatten(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                out.append(("bfloat16",
                            leaf.view(torch.int16).numpy().tobytes()))
            else:
                out.append((str(leaf.numpy().dtype), leaf.numpy().tobytes()))
        else:
            a = np.asarray(leaf)
            out.append((str(a.dtype), a.tobytes()))
    return out


def test_same_tree_same_manifest_and_files(tmp_path):
    v = _values()
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(pd).save(5, _port_tree(v), async_=False,
                          extra={"step": 5})
    JCheckpointer(jd).save(5, _ref_tree(v), async_=False,
                           extra={"step": 5})
    pm = Checkpointer(pd).manifest(5)
    assert pm == JCheckpointer(jd).manifest(5)
    assert "bfloat16" in pm["dtypes"] and pm["n_leaves"] == 7
    for i in range(pm["n_leaves"]):
        name = f"step_{5:08d}/leaf_{i:05d}.npy"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_directory_restores_in_the_other_package(tmp_path, direction):
    v = _values()
    d = str(tmp_path)
    if direction == "port_to_reference":
        C.save(d, 3, _port_tree(v), async_=False)
        C.wait(d)
        got = JC.restore(d, 3, _ref_tree({k: np.zeros_like(a)
                                          for k, a in v.items()}))
        # the reference restores through jnp.asarray (int64 -> int32)
        want = jax.tree.map(jnp.asarray, _ref_tree(v))
        assert got["bf"].dtype == jnp.bfloat16
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                else np.asarray(a),
                np.asarray(b).view(np.uint16) if b.dtype == jnp.bfloat16
                else np.asarray(b))
    else:
        JC.save(d, 3, _ref_tree(v), async_=False)
        got = C.restore(d, 3, _port_tree({k: np.zeros_like(a)
                                          for k, a in v.items()}))
        assert isinstance(got["wm"], PW.WatermarkState)
        assert got["bf"].dtype == torch.bfloat16
        assert _bits(got) == _bits(_port_tree(v))


def test_bf16_round_trip_through_the_port_alone(tmp_path):
    x = torch.randn(7, 5).to(torch.bfloat16)
    C.save(str(tmp_path), 1, {"x": x}, async_=False)
    back = C.restore(str(tmp_path), 1, {"x": torch.zeros(7, 5)})["x"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    raw = np.load(tmp_path / "step_00000001" / "leaf_00000.npy")
    assert raw.dtype == np.uint16       # the reference's stored view
    np.testing.assert_array_equal(
        raw.view(ml_dtypes.bfloat16).astype(np.float32), x.float().numpy())


def test_torn_save_invisible_to_latest_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3)}
    ck.save(4, tree, async_=False, extra={"step": 4})
    torn = os.path.join(str(tmp_path), "step_00000008")
    os.makedirs(torn)
    np.save(os.path.join(torn, "leaf_00000.npy"), np.zeros(3))
    assert ck.latest_step() == 4
    assert JC.latest_step(str(tmp_path)) == 4
    step, got = ck.restore_latest({"a": np.zeros((2, 3), np.int64)})
    assert step == 4
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    with pytest.raises(AssertionError, match="shape"):
        ck.restore(4, {"a": np.zeros((3, 2), np.int64)})


def test_async_saves_from_racing_threads(tmp_path):
    """Per-object pending bookkeeping: N threads each drive their own
    async save into the same Checkpointer; wait() blocks until every write
    landed and every step restores bit-exact."""
    ck = Checkpointer(str(tmp_path))
    steps = list(range(1, 9))

    def _save(s):
        ck.save(s, {"x": np.full((4,), s, np.int64)}, async_=True,
                extra={"step": s})

    ths = [threading.Thread(target=_save, args=(s,)) for s in steps]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=30)
        assert not t.is_alive()
    ck.wait()
    assert ck.latest_step() == 8
    for s in steps:
        got = ck.restore(s, {"x": np.zeros((4,), np.int64)})
        assert (got["x"] == s).all()
        assert ck.manifest(s)["extra"]["step"] == s


def test_one_pending_save_at_a_time(tmp_path, monkeypatch):
    """A second save returns only once the first one's write finished."""
    ck = Checkpointer(str(tmp_path))
    real = np.save
    gate = threading.Event()

    def slow_save(path, arr):
        gate.wait(timeout=10)
        real(path, arr)

    monkeypatch.setattr(C.np, "save", slow_save)
    ck.save(1, {"x": np.ones(3)})
    first = ck._pending
    assert first.is_alive()
    threading.Timer(0.2, gate.set).start()
    t0 = time.perf_counter()
    ck.save(2, {"x": np.ones(3)})
    assert not first.is_alive() and time.perf_counter() - t0 >= 0.15
    ck.wait()
    assert ck._pending is None and ck.latest_step() == 2


def test_module_level_wrappers(tmp_path):
    """``save``/``wait``/``latest_step``/``read_manifest``/``restore``/
    ``restore_latest`` (the reference's ``test_checkpoint_roundtrip`` and
    crash drill), async through the per-directory registry."""
    d = str(tmp_path)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    C.save(d, 3, tree)
    C.save(d, 7, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}},
           extra={"k": 1})
    C.wait(d)
    assert C.latest_step(d) == 7 and C.read_manifest(d, 7)["extra"] == \
        {"k": 1}
    got = C.restore(d, 7, tree)
    assert torch.equal(got["a"], tree["a"] * 2)
    os.makedirs(os.path.join(d, "step_00000009"))       # crashed save
    step, got = C.restore_latest(d, tree)
    assert step == 7 and torch.equal(got["b"]["c"], torch.full((4,), 2.0))
    assert C.latest_step(str(tmp_path / "none")) is None
    assert C.restore_latest(str(tmp_path / "none"), tree) == (None, None)


# ---------------------------------------------------------- RuntimeConfig --

def test_runtime_config_json_read_by_both_packages(tmp_path):
    shared = dict(op="count", wa=50, ws=100, k_virt=K, out_cap=512,
                  n_max=8, n_active=4, stash_cap=64, n_sources=4,
                  ingest_hosts=2, ingest_worker="process", super_batch=2,
                  checkpoint_dir=str(tmp_path), checkpoint_every=8)
    pcfg = papi.RuntimeConfig(device="cpu", root_device=True, **shared)
    jcfg = japi.RuntimeConfig(root_device=True, **shared)
    from_port = japi.RuntimeConfig.from_json(
        json.loads(json.dumps(pcfg.to_json())))       # "device" ignored
    from_ref = papi.RuntimeConfig.from_json(
        json.loads(json.dumps(jcfg.to_json())))       # "backend" ignored
    assert from_port == jcfg
    assert from_ref == dataclasses.replace(pcfg, device=None)
    assert papi.RuntimeConfig.from_json(pcfg.to_json()) == pcfg


@pytest.mark.parametrize("super_batch,every",
                         [(3, 4), (2, 4), (4, 4), (8, 4), (1, 3), (4, 0)])
def test_checkpoint_super_batch_guard_matches_reference(super_batch, every):
    kw = dict(super_batch=super_batch, checkpoint_every=every)
    try:
        japi.RuntimeConfig(**kw)
        refused = False
    except AssertionError:
        refused = True
    if refused:
        with pytest.raises(AssertionError, match="multiple of super_batch"):
            papi.RuntimeConfig(**kw)
    else:
        papi.RuntimeConfig(**kw)


# ------------------------------------------------------- the capture copy --

def test_capture_is_a_copy_later_writes_cannot_reach(tmp_path):
    """``maybe_save`` copies the pipeline's state before it returns: the
    state written in place afterwards (as a graph replay writes it on the
    card; ``tensor.numpy()`` would share CPU memory) leaves the checkpoint
    at the step's state, and ``resume_runtime``'s restore gives it back."""
    cfg = papi.RuntimeConfig(op="count", wa=50, ws=100, k_virt=K,
                             out_cap=512, n_max=8, n_active=4, stash_cap=64,
                             device="cpu", checkpoint_dir=str(tmp_path),
                             checkpoint_every=4)
    pipe = papi.make_pipeline(cfg)
    batches = list(jdg.tweets(np.random.default_rng(2), n_ticks=2, tick=16,
                              words_per_tweet=3, vocab=300, k_virt=K,
                              rate_per_tick=30))
    for b in batches:
        pipe.step(to_port(b))
    want = np_tree(tree_map(torch.clone, pipe.export_state()))
    sck = StreamCheckpointer(Checkpointer(str(tmp_path)), 4, pipe,
                             config=cfg)
    assert sck.maybe_save(3, np.zeros(1)) is None        # not due
    assert sck.maybe_save(4, np.zeros(1)) == 4
    pipe.sg.stash.tau.add_(1)
    pipe.epoch.fmu.add_(1)
    pipe.sigma.occupied.logical_not_()
    sck.wait()
    from repro_torch.checkpoint import stream as ckstream
    extra = Checkpointer(str(tmp_path)).manifest(4)["extra"]
    fresh = papi.make_pipeline(cfg)
    like = ckstream.like_tree(fresh, extra, n_sources=1, leaf_cap=1,
                              root_cap=1, max_leaves=1, out_pad=1,
                              root_device=None)
    got = Checkpointer(str(tmp_path)).restore(4, like)
    fresh.import_state_np(got["pipe"])
    assert extra["step"] == 4 and extra["tier"] is None
    assert _equal(np_tree(fresh.export_state()), want)


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


# ----------------------------------------- state carried across packages --

@pytest.mark.parametrize("tiered", [False, True], ids=["pipeline", "tier"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, tiered):
    """The reference's victim writes the checkpoints; the port's
    ``resume_runtime(..., device="cpu")`` rebuilds the stack from the
    reference's manifest and replays: the reference's committed outputs
    plus the port's replayed ones equal the reference's oracle."""
    over = (dict(n_sources=4, ingest_hosts=2, ingest_worker="inline",
                 leaf_cap=32, root_cap=64) if tiered else {})
    batches = list(jdg.tweets(np.random.default_rng(19), n_ticks=8, tick=16,
                              words_per_tweet=3, vocab=300, k_virt=K,
                              rate_per_tick=30,
                              n_sources=4 if tiered else 1))
    jcfg = japi.RuntimeConfig(op="count", wa=50, ws=100, k_virt=K,
                              out_cap=512, n_max=8, n_active=4, stash_cap=64,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=4, **over)
    n_in = max(jcfg.n_sources, 1)
    oracle = jrec.oracle_results(jcfg, batches)
    victim = japi.build_runtime(jcfg, JReplay(batches, n_inputs=n_in))
    victim.run(max_ticks=6)
    victim.checkpointer.wait()
    resumed = papi.resume_runtime(str(tmp_path),
                                  [to_port(b) for b in batches],
                                  device="cpu")
    resumed.run()
    step = resumed.restored_step
    assert step == 4
    committed = victim.sink.results(before_tick=step)
    assert sorted(committed + resumed.sink.results()) == sorted(oracle)


def test_q1_recovery_rehearsal():
    """``chip_smoke.q1_recovery`` on the CPU: the fast count tick in
    super-batches of 4 with a checkpoint every 4, a join before the cut
    and a leave after it, the restore's steps on a fresh pipeline, and
    parity with its own oracle (the card runs it at full width)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # one intra-op thread: beside the tier's leaf threads and the other
    # test workers, torch's thread pool only spins
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = cs.q1_recovery("cpu", n_ticks=16, tick=64, k_virt=256, k=4,
                           join_at=5, leave_at=12, crash_after=11,
                           want_step=9)
    finally:
        torch.set_num_threads(threads)
    assert r["restored_step"] == 9 and r["restored_source_ticks"] == 8
    assert r["saved_steps"] == [4, 9] and r["parity"]
    assert r["committed"] + r["replayed"] == r["outputs"] > 0
    assert r["checkpoint_leaves"] > 0 and r["checkpoint_bytes"] > 0
