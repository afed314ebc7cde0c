"""The port's serving tier on the CPU, mirroring ``tests/test_serving.py``:
the engine equals the port's ``reference_decode`` (continuous batching,
slot reuse and a mid-decode VSN reconfiguration are token-invisible),
release zeroes the slot, SN moves bytes where VSN moves none; the port's
engine gives the reference engine's tokens in float32 on the same carried
weights; the request stream equals the reference's; and the whole stack
through ``build_runtime`` equals ``run_sync`` and ``reference_decode``."""

import dataclasses
import gc
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.configs import canon, get_config, reduced
from repro.io.sources import RateSchedule as JRateSchedule
from repro.models import transformer as RT
from repro.serving import Request as JRequest
from repro.serving import RequestSource as JRequestSource
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as pconfigs
from repro_torch.core.async_runtime import run_sync
from repro_torch.io.sources import RateSchedule
from repro_torch.models import convert, transformer as PT
from repro_torch.serving import (Request, RequestSource, ServingConfig,
                                 ServingEngine, reference_decode)

MAX_SEQ = 24
ARCHS = ["qwen3-14b", "rwkv6-7b"]


def _cfg(arch, dtype=None):
    cfg = pconfigs.reduced(pconfigs.get_config(pconfigs.canon(arch)))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = _cfg(request.param)
    return request.param, cfg, PT.init_params(cfg, seed=0, device="cpu")


def _engine(cfg, params, n_slots, n_instances):
    return ServingEngine(cfg, params, n_slots=n_slots, max_seq=MAX_SEQ,
                         n_instances=n_instances, device="cpu")


def _prompts(cfg, n, length=4, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, length) for _ in range(n)]


def _run(eng, reqs, cap=200, reconfigure=None):
    for r in reqs:
        eng.submit(r)
    done = []
    while len(done) < len(reqs) and eng.steps < cap:
        done += eng.tick()
        if reconfigure is not None and eng.steps == 2:
            reconfigure()
    assert len(done) == len(reqs)
    return done


# ------------------------------------------------------- decode parity --

def test_engine_matches_reference(model):
    """Continuous batching is token-invisible, the first token included;
    the engine counts one prefill per request and one forward per round."""
    _, cfg, params = model
    eng = _engine(cfg, params, 4, 2)
    reqs = [Request(uid=i, prompt=p, max_new=4)
            for i, p in enumerate(_prompts(cfg, 3))]
    for r in _run(eng, reqs):
        assert list(r.out) == reference_decode(cfg, params, r.prompt,
                                               r.max_new, MAX_SEQ), r.uid
    assert eng.prefills == 3 and eng.decode_rounds == 3


def test_slot_reuse_no_state_leak(model):
    _, cfg, params = model
    eng = _engine(cfg, params, 1, 1)
    pa, pb = _prompts(cfg, 2, seed=5)
    (ra,) = _run(eng, [Request(uid=0, prompt=pa, max_new=5)])
    assert ra.slot == 0
    (rb,) = _run(eng, [Request(uid=1, prompt=pb, max_new=5)])
    assert rb.slot == 0            # same physical slot, reused
    assert list(rb.out) == reference_decode(cfg, params, pb, 5, MAX_SEQ)


def test_release_zeroes_slot(model):
    _, cfg, params = model
    eng = _engine(cfg, params, 2, 1)
    _run(eng, [Request(uid=0, prompt=_prompts(cfg, 1)[0], max_new=3)])
    assert sorted(eng.pool.free) == [0, 1]
    for tree in (eng.pool.caches, eng.pool.states):
        for leaf in (tree or {}).values():
            assert not leaf.any()


def test_reconfigure_vsn_mid_decode_invariance(model):
    _, cfg, params = model
    eng = _engine(cfg, params, 4, 4)
    eng.pool.reconfigure_vsn(1)
    rec = {}

    def scale_up():
        rec["moved"], _ = eng.reconfigure(4, mode="vsn")

    reqs = [Request(uid=i, prompt=p, max_new=5)
            for i, p in enumerate(_prompts(cfg, 4, seed=2))]
    for r in _run(eng, reqs, reconfigure=scale_up):
        assert list(r.out) == reference_decode(cfg, params, r.prompt,
                                               r.max_new, MAX_SEQ), r.uid
    assert rec["moved"] == 0
    assert eng.pool.n_active == 4 and eng.pool.kv_bytes_moved == 0


def test_sn_moves_bytes_vsn_does_not(model):
    """The SN baseline ships the occupied moved slots' KV/state through the
    host and the tokens stay those of ``reference_decode``; VSN moves
    nothing for the same switch."""
    _, cfg, params = model
    eng = _engine(cfg, params, 4, 4)
    eng.pool.reconfigure_vsn(1)
    reqs = [Request(uid=i, prompt=p, max_new=6)
            for i, p in enumerate(_prompts(cfg, 2, seed=3))]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    occupied = eng.pool.occupied()
    assert len(occupied) == 2
    old = eng.pool.fmu.copy()
    moved, _ = eng.reconfigure(4, mode="sn")
    should_move = [s for s in occupied if old[s] != eng.pool.fmu[s]]
    assert moved == len(should_move) * eng.pool.slot_bytes() > 0
    assert eng.pool.kv_bytes_moved == moved
    done = _run(eng, [])
    while eng.running:
        done += eng.tick()
    for r in done:
        assert list(r.out) == reference_decode(cfg, params, r.prompt,
                                               r.max_new, MAX_SEQ), r.uid

    eng2 = _engine(cfg, params, 4, 4)
    eng2.pool.reconfigure_vsn(1)
    moved2, _ = eng2.reconfigure(4, mode="vsn")
    assert moved2 == 0 and eng2.pool.kv_bytes_moved == 0


# the token models the engine serves, past the first four: gemma3's
# local layers (window 8 reduced, crossed by these requests' positions),
# stablelm's untied dense stack, qwen3-moe's top-k over many experts
TOKEN_ARCHS = ["deepseek-moe-16b", "hymba-1.5b", "gemma3-4b", "stablelm-12b",
               "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch,layers", [
    pytest.param(a, None, id=a) for a in ARCHS + TOKEN_ARCHS] + [
    pytest.param("gemma3-4b", 6, id="gemma3-4b-6layers")])
def test_engine_tokens_equal_the_reference_engine(arch, layers):
    """Float32, the reference's parameters carried across: the port's
    engine and the reference's give the same tokens for the same requests
    (with slot reuse: 5 requests through 3 slots, positions up to 10).
    The MoE routes each decode lane alone, as the reference's per-lane
    ``vmap`` does; the hybrid carries its SSM state by slot; gemma3's
    layers mask keys past their window of 8, and at 6 layers the sixth is
    global."""
    cut = {} if layers is None else dict(n_layers=layers)
    cfg = dataclasses.replace(reduced(get_config(canon(arch))),
                              dtype="float32", **cut)
    pcfg = dataclasses.replace(_cfg(arch, "float32"), **cut)
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    prompts = _prompts(cfg, 5, length=5, seed=9)
    jeng = JServingEngine(cfg, params, n_slots=3, max_seq=MAX_SEQ,
                          n_instances=1)
    want = {r.uid: list(r.out) for r in _run(
        jeng, [JRequest(uid=i, prompt=p, max_new=6)
               for i, p in enumerate(prompts)])}
    got = {r.uid: list(r.out) for r in _run(
        _engine(pcfg, pp, 3, 1), [Request(uid=i, prompt=p, max_new=6)
                                  for i, p in enumerate(prompts)])}
    assert got == want


# ------------------------------------------------------- stream runtime --

def test_request_stream_equals_the_references():
    kw = dict(ticks=9, lanes=3, prompt_len=4, max_new=4, seed=5, n_inputs=2,
              k_virt=4, tick_ms=50, drain_ticks=3)
    phases = ((0, 40.0), (3, 160.0), (6, 40.0))
    want = list(JRequestSource(schedule=JRateSchedule(phases), **kw))
    src = RequestSource(schedule=RateSchedule(phases), **kw)
    got = list(src)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.device.type == "cpu"                # host tuples
        for f in ("tau", "keys", "payload", "source", "valid"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)), f)
    assert src.total_requests > 0


def _serving_stack(*, controller="none", ticks=6, slo_target_ms=50.0,
                   obs=None, seed=11, ingest_hosts=0):
    from repro_torch.api import RuntimeConfig, build_runtime
    scfg = ServingConfig(arch="qwen3-14b", reduced=True, n_slots=4,
                         max_seq=MAX_SEQ, n_instances=4)
    cfg = RuntimeConfig(serving=scfg, n_sources=2, n_active=1,
                        controller=controller, device="cpu",
                        ingest_hosts=ingest_hosts,
                        slo_target_p99_ms=slo_target_ms, obs=obs or {})
    src = RequestSource(schedule=RateSchedule([(0, 60.0)]), ticks=ticks,
                        lanes=2, prompt_len=4, max_new=4, seed=seed,
                        n_inputs=2, k_virt=4, tick_ms=50,
                        drain_ticks=ticks * 2 * 4 // 4 + 12)
    return build_runtime(cfg, src), src


def test_build_runtime_serving_parity_with_run_sync():
    """Requests through the async stack (tuple encode -> runtime ->
    admission -> batched decode) come out token-identical to the
    synchronous loop over the same pipeline config and to the
    straight-line reference."""
    from repro_torch.api import make_pipeline
    rt, src = _serving_stack()
    rt.run()
    pipe = rt.pipeline
    assert len(pipe.finished) == src.total_requests > 0
    got = {r.uid: list(r.out) for r in pipe.finished}
    cfg, params = pipe.engine.cfg, pipe.engine.params
    for r in pipe.finished:
        assert list(r.out) == reference_decode(cfg, params, r.prompt,
                                               r.max_new, MAX_SEQ), r.uid
    sync_pipe = make_pipeline(rt.config)
    rep, _ = run_sync(sync_pipe, src)
    assert rep.ticks == len(src)
    assert {r.uid: list(r.out) for r in sync_pipe.finished} == got


def test_ingest_tier_parity():
    """The same request stream through a 2-host ingest tier (on the CPU)
    serves every request with the tierless run's outputs."""
    rt0, src0 = _serving_stack(seed=13)
    rt0.run()
    want = {r.uid: list(r.out) for r in rt0.pipeline.finished}
    rt, src = _serving_stack(ingest_hosts=2, seed=13)
    rt.run()
    got = {r.uid: list(r.out) for r in rt.pipeline.finished}
    assert len(got) == src.total_requests == src0.total_requests
    assert got == want


def test_slo_breach_drives_scale_up():
    """An unmeetable p99 decode target makes the SLO engine breach and the
    controller provision replicas mid-run, moving no KV bytes."""
    from repro_torch import obs as _obs
    prev = _obs.get()
    try:
        rt, src = _serving_stack(
            controller="slo", ticks=10, slo_target_ms=1e-3,
            obs={"enabled": True, "trace": True,
                 "slo_rules": [{"name": "decode_p99",
                                "metric": "span.serve.decode",
                                "threshold": 1e-6, "min_count": 4,
                                "cooldown_s": 0.0}]})
        rep = rt.run()
    finally:
        _obs.set_current(prev)
    pipe = rt.pipeline
    assert len(pipe.finished) == src.total_requests
    assert rep.switches >= 1 and rep.reconfig_trace
    assert pipe.reconfig_events and pipe.reconfig_events[0]["n_active"] > 1
    assert pipe.reconfig_events[0]["kv_bytes_moved"] == 0
    assert pipe.engine.pool.n_active > 1
    assert rep.slo_breaches
    assert "serve.decode" in rep.stage_latency_ms


# --------------------------------------------------------------- config --

def test_runtime_config_serving_roundtrip():
    from repro_torch.api import RuntimeConfig
    cfg = RuntimeConfig(serving=ServingConfig(arch="rwkv6-7b", n_slots=2,
                                              device="cpu"),
                        controller="slo", slo_target_p99_ms=12.5)
    d = json.loads(json.dumps(cfg.to_json()))
    cfg2 = RuntimeConfig.from_json(d)
    assert isinstance(cfg2.serving, ServingConfig)
    assert cfg2.serving == cfg.serving
    assert cfg2.slo_target_p99_ms == 12.5


def test_runtime_device_decides_the_serving_device():
    """``RuntimeConfig.device`` places the engine unless
    ``ServingConfig.device`` names one: callers set the device once."""
    from repro_torch.api import make_pipeline, RuntimeConfig
    scfg = ServingConfig(arch="rwkv6-7b", n_slots=2, max_seq=8)
    pipe = make_pipeline(RuntimeConfig(serving=scfg, device="cpu"))
    assert pipe.engine.device == torch.device("cpu")
    pipe = make_pipeline(RuntimeConfig(
        serving=dataclasses.replace(scfg, device="cpu"), device="cuda"))
    assert pipe.engine.device == torch.device("cpu")


def test_unported_options_refuse(tmp_path):
    from repro_torch.api import RuntimeConfig, build_runtime
    cfg = RuntimeConfig(serving=ServingConfig(device="cpu"),
                        checkpoint_dir=str(tmp_path), checkpoint_every=4)
    with pytest.raises(ValueError, match="checkpoint"):
        build_runtime(cfg, [])


def test_mesh_devices_build_a_mesh_pipeline():
    """``mesh_devices=2`` builds a 2-shard ``MeshPipeline`` (the fast count
    path) whose runtime gives the single-device runtime's outputs."""
    from repro_torch.api import RuntimeConfig, build_runtime
    from repro_torch.core.runtime import MeshPipeline, VSNPipeline
    from repro_torch.data import datagen
    from repro_torch.io import ReplaySource
    batches = list(datagen.tweets(np.random.default_rng(4), n_ticks=5,
                                  tick=16, words_per_tweet=3, vocab=300,
                                  k_virt=64, rate_per_tick=30, device="cpu"))
    cfg = dict(wa=50, ws=100, k_virt=64, out_cap=512, n_max=8, n_active=4,
               stash_cap=64, device="cpu")
    mesh = build_runtime(RuntimeConfig(mesh_devices=2, **cfg),
                         ReplaySource(batches))
    one = build_runtime(RuntimeConfig(**cfg), ReplaySource(batches))
    assert isinstance(mesh.pipeline, MeshPipeline)
    assert isinstance(one.pipeline, VSNPipeline)
    assert mesh.pipeline.n_shards == 2
    mesh.run()
    one.run()
    assert mesh.sink.results() == one.sink.results() != []


def test_serve_launcher_defaults_to_the_card():
    from repro_torch.launch import serve
    argv = ["--reduced", "--ticks", "4", "--max-new", "3", "--slots", "4"]
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
    assert serve.main(argv + ["--device", "cpu"]) == 0


def test_launcher_traffic_puts_the_spike_in_the_middle_third():
    """The port's launcher offers the reference launcher's arrivals: for a
    spike and for flat traffic, ``RateSchedule(traffic(...)).rate_at(t)``
    equals the reference's schedule, built from its phase list
    (``src/repro/launch/serve.py``), at every tick of a 24-tick run and
    past it.  Those phases are durations, so the spike lands in the first
    third, not the middle one the reference's comment names (the name of
    this test is the port's old behaviour; ROADMAP.md section 3)."""
    from repro_torch.launch.serve import traffic
    ticks = 24
    for rate, spike in ((40.0, 160.0), (40.0, 0.0), (5.0, 0.0)):
        phases = [(0, rate)]
        if spike > 0:
            phases = [(0, rate), (ticks // 3, spike),
                      (2 * ticks // 3, rate)]
        want = JRateSchedule(phases)
        got = RateSchedule(traffic(ticks, rate, spike))
        assert [got.rate_at(t) for t in range(ticks + 8)] == \
            [want.rate_at(t) for t in range(ticks + 8)]
    assert [RateSchedule(traffic(ticks, 40.0, 160.0)).rate_at(t)
            for t in range(ticks)] == [160.0] * 8 + [40.0] * 16


@pytest.mark.parametrize("arch", ARCHS + TOKEN_ARCHS)
def test_the_models_hand_the_kernels_what_their_cuda_wrappers_take(
        arch, monkeypatch):
    """The CUDA wrappers refuse views, dtypes and shapes their kernels do
    not take, but on the CPU the plain versions run instead.  Here each
    plain version first runs its wrapper's checks, while the engine
    prefills into slots and decodes batches of lanes at several depths."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linear_scan import ops as scan_ops
    seen = []
    for name, mod in (("flash_attention", flash_ops),
                      ("linear_scan", scan_ops)):
        kern = dispatch.registered()[name]

        def checked(*a, _plain=kern.plain, _mod=mod, **kw):
            _mod.validate(*a, **kw)
            seen.append(_mod)
            return _plain(*a, **kw)
        monkeypatch.setattr(kern, "plain", checked)
    cfg = _cfg(arch)
    params = PT.init_params(cfg, seed=1, device="cpu")
    eng = _engine(cfg, params, 3, 1)
    reqs = [Request(uid=i, prompt=p, max_new=4)
            for i, p in enumerate(_prompts(cfg, 4, length=3 + 2 * 1))]
    _run(eng, reqs)
    per_layer = 2 if cfg.kind == "hybrid" else 1    # attention and the SSM
    assert len(seen) == per_layer * cfg.n_layers * (eng.prefills
                                                    + eng.decode_rounds)


@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-large"])
def test_embedding_stub_models_are_refused_by_both_engines(arch):
    """A model of ``frontend="embedding_stub"`` takes embeddings, where a
    request carries token ids: the reference's engine fails with a
    ``ValueError`` at its first prefill, the port's refuses at
    construction with a ``ValueError`` naming the frontend."""
    cfg = reduced(get_config(canon(arch)))
    pcfg = _cfg(arch)
    assert cfg.frontend == pcfg.frontend == "embedding_stub"
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    jeng = JServingEngine(cfg, params, n_slots=2, max_seq=MAX_SEQ,
                          n_instances=1)
    jeng.submit(JRequest(uid=0, prompt=_prompts(cfg, 1)[0], max_new=3))
    with pytest.raises(ValueError):
        jeng.tick()
    with pytest.raises(ValueError, match="embedding_stub"):
        _engine(pcfg, PT.init_params(pcfg, seed=0, device="cpu"), 2, 1)


def test_serve_phase_rehearsal():
    """``chip_smoke.serve_full_width`` on the CPU at reduced gemma3-4b
    (both engines eager there): prompts of 8 and 7 new tokens cross the
    reduced window of 8, the float32 copy runs 6 layers (the sixth
    global), and every check of the phase that the CPU can run passes."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    # the bfloat16 engines and their parameters are freed before the
    # float32 copy is drawn (a local once kept the graph engine alive:
    # on the card, qwen3-moe's 61 GB beside the copy's)
    before = {id(o) for o in gc.get_objects() if type(o) is ServingEngine}
    alive = []
    free = cs._free_card

    def counted(dev):
        free(dev)
        alive.append(sum(type(o) is ServingEngine and id(o) not in before
                         for o in gc.get_objects()))
    cs._free_card = counted
    # one intra-op thread: beside the other test workers, torch's thread
    # pool only spins at these sizes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.serve_full_width("cpu", "gemma3-4b", reduced=True,
                                  max_seq=32, prompt_len=8, max_new=7,
                                  ticks=6, check_layers=6, eager_rounds=24)
    finally:
        torch.set_num_threads(threads)
    assert out["phase"] == "serve_gemma3_4b" and out["layers"] == 2
    assert out["requests"] > 0
    assert out["first_tokens_equal_reference"] == out["requests"]
    assert out["max_decode_position"] == 8 + 7 - 2 > 8
    assert out["eager"]["requests_token_identical_to_graph"] > 0
    assert out["manual_reconfig"]["vsn_bytes"] == 0
    assert out["manual_reconfig"]["sn_bytes"] > 0
    f32 = out["float32_copy"]
    assert f32["layers"] == 6
    assert f32["requests_token_identical"] == f32["requests"]
    assert f32["requests_token_identical_batch1"] == f32["requests"]
    assert alive == [0, 0]
