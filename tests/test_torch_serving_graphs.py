"""The serving engine's bucketed, padded rounds and its CUDA-graph path on
the CPU, for qwen3-14b, rwkv6-7b, deepseek-moe-16b and hymba-1.5b at
reduced widths.

One traffic (``LENS``, ``NEWS``, ``ARRIVE``: mixed prompt lengths and
budgets, arrivals over rounds, 4 slots, a VSN switch at round 2 and an SN
switch at round 4, mid-decode) drives each engine.  In float32, with the
reference's parameters carried across, the port's engine gives the
reference's ``ServingEngine``'s tokens and the port's batch-1
``reference_decode``'s, with its rounds padded to buckets 1, 2 and 4.  A
graph replays what its capture recorded, whatever the round: here every
call of one shape (decode bucket, prompt length) runs the body of that
shape's first call, and the tokens equal the eager engine's.  The pad
lanes read and write only the pool's scratch row (garbage there changes
no slot and no token, bit for bit; a slot never used stays zero), are not
``live`` to the MoE, and the capture, acted out on the CPU, sees no host
read in a decode round or a prefill."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from _capturing import _Capturing
from repro.configs import canon, get_config, reduced
from repro.models import transformer as RT
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as pconfigs
from repro_torch.core.runtime import GraphCaptureError
from repro_torch.models import convert, moe as PMOE, transformer as PT
from repro_torch.serving import Request, ServingEngine, reference_decode
from repro_torch.serving.kv_pool import _leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-14b", "rwkv6-7b", "deepseek-moe-16b", "hymba-1.5b"]
MAX_SEQ, N_SLOTS = 24, 4
LENS = [3, 6, 4, 7, 5, 3, 8]
NEWS = [5, 3, 6, 1, 4, 7, 2]
ARRIVE = [0, 0, 1, 1, 2, 6, 6]


def _pcfg(arch, dtype=None):
    cfg = pconfigs.reduced(pconfigs.get_config(pconfigs.canon(arch)))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n) for n in LENS]


def _serve(eng, make_request, prompts, switches=True):
    """The traffic through ``eng`` (either package's engine): request i
    is submitted before round ``ARRIVE[i]``; 1 active replica, 4 after
    round 2 (VSN), 2 after round 4 (SN).  -> {uid: tokens}."""
    eng.pool.reconfigure_vsn(1)
    done = []
    while len(done) < len(prompts):
        for i, p in enumerate(prompts):
            if ARRIVE[i] == eng.steps:
                eng.submit(make_request(uid=i, prompt=p, max_new=NEWS[i]))
        done += eng.tick()
        if switches and eng.steps == 2:
            eng.reconfigure(4, mode="vsn")
        if switches and eng.steps == 4:
            moved, _ = eng.reconfigure(2, mode="sn")
            assert moved > 0
        assert eng.steps < 100
    return {r.uid: list(r.out) for r in done}


def _rounds(eng):
    """Record each decode round's (bucket, running lanes)."""
    seen = []
    body = eng._decode_body
    eng._decode_body = lambda k: seen.append((k, len(eng.running))) or \
        body(k)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_engine_equals_the_reference_engine(arch):
    cfg = dataclasses.replace(reduced(get_config(canon(arch))),
                              dtype="float32")
    pcfg = _pcfg(arch, "float32")
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    pp = convert.from_reference(jax.tree.map(np.asarray, params), pcfg,
                                "cpu")
    prompts = _prompts(cfg.vocab)
    want = _serve(JServingEngine(cfg, params, n_slots=N_SLOTS,
                                 max_seq=MAX_SEQ, n_instances=4),
                  JRequest, prompts)
    eng = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        n_instances=4, device="cpu")
    rounds = _rounds(eng)
    got = _serve(eng, Request, prompts)
    assert got == want
    for i, p in enumerate(prompts):
        assert got[i] == reference_decode(pcfg, pp, p, NEWS[i], MAX_SEQ), i
    assert {k for k, _ in rounds} == {1, 2, 4}
    assert any(n < k for k, n in rounds)              # pad lanes ran
    assert all(k == min(1 << (n - 1).bit_length(), N_SLOTS)
               for k, n in rounds)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_graph_engine_equals_the_eager_engine(arch):
    """A graph replays its capture: every call of a shape runs the body
    of the shape's first call here, reading the round's inputs from the
    static buffers alone; tokens and MoE drops equal the eager engine's."""
    pcfg = _pcfg(arch)
    pp = PT.init_params(pcfg, seed=2, device="cpu")
    prompts = _prompts(pcfg.vocab, seed=4)
    eager = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                          n_instances=4, device="cpu")
    want = _serve(eager, Request, prompts)
    eng = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        n_instances=4, device="cpu")
    first = {}
    eng._run = lambda key, body: first.setdefault(key, body)()
    assert _serve(eng, Request, prompts) == want
    assert {k for k, _ in first} == {"decode", "prefill"}
    assert float(eng.dropped) == float(eager.dropped)
    assert float(eng.dropped_decode) == float(eager.dropped_decode) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_lanes_touch_no_slot(arch):
    """Two engines on one traffic, one with noise in the pool's scratch
    row: after every round their slots are equal bit for bit, as are
    their tokens; slot 0, never allocated, stays zero; the scratch row is
    no part of ``caches``/``states`` or ``slot_bytes``."""
    pcfg = _pcfg(arch)
    pp = PT.init_params(pcfg, seed=5, device="cpu")
    engines = [ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                             device="cpu") for _ in range(2)]
    gen = torch.Generator().manual_seed(0)
    pool = engines[1].pool
    for leaf in _leaves(pool.caches_all, pool.states_all):
        row = leaf[:, pool.scratch]
        row.copy_(torch.randn(row.shape, generator=gen) * 100)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, pcfg.vocab, n) for n in (4, 6, 3)]
    rounds = _rounds(engines[0])
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=6))
    outs = [[], []]
    while engines[0].running or engines[0].waiting:
        for j, eng in enumerate(engines):
            outs[j] += eng.tick()
        a, b = (_leaves(e.pool.caches, e.pool.states) for e in engines)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
            assert not x[:, 0].any()
    assert {r.uid: r.out for r in outs[0]} == {r.uid: r.out for r in outs[1]}
    assert (4, 3) in rounds
    one = PT.init_caches(pcfg, 1, MAX_SEQ, "cpu")
    assert pool.slot_bytes() == sum(
        t.element_size() * t.numel() for t in _leaves(*one))
    assert all(t.shape[1] == N_SLOTS for t in _leaves(pool.caches,
                                                      pool.states))


def test_pad_lanes_are_not_live_to_the_moe(monkeypatch):
    """Every decode round hands the MoE its bucket of rows with ``live``
    set on the running lanes alone, so a pad lane's drops never count."""
    pcfg = _pcfg("deepseek-moe-16b")
    pp = PT.init_params(pcfg, seed=1, device="cpu")
    eng = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        device="cpu")
    seen = []
    moe = PMOE.moe_forward

    def spy(p, x, cfg, *, per_row=False, live=None, **kw):
        if x.shape[1] == 1:                      # a decode round
            seen.append((x.shape[0], int(live.sum()), len(eng.running)))
        return moe(p, x, cfg, per_row=per_row, live=live, **kw)
    monkeypatch.setattr(PMOE, "moe_forward", spy)
    _serve(eng, Request, _prompts(pcfg.vocab), switches=False)
    assert seen and all(n_live == running for _, n_live, running in seen)
    assert any(k > n_live for k, n_live, _ in seen)
    assert float(eng.dropped_decode) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_no_host_read_in_a_decode_round_or_a_prefill(arch, monkeypatch):
    """The card's path acted out on the CPU (``_Capturing``): the first
    call of each decode bucket and prompt length runs, then is captured,
    and no host read happens inside a capture; a round that reads the
    host makes the capture raise ``GraphCaptureError``."""
    pcfg = _pcfg(arch)
    pp = PT.init_params(pcfg, seed=3, device="cpu")
    _Capturing(monkeypatch)
    eng = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        n_instances=4, device="cpu")
    eng.graphs = True
    prompts = _prompts(pcfg.vocab)
    _serve(eng, Request, prompts, switches=False)
    stats = eng.graph_stats()
    assert {f"prefill/{n}" for n in LENS} | {"decode/1", "decode/2",
                                            "decode/4"} == set(stats)
    assert all(s["replays"] >= 0 for s in stats.values())

    bad = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        device="cpu")
    bad.graphs = True
    body = bad._decode_body
    bad._decode_body = lambda k: body(k) if int(bad._next[0].item()) >= 0 \
        else None
    bad.submit(Request(uid=0, prompt=prompts[0], max_new=3))
    with pytest.raises(GraphCaptureError, match="decode"):
        bad.tick()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_decode_at_the_engines_batch_shapes(arch):
    """``chip_smoke.padded_decode``, the card's witness for a request that
    leaves batch-1 decode: each decode step padded to the bucket the
    engine ran that request's round in (``record_buckets``), it gives the
    engine's tokens and batch-1 ``reference_decode``'s (float32), and
    without buckets it is ``reference_decode``."""
    cs = _chip_smoke()
    pcfg = _pcfg(arch, "float32")
    pp = PT.init_params(pcfg, seed=7, device="cpu")
    eng = ServingEngine(pcfg, pp, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                        n_instances=4, device="cpu")
    rows = cs.record_buckets(eng)
    prompts = _prompts(pcfg.vocab, seed=8)
    got = _serve(eng, Request, prompts, switches=False)
    assert any(k > 1 for ks in rows.values() for k in ks)
    for i, p in enumerate(prompts):
        assert len(rows.get(i, [])) == NEWS[i] - 1
        want, _ = cs.padded_decode(pcfg, pp, p, NEWS[i], MAX_SEQ,
                                   rows=rows.get(i, []))
        one, gaps = cs.padded_decode(pcfg, pp, p, NEWS[i], MAX_SEQ)
        assert got[i] == want == one == reference_decode(pcfg, pp, p,
                                                         NEWS[i], MAX_SEQ), i
        assert len(gaps) == NEWS[i] and min(gaps) >= 0
