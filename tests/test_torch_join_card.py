"""The fast join's phase-1 kernel on the card (``window_join_emit``): equal
to its plain version, rows, count and comparisons, at Q3's shape (B 32, K
4,096, R 160, P 7, n_attrs 2), and one Q3 ``VSNPipeline`` run in a CUDA
graph equal to the dense path's.  Skips without a CUDA device; imports no
JAX, so the card's machine runs it alone:

    python -m pytest -q --noconftest tests/test_torch_join_card.py
"""

import numpy as np
import pytest
import torch

INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31
B, K, R, P = 32, 4096, 160, 7
WS = 300_000
NOW = 1_000_000

CASES = ["full_resp", "empty_resp", "round_robin_resp",
         "invalid_and_control_lanes", "stale_and_empty_slots",
         "band_boundary", "horizon_wraps", "overflow_cap8", "b37_k4103",
         "n_attrs3", "n_attrs12", "mixed_lists"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def q3_inputs(case: str, rng):
    """numpy inputs of one instance's phase 1 at Q3's shape, with the
    case's twist, and its keyword arguments."""
    b, k, p = (37, 4103, P) if case == "b37_k4103" else (
        B, K, 12 if case == "n_attrs12" else P)
    # ~74 hits a block in "mixed_lists": some blocks keep their ordered
    # list (64 rows), the rest are read again
    hi = {"band_boundary": 40, "overflow_cap8": 40,
          "mixed_lists": 700}.get(case, 10_000)
    new_tau = np.sort(rng.integers(NOW, NOW + 16, b)).astype(np.int32)
    new_src = rng.integers(0, 2, b).astype(np.int32)
    # integers: |d| == band is exact, and frequent where hi is small
    new_pay = rng.integers(1, hi + 1, (b, p)).astype(np.float32)
    new_live = np.ones(b, bool)
    st_tau = rng.integers(NOW - WS, NOW, (k, R)).astype(np.int32)
    st_src = rng.integers(0, 2, (k, R)).astype(np.int32)
    st_pay = rng.integers(1, hi + 1, (k, R, p)).astype(np.float32)
    resp = np.ones(k, bool)
    kw = dict(ws=WS, band=10.0, n_attrs=2, out_cap=1024)
    if case == "empty_resp":
        resp[:] = False
    elif case in ("round_robin_resp", "b37_k4103"):
        resp = np.arange(k) % 4 == 1          # balanced_fmu's instance 1 of 4
    elif case == "invalid_and_control_lanes":
        new_live = rng.random(b) < 0.5
        new_tau[~new_live] = INT_MAX          # as a staged lane, or any tau
        new_tau[~new_live & (rng.random(b) < 0.5)] = NOW
    elif case == "stale_and_empty_slots":
        u = rng.random((k, R))
        st_tau[u < 0.3] = -1
        st_tau[(u >= 0.3) & (u < 0.6)] = NOW - WS - 100      # stale
        st_tau[:64] = -1                      # whole rows, chunks all empty
        st_tau[64:128, :96] = NOW - WS - 100  # whole chunks stale
        st_tau[200, 5] = INT_MIN
    elif case == "horizon_wraps":
        st_tau = rng.integers(INT_MAX - 2 * WS, INT_MAX, (k, R),
                              dtype=np.int64).astype(np.int32)
        st_tau[rng.random((k, R)) < 0.2] = -1
        new_tau = np.sort(np.concatenate([
            [INT_MIN, INT_MIN + 1, -1, 0, INT_MAX - WS, INT_MAX],
            rng.integers(INT_MAX - 3 * WS, INT_MAX, b - 6)])).astype(np.int32)
    elif case == "overflow_cap8":
        kw["out_cap"] = 8
    elif case == "mixed_lists":
        kw["out_cap"] = 4096
    elif case == "n_attrs3":
        kw.update(n_attrs=3, band=2000.0)
    elif case == "n_attrs12":
        new_pay = rng.integers(1, 60, (b, p)).astype(np.float32)
        st_pay = rng.integers(1, 60, (k, R, p)).astype(np.float32)
        kw.update(n_attrs=12, band=45.0)
    return (new_tau, new_src, new_pay, new_live, st_tau, st_src, st_pay,
            resp), kw


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_window_join_emit_equals_plain_at_q3_shape(case):
    dev = _card()
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.window_join.ops import window_join_emit_op
    from repro_torch.kernels.window_join.ref import window_join_emit_ref
    args, kw = q3_inputs(case, np.random.default_rng(sum(map(ord, case))))
    args = [torch.as_tensor(a, device=dev) for a in args]
    before = window_join_emit_op.launches
    rows, n1, comps = window_join_emit_op(*args, **kw)
    assert window_join_emit_op.launches == before + 1
    want = window_join_emit_ref(*args, **kw)
    torch.cuda.synchronize()
    assert int(n1) == int(want[1]) and int(comps) == int(want[2]), case
    assert torch.equal(rows.cpu(), want[0].cpu()), case
    if case == "empty_resp":
        assert int(comps) == 0 and int(rows.max()) == -1
    else:
        assert int(comps) > 0 and int(n1) > 0, case
    if case == "overflow_cap8":
        assert int(n1) > 8
    if case == "band_boundary":
        # some hit lies on the band's edge: |d| == band in a column
        flat = rows[:min(int(n1), kw["out_cap"])].cpu().numpy()
        b_, k_, r_ = np.unravel_index(flat, (args[0].shape[0],
                                             *args[4].shape))
        d = (args[2].cpu().numpy()[b_, :2]
             - args[6].cpu().numpy()[k_, r_, :2])
        assert (np.abs(d) == kw["band"]).any()
    assert dispatch.registered()["window_join_emit"] is window_join_emit_op


def _q3_pipeline(dev, fj, prefill):
    """Q3's pipeline as the benchmark builds it (n_max 16, 4 active, ticks
    of 32, out_cap 1,024), its window installed from ``prefill``."""
    from repro_torch.core import join
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.vsn import merge_fast_state
    from repro_torch.core.windows import WindowSpec
    ws = WindowSpec(wa=1, ws=WS, wt="single")
    op = join.scalejoin_def(ws, K, fj, payload_width=P, ring=R, out_cap=1024)

    def tick(op_, st, ready, resp, explicit_w=None):
        return join.tick_fast(ws, fj, st, ready, resp, out_cap=1024)

    pipe = VSNPipeline(op, n_max=16, n_active=4, stash_cap=64, tick_fn=tick,
                       merge_fn=merge_fast_state,
                       init_sigma=lambda d: join.fast_join_init(K, R, P, d),
                       device=dev)
    pipe.ensure_gate_for(1, P)
    state = pipe.export_state_np()
    sigma = {f: np.array(v) for f, v in state["sigma"].items()}
    tau, src, pay = prefill
    c = np.arange(len(tau))
    key, pos = c % K, c // K
    sigma["tau"][key, pos] = tau
    sigma["pay"][key, pos] = pay
    sigma["stream"][key, pos] = src
    sigma["n"] = np.bincount(key, minlength=K).astype(np.int32)
    sigma["c"] = np.array(len(c), np.int32)
    state["sigma"] = sigma
    state["sg"]["wmark"]["frontier"] = np.full(2, int(tau.max()), np.int32)
    pipe.import_state_np(state)
    return pipe


@pytest.mark.card
def test_q3_pipeline_in_a_graph_kernel_equals_dense():
    """Two super-batches of 4 ticks through ``run_persistent`` (one graph,
    captured at the first and replayed at the second), a switch from 4 to
    16 instances at tick 2: the kernel path's outputs and state equal the
    dense path's (the same band test as a plain callable), the entry
    launches 2 x n_max a tick and the dense path is never taken."""
    dev = _card()
    from repro_torch.core import join
    from repro_torch.core import tuples as T
    from repro_torch.core.controller import (Reconfiguration, active_mask,
                                             balanced_fmu)
    from repro_torch.core.runtime import fold_frontier
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.window_join.ops import window_join_emit_op
    rng = np.random.default_rng(30)
    n_pre = int(K * R * 0.9)
    pre_tau = np.sort(rng.integers(NOW - WS, NOW, n_pre)).astype(np.int32)
    prefill = (pre_tau, rng.integers(0, 2, n_pre).astype(np.int32),
               rng.integers(1, 5001, (n_pre, P)).astype(np.float32))
    batches, t0 = [], int(pre_tau.max()) + 1
    for _ in range(8):
        tau = np.sort(t0 + rng.integers(0, 16, 32)).astype(np.int32)
        t0 = int(tau.max()) + 1
        batches.append(T.make_batch(
            tau, rng.integers(1, 5001, (32, P)).astype(np.float32),
            source=rng.integers(0, 2, 32), device="cpu"))
    rc = Reconfiguration(epoch=1, n_active=16, fmu=balanced_fmu(K, 16, 16),
                         active=active_mask(16, 16))
    band = join.band_predicate(10.0, 2)

    def run(fj):
        pipe = _q3_pipeline(dev, fj, prefill)
        frontier = np.full(2, int(pre_tau.max()), np.int64)
        outs = []
        for j in (0, 4):
            out = pipe.run_persistent(batches[j:j + 4],
                                      reconfig=rc if j == 0 else None,
                                      reconfig_at=2, frontier0=frontier)
            outs.append(out)
            for b in batches[j:j + 4]:
                fold_frontier(frontier, b, 2)
        graphs = pipe.persistent_graphs()
        assert len(graphs) == 1
        assert next(iter(graphs.values()))["replays"] == 1
        return outs, pipe.export_state_np()["sigma"]

    dispatch.reset_launches()
    dense_before = join.DENSE_PHASE1_CALLS
    got, got_sigma = run(band)
    assert join.DENSE_PHASE1_CALLS == dense_before
    assert window_join_emit_op.launches == 2 * 16 * 8
    want, want_sigma = run(lambda pl, pr: band(pl, pr))
    assert join.DENSE_PHASE1_CALLS > dense_before
    hits = 0
    for g, w in zip(got, want):
        for lane in ("outs_pre", "outs_post"):
            go, wo = getattr(g, lane), getattr(w, lane)
            for f in ("tau", "payload", "valid", "count", "overflow"):
                assert torch.equal(getattr(go, f), getattr(wo, f)), (lane, f)
            hits += int(go.count.sum())
        assert torch.equal(g.switched, w.switched)
    assert hits > 0
    for f, v in want_sigma.items():
        assert np.array_equal(np.asarray(got_sigma[f]), np.asarray(v)), f
