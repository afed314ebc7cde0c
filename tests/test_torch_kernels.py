"""The port's kernels on the CPU: each plain PyTorch version against the
reference Pallas kernel run under ``pallas-interpret``, exactly, on the
same numpy inputs.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here the registry must send CPU tensors to the plain
version and count no launch."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.scalegate_merge.ops import scalegate_merge_op as j_merge
from repro.kernels.scalegate_merge.ref import \
    scalegate_merge_ref as j_merge_ref
from repro.kernels.segment_aggregate.ops import segment_aggregate_op as j_agg
from repro.kernels.window_join.ops import window_join_op as j_join
from repro_torch.kernels import dispatch
from repro_torch.kernels.scalegate_merge import ops as merge_ops
from repro_torch.kernels.scalegate_merge.ops import scalegate_merge_op
from repro_torch.kernels.segment_aggregate import ops as segment_aggregate_ops
from repro_torch.kernels.segment_aggregate.ops import segment_aggregate_op
from repro_torch.kernels.window_join import ops as window_join_ops
from repro_torch.kernels.window_join.ops import (window_join_emit_op,
                                                 window_join_op)

ROOT = pathlib.Path(__file__).resolve().parents[1]
INF = np.iinfo(np.int32).max


def _merge_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    n = {"nonpow2_200": 200, "pow2_128": 128}.get(name, 40)
    tau = np.sort(rng.integers(0, 300, n)).astype(np.int32)
    src = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    ns = 3
    if name == "duplicate_tau":
        tau[:] = 9
    elif name == "all_inf":
        tau[:] = INF
        valid[:] = True
    elif name == "all_invalid":
        valid[:] = False
    elif name == "single_source":
        src[:] = 0
        ns = 1
    elif name == "negative_tau":
        tau = rng.integers(-2 ** 31, 2 ** 31 - 1, n,
                           dtype=np.int64).astype(np.int32)
    elif name.startswith("inf_among_invalid"):
        # valid lanes at tau INT_MAX scattered among invalid ones; with
        # "_w_inf" every source has one, so W is INT_MAX and they are ready
        at_inf = rng.random(n) < 0.3
        tau[at_inf] = INF
        valid = rng.random(n) < 0.5
        if name.endswith("_w_inf"):
            for s in range(ns):
                tau[s], src[s], valid[s] = INF, s, True
    elif name == "unsorted_duplicates":
        tau = rng.integers(0, 5, n).astype(np.int32)
    return tau, src, valid, ns


@pytest.mark.parametrize("name", ["random", "nonpow2_200", "pow2_128",
                                  "duplicate_tau", "all_inf", "all_invalid",
                                  "single_source", "negative_tau",
                                  "inf_among_invalid",
                                  "inf_among_invalid_w_inf",
                                  "unsorted_duplicates"])
def test_scalegate_merge_plain_equals_pallas(name):
    tau, src, valid, ns = _merge_case(name)
    jo, jr, jw = j_merge(tau, src, valid, n_sources=ns,
                         backend="pallas-interpret")
    po, pr, pw = scalegate_merge_op(torch.from_numpy(tau),
                                    torch.from_numpy(src),
                                    torch.from_numpy(valid), n_sources=ns)
    for j, p in ((jo, po), (jr, pr), (jw, pw)):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("n", [1, 2, 127, 4097, 12288, 20480, 22536,
                               merge_ops.CLUSTER_LANES,
                               merge_ops.CLUSTER_LANES + 1, 2 ** 20,
                               2 ** 20 + 1, 2 ** 24])
def test_scalegate_merge_launch_plan(n):
    """The launch is a function of N alone: up to the cluster path's
    capacity one cluster of at most 16 blocks whose shares cover every
    lane once and fit a block's key buffers; past it, for any N that
    int32 lane indices reach, the multi-block path over a power-of-two
    key scratch."""
    p = merge_ops.plan(n)
    assert p == merge_ops.plan(n)
    if n > merge_ops.CLUSTER_LANES:
        assert p.cluster == 0 and p.share == 0
        assert p.scratch >= n and p.scratch & (p.scratch - 1) == 0
        return
    assert 1 <= p.cluster <= merge_ops.MAX_CLUSTER and p.scratch == 0
    shares = [np.arange(b * p.share, min((b + 1) * p.share, n))
              for b in range(p.cluster)]
    np.testing.assert_array_equal(np.concatenate(shares), np.arange(n))
    assert all(1 <= len(lanes) <= merge_ops.SHARE for lanes in shares)
    # two buffers of SHARE 8-byte keys, within a block's 227 KB
    assert 2 * 8 * p.share <= merge_ops.CLUSTER_SMEM <= 227 * 1024
    # the fewest blocks, a power of two, that hold N
    assert p.cluster & (p.cluster - 1) == 0
    assert p.cluster == 1 or -(-n // (p.cluster // 2)) > merge_ops.SHARE


@pytest.mark.parametrize("n,cluster", [(0, None), (2 ** 31, None),
                                       (22536, 5), (100, 17), (100, 0)])
def test_scalegate_merge_launch_plan_refuses(n, cluster):
    with pytest.raises(ValueError):
        merge_ops.plan(n, cluster)


@pytest.mark.parametrize("ns", [0, 1, 3, 1025, 2000])
def test_scalegate_merge_plain_takes_any_source_count(ns):
    """Any ``n_sources >= 0``: the order never depends on it; 0 folds
    nothing and gates at INT_MAX (every valid lane ready), which is what
    ``merge_order`` asks the card for; past the kernel's shared-memory
    fold (1024) the watermark still equals the reference's fold."""
    rng = np.random.default_rng(ns)
    n = 3000
    tau = rng.integers(0, 500, n).astype(np.int32)
    src = rng.integers(0, max(ns, 1), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    got = scalegate_merge_op(*(torch.from_numpy(a) for a in (tau, src, valid)),
                             n_sources=ns)
    if ns:
        want = j_merge_ref(tau, src, valid, n_sources=ns)
        for j, p in zip(want, got):
            np.testing.assert_array_equal(np.asarray(j), p.numpy())
    else:
        order = np.argsort(np.where(valid, tau, INF), kind="stable")
        np.testing.assert_array_equal(got[0].numpy(), order)
        np.testing.assert_array_equal(got[1].numpy(), valid[order])
        assert int(got[2]) == INF
    with pytest.raises(ValueError):       # refused before any launch
        merge_ops._cuda(*(torch.from_numpy(a) for a in (tau, src, valid)),
                        n_sources=-1)


def test_scalegate_phase_trace_stamps_every_phase():
    """The phase trace's anchors still mark each step of the cluster
    kernel once, so the card's trace covers every phase."""
    from repro_torch.kernels import build
    from repro_torch.kernels.scalegate_merge import phase_trace
    text = phase_trace.instrument(
        (build.CSRC / "scalegate_merge.cu").read_text())
    stamps = [int(j) for j in re.findall(r"STAMP\((\d)\);", text)]
    assert stamps == list(range(len(phase_trace.PHASES) + 1))


@pytest.mark.parametrize("w,dead", [(1, False), (2, False), (1, True)])
def test_segment_aggregate_plain_equals_pallas(w, dead):
    """Exact on integer-valued contributions; keys -1 and >= K add nothing."""
    rng = np.random.default_rng(w + 10 * dead)
    n, k, s = 300, 64, 4
    keys = rng.integers(0, k, n).astype(np.int32)
    if dead:
        keys[::3] = -1
        keys[1::5] = k + rng.integers(0, 9, len(keys[1::5]))
    slots = rng.integers(0, s, n).astype(np.int32)
    vals = rng.integers(0, 7, (n, w)).astype(np.float32)
    acc = rng.integers(0, 5, (k, s, w)).astype(np.float32)
    want = np.asarray(j_agg(keys, slots, vals, acc, tile_k=64,
                            backend="pallas-interpret"))
    got = segment_aggregate_op(*(torch.from_numpy(a.copy())
                                 for a in (keys, slots, vals, acc)))
    np.testing.assert_array_equal(want, got.numpy())
    if dead:
        live = (keys >= 0) & (keys < k)
        assert got.sum() == acc.sum() + vals[live].sum()


@pytest.mark.parametrize("w", [1, 2])
def test_segment_aggregate_zipf_hits_leave_acc_and_equal_pallas(w):
    """Out-of-place on a Zipf(1.3)-keyed hit block (Q1's skew) with
    hundreds of hits on one cell: the input ``acc`` is unchanged and the
    result equals the JAX kernel's exactly (integer contributions)."""
    rng = np.random.default_rng(40 + w)
    n, k, s = 4096, 64, 4
    keys = (rng.zipf(1.3, n) % k).astype(np.int32)
    keys[rng.random(n) < 0.2] = -1
    slots = rng.integers(0, s, n).astype(np.int32)
    live = keys >= 0
    assert np.bincount(keys[live] * s + slots[live]).max() >= 100
    vals = rng.integers(0, 7, (n, w)).astype(np.float32)
    acc = rng.integers(0, 5, (k, s, w)).astype(np.float32)
    want = np.asarray(j_agg(keys, slots, vals, acc, tile_k=64,
                            backend="pallas-interpret"))
    args = [torch.from_numpy(a.copy()) for a in (keys, slots, vals, acc)]
    got = segment_aggregate_op(*args)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(args[3].numpy(), acc)


@pytest.mark.parametrize("shape,cluster,want", [
    ((4096, 4, 1), None, 16), ((1, 1, 1), None, 16),
    ((65536, 4, 1), None, 16), ((65537, 4, 1), None, 0),
    ((2 ** 18, 4, 1), None, 0), ((2048, 4, 2), 1, 1), ((4096, 4, 1), 0, 0)])
def test_segment_aggregate_launch_plan(shape, cluster, want):
    """One cluster of 16 blocks while a block's key rows fit its 16,384
    cells (Q1's [4096, 4, 1] and up to [65536, 4, 1]), else the global
    body (0); a forced size is taken where it fits."""
    assert segment_aggregate_ops.plan(*shape, cluster=cluster) == want


@pytest.mark.parametrize("shape,cluster", [((65536, 4, 1), 8),
                                           ((4096, 4, 1), 17),
                                           ((4096, 4, 1), -1)])
def test_segment_aggregate_launch_plan_refuses(shape, cluster):
    with pytest.raises(ValueError):
        segment_aggregate_ops.plan(*shape, cluster=cluster)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["r1", "r17", "r33", "rotated_stale_and_empty",
                                  "horizon_wraps",
                                  "incoming_inf_zero_negative"])
def test_window_join_plain_equals_pallas_on_edges(name):
    """The redesigned kernel's edges, which ``chip_smoke.py`` also holds
    the card to: R not a multiple of a staged chunk, a rotated ring with
    an all-stale and an all-empty chunk, ``st_tau + ws`` wrapping past
    INT_MAX, incoming taus of INT_MAX, 0 and negative (INT_MIN too)."""
    a, ws = _chip_smoke().join_edge_cases(np.random.default_rng(22))[name]
    k = a[3].shape[0]
    jc, jn = j_join(*a, ws=ws, band=10.0, n_attrs=2, tile_k=k,
                    backend="pallas-interpret")
    pc, pn = window_join_op(*(torch.from_numpy(x) for x in a), ws=ws,
                            band=10.0, n_attrs=2)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    assert int(jn) == int(pn) > 0


@pytest.mark.parametrize("name", ["r1", "r17", "r33", "rotated_stale_and_empty",
                                  "horizon_wraps",
                                  "incoming_inf_zero_negative"])
def test_window_join_emit_plain_agrees_with_window_join(name):
    """The phase-1 entry's plain version against the counting entry's (held
    to the Pallas kernel above) on the same edges: its hits on the resp
    rows are the counts there, its comparisons the live lanes' pairs
    there, and its rows, decoded to (b, k), give the counts again, in
    ascending order, cut at ``out_cap``."""
    a, ws = _chip_smoke().join_edge_cases(np.random.default_rng(22))[name]
    rng = np.random.default_rng(len(name))
    b, (k, r) = a[0].shape[0], a[3].shape
    live = rng.random(b) < 0.8
    resp = rng.random(k) < 0.6
    t = [torch.from_numpy(x) for x in a]
    counts, _ = window_join_op(*t, ws=ws, band=10.0, n_attrs=2)
    lv, rs = torch.from_numpy(live), torch.from_numpy(resp)
    _, comps = window_join_op(*(x[lv] for x in t[:3]),
                              *(x[rs] for x in t[3:]), ws=ws, band=10.0,
                              n_attrs=2)
    want = counts.numpy() * live[:, None] * resp[None, :]
    cap = int(want.sum())
    emit = lambda cap: window_join_emit_op(
        *t[:3], lv, *t[3:], rs, ws=ws, band=10.0, n_attrs=2, out_cap=cap)
    rows, n1, got_comps = emit(cap + 3)
    assert int(n1) == cap > 0
    assert int(got_comps) == int(comps) > 0
    rows = rows.numpy()
    assert (rows[cap:] == -1).all() and (np.diff(rows[:cap]) > 0).all()
    hits = np.zeros((b, k), np.int64)
    np.add.at(hits, (rows[:cap] // (k * r), rows[:cap] // r % k), 1)
    np.testing.assert_array_equal(hits, want)
    head, n_head, _ = emit(cap // 2)
    assert int(n_head) == cap
    np.testing.assert_array_equal(head.numpy(), rows[:cap // 2])


@pytest.mark.parametrize("b", [8, 13])
def test_window_join_plain_equals_pallas(b):
    """Counts and comparisons exact; B = 13 is not a multiple of the
    reference's sublane padding."""
    rng = np.random.default_rng(b)
    k, r, p = 64, 6, 4
    nt = np.sort(rng.integers(100, 300, b)).astype(np.int32)
    nt[-1] = INF                                    # a neutral padding lane
    ns = rng.integers(0, 2, b).astype(np.int32)
    npay = rng.uniform(0, 40, (b, p)).astype(np.float32)
    st = rng.integers(0, 280, (k, r)).astype(np.int32)
    st[rng.random((k, r)) < 0.3] = -1
    ss = rng.integers(0, 2, (k, r)).astype(np.int32)
    sp = rng.uniform(0, 40, (k, r, p)).astype(np.float32)
    jc, jn = j_join(nt, ns, npay, st, ss, sp, ws=60, band=5.0, n_attrs=2,
                    tile_k=64, backend="pallas-interpret")
    pc, pn = window_join_op(*(torch.from_numpy(a) for a in
                              (nt, ns, npay, st, ss, sp)),
                            ws=60, band=5.0, n_attrs=2)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    assert int(jn) == int(pn) > 0
    assert not pc.numpy()[-1].any()


def test_window_join_plain_equals_pallas_on_every_attribute():
    """n_attrs = P = 12, past the kernel's 8 unrolled columns, exactly as
    the reference kernel unrolls it; the CUDA wrapper's checks (here on
    CPU tensors, before any launch) take it and refuse n_attrs > P."""
    rng = np.random.default_rng(12)
    b, k, r, p = 21, 16, 5, 12
    nt = np.sort(rng.integers(100, 300, b)).astype(np.int32)
    ns = rng.integers(0, 2, b).astype(np.int32)
    npay = rng.uniform(0, 40, (b, p)).astype(np.float32)
    st = rng.integers(0, 280, (k, r)).astype(np.int32)
    st[rng.random((k, r)) < 0.3] = -1
    ss = rng.integers(0, 2, (k, r)).astype(np.int32)
    sp = rng.uniform(0, 40, (k, r, p)).astype(np.float32)
    # a band that only the later columns narrow: each column alone passes
    # many pairs, all twelve fewer
    kw = dict(ws=60, band=25.0)
    jc, jn = j_join(nt, ns, npay, st, ss, sp, n_attrs=p, tile_k=16,
                    backend="pallas-interpret", **kw)
    args = [torch.from_numpy(a) for a in (nt, ns, npay, st, ss, sp)]
    pc, pn = window_join_op(*args, n_attrs=p, **kw)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    assert int(jn) == int(pn) > 0
    eight, _ = window_join_op(*args, n_attrs=8, **kw)
    assert 0 < int(pc.sum()) < int(eight.sum())
    window_join_ops.validate(*args, n_attrs=p)
    with pytest.raises(ValueError):
        window_join_ops.validate(*args, n_attrs=p + 1)


def test_registry_sends_cpu_tensors_to_the_plain_version():
    reg = dispatch.registered()
    assert set(reg) >= {"scalegate_merge", "segment_aggregate", "window_join"}
    named = ("jax.grad of ", "none, phase 1 of ")
    for kern in reg.values():
        assert (ROOT / kern.source).is_file()
        prefix = next((p for p in named if kern.replaces.startswith(p)), None)
        if prefix:
            # a kernel no Pallas kernel has (a backward kernel, the fast
            # join's phase 1): the reference function whose jax.grad, or a
            # part of which, it computes, "path:line name"
            path, at = kern.replaces[len(prefix):].split(":")
            line, fn = at.split()
        else:
            (path, line), fn = kern.replaces.split(":"), kern.name
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {fn}(")
    before = {n: k.launches for n, k in reg.items()}
    t = torch.zeros(4, dtype=torch.int32)
    scalegate_merge_op(t, t, torch.ones(4, dtype=torch.bool), n_sources=1)
    segment_aggregate_op(t, t, torch.ones(4, 1), torch.zeros(2, 1, 1))
    window_join_op(t, t, torch.zeros(4, 2), torch.zeros(3, 2, dtype=torch.int32),
                   torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 2, 2),
                   ws=5)
    window_join_emit_op(t, t, torch.zeros(4, 2), torch.ones(4, dtype=torch.bool),
                        torch.zeros(3, 2, dtype=torch.int32),
                        torch.zeros(3, 2, dtype=torch.int32),
                        torch.zeros(3, 2, 2), torch.ones(3, dtype=torch.bool),
                        ws=5, out_cap=4)
    assert {n: k.launches for n, k in reg.items()} == before


def test_registry_refuses_other_devices():
    """A device that is neither the CPU, CUDA nor meta raises.  Meta
    tensors (the dry-run's trace) run the plain version and launch
    nothing."""
    import types
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError):
        scalegate_merge_op(other, other, other, n_sources=1)
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    before = scalegate_merge_op.launches
    out = scalegate_merge_op(t, t, t.bool(), n_sources=1)
    assert all(o.device.type == "meta" for o in out)
    assert scalegate_merge_op.launches == before


# ------------------------------------------------------- the first build --

STUB_NVCC = """#!{python}
import pathlib, sys, time
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
time.sleep(0.3)                       # widen the window for a racing build
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"stub")
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """``build`` with ``nvcc`` replaced by a script that logs each call and
    writes its ``-o`` file, building into ``tmp_path``."""
    from repro_torch.kernels import build
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "build_root", lambda: tmp_path / "build")
    return build, calls, nvcc


def test_first_build_from_many_threads_runs_nvcc_once(stub_nvcc, monkeypatch):
    """Leaf, router, ingest and main threads may all launch first: one of
    them builds (one nvcc per source, one link), the rest load its
    library."""
    build, calls, _ = stub_nvcc

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LIB", None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert len(calls.read_text().splitlines()) == len(build.SOURCES) + 1
    assert pathlib.Path(got[0].path).read_bytes() == b"stub"


def test_first_build_from_two_processes_runs_nvcc_once(stub_nvcc, tmp_path):
    """Spawned leaf processes build too: the file lock lets one compile
    and the other find its library."""
    build, calls, nvcc = stub_nvcc
    code = ("import pathlib, sys\n"
            "from repro_torch.kernels import build\n"
            f"build._nvcc = lambda: {str(nvcc)!r}\n"
            f"build.build_root = lambda: pathlib.Path({str(tmp_path)!r}) "
            "/ 'build'\n"
            "print(build.build())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    assert len(calls.read_text().splitlines()) == len(build.SOURCES) + 1
