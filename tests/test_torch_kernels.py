"""The port's kernels on the CPU: each plain PyTorch version against the
reference Pallas kernel run under ``pallas-interpret``, exactly, on the
same numpy inputs.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here the registry must send CPU tensors to the plain
version and count no launch."""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.scalegate_merge.ops import scalegate_merge_op as j_merge
from repro.kernels.segment_aggregate.ops import segment_aggregate_op as j_agg
from repro.kernels.window_join.ops import window_join_op as j_join
from repro_torch.kernels import dispatch
from repro_torch.kernels.scalegate_merge.ops import scalegate_merge_op
from repro_torch.kernels.segment_aggregate.ops import segment_aggregate_op
from repro_torch.kernels.window_join.ops import window_join_op

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
    return tau, src, valid, ns


@pytest.mark.parametrize("name", ["random", "nonpow2_200", "pow2_128",
                                  "duplicate_tau", "all_inf", "all_invalid",
                                  "single_source", "negative_tau"])
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


def test_registry_sends_cpu_tensors_to_the_plain_version():
    reg = dispatch.registered()
    assert set(reg) >= {"scalegate_merge", "segment_aggregate", "window_join"}
    for kern in reg.values():
        assert (ROOT / kern.source).is_file()
        path, line = kern.replaces.split(":")
        src = (ROOT / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {kern.name}(")
    before = {n: k.launches for n, k in reg.items()}
    t = torch.zeros(4, dtype=torch.int32)
    scalegate_merge_op(t, t, torch.ones(4, dtype=torch.bool), n_sources=1)
    segment_aggregate_op(t, t, torch.ones(4, 1), torch.zeros(2, 1, 1))
    window_join_op(t, t, torch.zeros(4, 2), torch.zeros(3, 2, dtype=torch.int32),
                   torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 2, 2),
                   ws=5)
    assert {n: k.launches for n, k in reg.items()} == before


def test_registry_refuses_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        scalegate_merge_op(t, t, t.bool(), n_sources=1)


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
