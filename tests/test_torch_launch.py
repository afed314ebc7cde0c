"""The port's stream launchers on the CPU against the JAX reference's:
``live`` with the static oracle, ``live --record`` then ``--resume
--replay`` (and the port resuming the reference's checkpoint directory
and recording), ``elastic_drill``'s straggler, crash, serving and ingest drills
with the reference's switch bytes, and the mesh flags (``live --mesh``,
the mesh drill).  Every launcher runs on the card unless ``--device cpu``
is given.

``elastic_drill``'s ``recovery`` drills run on the card (``chip_smoke.py``'s
``launchers`` phase); at the reference's size (12 ticks of 64 tweets over
a tier) ``recovery`` takes ~25 s on a CPU, too long for this file.  Their
harness, ``kill_restore_drill``, is held against the reference in
``tests/test_torch_recovery.py``."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import elastic_drill as j_drill
from repro.launch import live as j_live
from repro_torch.launch import elastic_drill as p_drill
from repro_torch.launch import live as p_live

SMALL = ["--ticks", "6", "--tick", "16"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _line(out, prefix):
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, (prefix, out)
    return lines[0]


def test_live_matches_reference_with_oracle(capsys):
    """The same stream and output count as the reference launcher, both
    equal to the static max-width oracle.  The controller reads the
    measured queue depth as well as the rate hint, so which switches a
    run makes depends on its timing (the outputs do not)."""
    want = _run(j_live.main, SMALL + ["--oracle"], capsys)
    got = _run(p_live.main, SMALL + ["--oracle", "--device", "cpu"], capsys)
    match = re.compile(r"oracle = (\w+) \((\d+) output tuples")
    line = "[live] outputs match static oracle"
    assert match.search(_line(got, line)).groups() == \
        match.search(_line(want, line)).groups() == ("True", "207")
    assert "live run OK" in got


def test_live_record_then_resume_matches_reference(tmp_path, capsys):
    """``--record`` + checkpoints, then ``--resume --replay``: the same
    recording, saved steps and restored run as the reference; the port
    also resumes the reference's directory from the reference's
    recording, replaying the same outputs as from its own."""
    def record_and_resume(main, tag, extra):
        ck, rec = str(tmp_path / f"ck_{tag}"), str(tmp_path / f"{tag}.npz")
        first = _run(main, SMALL + ["--checkpoint-dir", ck,
                                    "--checkpoint-every", "2",
                                    "--record", rec] + extra, capsys)
        again = _run(main, SMALL + ["--resume", "--replay", rec,
                                    "--checkpoint-dir", ck] + extra, capsys)
        return ck, rec, first, again

    jck, jrec, jfirst, jagain = record_and_resume(j_live.main, "ref", [])
    _, prec, pfirst, pagain = record_and_resume(p_live.main, "port",
                                                ["--device", "cpu"])
    with np.load(jrec) as a, np.load(prec) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    assert _line(pfirst, "[live/ckpt ]").split(" -> ")[0] == \
        _line(jfirst, "[live/ckpt ]").split(" -> ")[0]
    restored = re.compile(r"restored step (\d+) from \S+; (\d+ ticks, "
                          r"\d+ tuples)")
    assert restored.search(pagain).groups() == \
        restored.search(jagain).groups() == ("4", "2 ticks, 32 tuples")
    cross = _run(p_live.main, SMALL + ["--resume", "--replay", jrec,
                                       "--checkpoint-dir", jck,
                                       "--device", "cpu"], capsys)
    assert restored.search(cross).groups() == ("4", "2 ticks, 32 tuples")
    replayed = re.compile(r"(\d+) output tuples replayed")
    assert replayed.search(cross).group(1) == \
        replayed.search(pagain).group(1) != "0"


def test_elastic_drill_matches_reference_switch_bytes(capsys):
    """The straggler, crash, serving and ingest drills exit 0; the VSN switch
    bytes (the f_mu and activity tables, and the serving pool's) and the
    sigma the SN baseline would reshard equal the reference's."""
    drills = ["--drills", "straggler,crash,serving,ingest"]
    want = _run(j_drill.main, drills, capsys)
    got = _run(p_drill.main, drills + ["--device", "cpu"], capsys)
    assert "elastic drill OK" in got
    assert _line(got, "[1]") == _line(want, "[1]")
    vsn = re.compile(r"VSN moved (\d+) B")
    assert vsn.search(_line(got, "[2]")).group(1) == \
        vsn.search(_line(want, "[2]")).group(1)
    assert _line(got, "[3]") == _line(want, "[3]")


MESH = re.compile(r"outputs identical=(\w+), reconfigs=(\d+), cross-shard "
                  r"state transfer=(\d+) B .*switch bytes=(\d+) \(tables\)")


@pytest.mark.parametrize("launcher,argv", [
    (p_live.main, SMALL + ["--oracle", "--mesh", "2"]),
    (p_drill.main, ["--mesh", "2", "--drills", "straggler"]),
    (p_drill.main, ["--drills", "mesh"]),
], ids=["live_mesh", "drill_mesh_flag", "drill_mesh_drill"])
def test_mesh_flags_run(launcher, argv, capsys):
    """``live --mesh 2`` gives the output count of the reference's
    ``live --mesh 1`` (its one CPU device: both run the fast count path)
    and matches its static oracle; the mesh drill (2 shards with the
    straggler drill, or 8 alone) drains the straggler mid-stream with the
    single-device outputs, one reconfiguration, no state moved between
    devices and the reference's table bytes (the reference skips its mesh
    drill on one CPU device, so its single-device lines are the
    comparison)."""
    got = _run(launcher, argv + ["--device", "cpu"], capsys)
    if launcher is p_live.main:
        want = _run(j_live.main, SMALL + ["--oracle", "--mesh", "1"], capsys)
        match = re.compile(r"oracle = (\w+) \((\d+) output tuples")
        line = "[live] outputs match static oracle"
        assert match.search(_line(got, line)).groups() == \
            match.search(_line(want, line)).groups() == ("True", "205")
        assert "live run OK" in got
        return
    want = _run(j_drill.main, ["--drills", "straggler"], capsys)
    table = re.search(r"switch bytes=(\d+)", _line(want, "[1]")).group(1)
    assert MESH.search(_line(got, "[1m]")).groups() == ("True", "1", "0",
                                                        table)
    if "straggler" in argv:
        assert _line(got, "[1]") == _line(want, "[1]")
    assert "elastic drill OK" in got


@pytest.mark.parametrize("launcher,argv", [
    (p_live.main, SMALL),
    (p_drill.main, ["--drills", "crash"]),
], ids=["live", "elastic_drill"])
def test_launchers_default_to_the_card(launcher, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher(argv)
