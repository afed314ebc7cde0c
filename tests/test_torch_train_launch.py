"""The port's training launcher on the CPU (``python -m
repro_torch.launch.train --device cpu --reduced``): it runs, ends
``done`` and resumes from its own directory; and its checkpoints cross
packages both ways.  A directory the port's launcher wrote restores with
``repro.checkpoint`` into the reference's ``(params, opt)`` bit for bit
equal to the port's own restore, and the reference's launcher resumes
from it; the step the reference's launcher then writes restores in the
port bit for bit equal to the reference's restore.  The cross-package
runs use 16-token sequences: at the launcher's default 128 the reference's hymba-1.5b
takes a NaN gradient norm at its first step (its chunked SSD form
exponentiates the masked upper triangle of the decay differences, whose
overflow turns into NaN in ``jax.grad``), where the port's kernel path
stays finite."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.checkpoint import checkpoint as RC
from repro.configs import canon, get_config, reduced
from repro.launch import train as RL
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch import configs as pconfigs
from repro_torch.checkpoint import checkpoint as PC
from repro_torch.launch import train as PL
from repro_torch.models import convert, transformer as PT
from repro_torch.optim import adamw as PA

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "hymba-1.5b"


def _launch(*argv):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *argv], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_launcher_runs_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    lines = _launch("--reduced", "--steps", "2", "--ckpt-dir", ck,
                    "--ckpt-every", "1")
    assert lines[0].startswith("arch=qwen3-14b params=")
    assert lines[1].startswith("step 1 loss=") and lines[-1] == "done"
    assert PC.latest_step(ck) == 2
    lines = _launch("--reduced", "--steps", "4", "--ckpt-dir", ck)
    assert "resumed from step 2" in lines
    assert any(ln.startswith("step 3 loss=") for ln in lines)
    assert lines[-1] == "done" and PC.latest_step(ck) == 4


def _ref_like(cfg):
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    return params, RA.init_opt(params)


def _port_like(pcfg):
    params = PT.init_params(pcfg, device="cpu")
    return params, PA.init_opt(params)


def _leaves_f32(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _port_leaves_f32(params, opt, pcfg):
    return [x.float().numpy() for x in PC.flatten(
        (convert.to_reference(params, pcfg),
         convert.opt_to_reference(opt, pcfg)))]


def test_checkpoints_cross_packages(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    cfg = reduced(get_config(canon(ARCH)))
    pcfg = pconfigs.reduced(pconfigs.get_config(canon(ARCH)))
    size = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "16",
            "--ckpt-dir", ck]
    assert PL.main([*size, "--steps", "2", "--ckpt-every", "1",
                    "--device", "cpu"]) == 0
    # the port's step 2 in the reference's (params, opt)
    ref = RC.restore(ck, 2, _ref_like(cfg))
    port = PL.restore(ck, 2, pcfg, *_port_like(pcfg), torch.device("cpu"))
    assert int(port[1].step) == int(ref[1].step) == 2
    for a, b in zip(_port_leaves_f32(*port, pcfg), _leaves_f32(ref),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # the reference's launcher resumes from it and writes step 3
    assert RL.main([*size, "--steps", "3"]) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    ref = RC.restore(ck, 3, _ref_like(cfg))
    assert all(np.isfinite(x).all() for x in _leaves_f32(ref))
    port = PL.restore(ck, 3, pcfg, *_port_like(pcfg), torch.device("cpu"))
    assert int(port[1].step) == 3
    want = convert.from_reference(jax.tree.map(np.asarray, ref[0]), pcfg,
                                  "cpu")
    for a, b in zip(PC.flatten(port[0]), PC.flatten(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(_port_leaves_f32(*port, pcfg), _leaves_f32(ref),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # and the port's launcher goes on from the reference's step
    assert PL.main([*size, "--steps", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "resumed from step 3" in out and out[-1] == "done"


def test_launcher_runs_on_the_card_unless_asked(tmp_path):
    """Without ``--device`` the launcher resolves the card, and a host
    without one raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.main(["--reduced", "--steps", "1", "--ckpt-dir",
                 str(tmp_path / "ck")])
    assert PC.latest_step(str(tmp_path / "ck")) is None
