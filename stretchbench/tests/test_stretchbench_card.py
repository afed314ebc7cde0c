"""Each cell through the command on the card (a short window): exits 0,
prints one line, correct.  Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from stretchbench import spec

CELLS = ["q1-wordcount.zipf-max", "q3-scalejoin.max", "q3-scalejoin.paced",
         "q1-wordcount.uniform-max"]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "stretchbench.run", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "8", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
