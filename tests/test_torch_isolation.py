"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``, the port imports with
JAX unavailable, and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_unavailable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_the_card():
    """``VSNPipeline``, ``IngestTier``, ``RootMerge`` and the ingest-tier
    launcher resolve ``device=None`` to CUDA: without a card they raise,
    and they run on the CPU only when asked.  The root's default round is
    the fused one on the card and the host path on the CPU."""
    from repro_torch.core.aggregate import count_aggregate
    from repro_torch.core.runtime import VSNPipeline
    from repro_torch.core.windows import WindowSpec
    from repro_torch.ingest import IngestTier, RootMerge
    from repro_torch.launch import ingest_tier
    op = count_aggregate(WindowSpec(10, 20), 8)
    entries = {
        "VSNPipeline": lambda **kw: VSNPipeline(op, n_max=2, n_active=1,
                                                **kw).device,
        "IngestTier": lambda **kw: IngestTier([], 2, 1, **kw).device,
        "RootMerge": lambda device=None: RootMerge(
            2, 32, 1, 1, [0], torch_device=device).dev,
    }
    argv = ["--ticks", "2", "--tick", "8", "--leaves", "1", "--sources",
            "2", "--worker", "inline", "--fused-root"]
    def root_is_fused(device=None):
        tier = IngestTier([], 2, 1, worker="inline", device=device)
        assert len(list(tier)) == 1              # the final flush round
        assert tier.root.device == RootMerge(2, 32, 1, 1, [0],
                                             torch_device=device).device
        return tier.root.device

    if torch.cuda.is_available():
        for make in entries.values():
            assert make().type == "cuda"
        assert root_is_fused() is True
        return
    assert root_is_fused("cpu") is False
    for name, make in entries.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").type == "cpu", name
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest_tier.main(argv)
    assert ingest_tier.main(argv + ["--device", "cpu"]) == 0
