"""The port stands alone: nothing under src/repro_torch/, chip_smoke.py
nor the ranks of the distributed tests (tests/torch_dist_ranks.py) imports
jax, jaxlib, ml_dtypes or the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tests" / "torch_dist_ranks.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "src/repro_torch/serve/engine.py" in names
    assert "src/repro_torch/core/oft.py" in names
    assert "src/repro_torch/serve/sampling.py" in names
    assert "src/repro_torch/obs/tracker.py" in names
    assert "src/repro_torch/examples/quickstart.py" in names
    assert "src/repro_torch/examples/peft_comparison.py" in names
    assert "src/repro_torch/examples/train_psoft_lm.py" in names
    assert "src/repro_torch/launch/train.py" in names
    assert "src/repro_torch/train/straggler.py" in names
    for module in ("sharding/rules", "launch/mesh", "launch/dryrun",
                   "launch/roofline", "distributed/collectives",
                   "distributed/pipeline"):
        assert f"src/repro_torch/{module}.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_nothing_of_jax_or_the_reference(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    pytest.importorskip("torch")
    code = ("import sys; import repro_torch.serve, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.core.oft, "
            "repro_torch.models.ssm, "
            "repro_torch.core.lora, repro_torch.train.trainer, "
            "repro_torch.obs, repro_torch.serve.sampling, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_metrics, "
            "repro_torch.examples.peft_comparison, "
            "repro_torch.examples.train_psoft_lm, "
            "repro_torch.launch.train, repro_torch.train.straggler, "
            "repro_torch.sharding, repro_torch.distributed, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.data.pipeline, "
            "repro_torch.analysis, repro_torch.analysis.dispatch_tools; "
            "bad = [m for m in ('jax', 'jaxlib', 'ml_dtypes', 'repro') "
            "if m in sys.modules]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
