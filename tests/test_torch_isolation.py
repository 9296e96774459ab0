"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and
the port's measuring scripts under ``tools/`` import neither JAX nor
anything of the JAX package, import ``triton``
only inside functions, and ``chip_smoke.py`` refuses to report a result
without a GPU or without the rest of the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(tree: ast.Module):
    """(module name, is top level) for every import in the file."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (root == "triton" and top_level), \
            f"{path.name} imports triton at module level"


def test_port_imports_with_jax_unavailable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch.serving, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.core.profiler, "
            "repro_torch.core.planner, repro_torch.core.estimator, "
            "repro_torch.sim, repro_torch.control, repro_torch.core.tuner, "
            "repro_torch.sim.control, repro_torch.serving.loop, "
            "repro_torch.serving.frontends, repro_torch.faults, "
            "repro_torch.faults.schedule, repro_torch.faults.simstage, "
            "repro_torch.serving.dataplane, repro_torch.serving.procpool, "
            "repro_torch.serving.ingress, repro_torch.serving.cluster, "
            "repro_torch.sim.torch_backend, repro_torch.kernels.sim_fill, "
            "repro_torch.configs.pipelines, repro_torch.models.sharding, "
            "repro_torch.models.parallel, repro_torch.launch.mesh, "
            "repro_torch.launch.shapes, repro_torch.launch.dryrun, "
            "repro_torch.roofline.analysis, repro_torch.examples.quickstart, "
            "repro_torch.examples.autoscale_spike, "
            "repro_torch.examples.serve_real_models, "
            "repro_torch.examples.train_arch\n"
            "from repro_torch.core import Planner, Estimator\n"
            "from repro_torch.serving import LiveControlLoop, "
            "LiveClusterSim, AsyncIngress, ProcessStage\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _run_chip_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""         # hide any card: no result
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_without_a_gpu_prints_no_result():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
