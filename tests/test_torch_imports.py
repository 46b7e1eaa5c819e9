"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` never import
JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

MODULES = [
    "repro_torch",
    "repro_torch.analysis",
    "repro_torch.analysis.__main__",
    "repro_torch.analysis.runtime",
    "repro_torch.api",
    "repro_torch.api.registry",
    "repro_torch.configs",
    "repro_torch.core.inference",
    "repro_torch.core.partition",
    "repro_torch.core.sampling",
    "repro_torch.core.storage",
    "repro_torch.data",
    "repro_torch.data.tokens",
    "repro_torch.dist",
    "repro_torch.dist.client",
    "repro_torch.dist.transport",
    "repro_torch.dist.worker",
    "repro_torch.graph",
    "repro_torch.kernels.autotune",
    "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.fused_gnn",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.ssd_scan",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.roofline",
    "repro_torch.launch.serve",
    "repro_torch.launch.shardings",
    "repro_torch.launch.specs",
    "repro_torch.launch.train",
    "repro_torch.models.gnn",
    "repro_torch.models.transformer.layers",
    "repro_torch.models.transformer.model",
    "repro_torch.models.transformer.ssm",
    "repro_torch.serve",
    "repro_torch.train",
    "repro_torch.train.data_parallel",
    "repro_torch.train.loop",
    "repro_torch.tracing",
] + [f"repro_torch.configs.{p.stem}" for p in sorted((PORT / "configs").glob("[!_]*.py"))]


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_dry_run_loads_no_jax_and_no_process_group():
    """Importing the dry run creates no process group: ``run_one`` makes
    its fake group and destroys it."""
    code = (
        "import sys, torch.distributed as dist\n"
        "import repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad), dist.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_the_sampling_workers_path_loads_no_torch():
    """A sampling worker is forked from a process that may hold a live CUDA
    context; nothing it imports may load torch."""
    code = (
        "import sys\n"
        "import repro_torch.dist, repro_torch.dist.worker, repro_torch.core.sampling.service\n"
        "import repro_torch.tracing\n"
        "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    + sorted((REPO / "tools").glob("*.py")),
    ids=lambda p: str(p.relative_to(REPO / "src" if PORT in p.parents else REPO)),
)
def test_no_module_of_the_port_imports_jax_or_repro(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


def test_kernels_are_not_built_at_import():
    from repro_torch.kernels import build

    assert build._LIBS == {}
