"""The PyTorch port stands alone: no file of ``deepspeed_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``deepspeed_tpu``, and
importing the port (all of its modules) loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepspeed_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module):
    """True for jax, jax.*, and deepspeed_tpu or deepspeed_tpu.* — but not the
    port, whose name only starts with the same letters."""
    return any(module == top or module.startswith(top + ".")
               for top in ("jax", "jaxlib", "deepspeed_tpu"))


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("deepspeed_tpu") and _forbidden("deepspeed_tpu.serve.engine")
    assert not _forbidden("deepspeed_tpu_torch")
    assert not _forbidden("deepspeed_tpu_torch.serve")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_device_observatories():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for name in ("utils/flops_profiler.py", "utils/roofline.py", "utils/hbm.py",
                 "utils/profile_ingest.py", "utils/anatomy.py", "utils/numerics.py",
                 "runtime/fp16/fused_optimizer.py"):
        assert f"deepspeed_tpu_torch/{name}" in names, name


def test_scan_covers_the_communication_and_crash_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for name in ("comm/topology.py", "comm/hierarchical.py", "comm/sim.py",
                 "runtime/custom_collectives.py", "runtime/sparse_tensor.py",
                 "ops/onebit_adam.py", "resilience/elastic.py", "resilience/crash_sim.py",
                 "models/resnet.py"):
        assert f"deepspeed_tpu_torch/{name}" in names, name


def test_importing_the_port_loads_no_jax():
    # a subprocess: this test process already holds jax (tests/conftest.py)
    modules = sorted(
        "deepspeed_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "import deepspeed_tpu_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') or\n"
        "             m == 'deepspeed_tpu' or m.startswith(('jax.', 'deepspeed_tpu.')))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
