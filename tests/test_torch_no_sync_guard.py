"""Static no-host-sync guard for the PyTorch port's observability tier
(``deepspeed_tpu_torch/utils/`` and ``serve/request_trace.py``), the port's
counterpart of ``tests/unit/test_no_sync_guard.py`` (the lint framework that
test wraps in JAX is ROADMAP.md item 23).

An AST scan forbids the calls that synchronize the host with the device:
``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
``torch.cuda.synchronize``. The pinned set is exact:
- the step's one loss fetch, ``TelemetrySession.fetch_window`` (a single
  ``.cpu()`` of the stacked window losses, which ``end_step`` and the
  engine's ``Train/Samples/*`` scalars share: the JAX guard's
  ``TelemetrySession.end_step`` device_get);
- the ``wall_clock_breakdown`` timers' fence, ``timer.py::device_sync``
  (``torch.cuda.synchronize``; JAX's ``jax.effects_barrier``, which its
  guard's pass does not list), which telemetry suppresses unless
  ``telemetry.perturbing_breakdown`` asks for it.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepspeed_tpu_torch"

METHODS = {"item", "cpu", "tolist", "numpy"}

PINNED = {
    ("utils/telemetry.py", "TelemetrySession.fetch_window", ".cpu()"),
    ("utils/timer.py", "device_sync", "torch.cuda.synchronize"),
}


def _files():
    out = sorted((PORT / "utils").rglob("*.py"))
    out.append(PORT / "serve" / "request_trace.py")
    return out


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def scan_source(text, rel="<src>"):
    """{(file, enclosing qualified name, primitive)} of ``text``."""
    found = set()

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(child, scope + [child.name])
                continue
            if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute):
                name = _dotted(child.func)
                if name == "torch.cuda.synchronize":
                    found.add((rel, ".".join(scope) or "<module>", name))
                elif child.func.attr in METHODS and not child.args and not child.keywords:
                    found.add((rel, ".".join(scope) or "<module>", f".{child.func.attr}()"))
            visit(child, scope)

    visit(ast.parse(text), [])
    return found


def _scan():
    found = set()
    for path in _files():
        found |= scan_source(path.read_text(), path.relative_to(PORT).as_posix())
    return found


def test_utils_sync_set_is_exactly_pinned():
    found = _scan()
    assert found - PINNED == set(), f"new host-sync primitive: {found - PINNED}"
    assert PINNED - found == set(), f"stale pinned entry: {PINNED - found}"


def test_guard_scans_the_real_files():
    names = {p.relative_to(PORT).as_posix() for p in _files()}
    for name in ("utils/telemetry.py", "utils/cluster.py", "utils/metrics.py",
                 "utils/alerts.py", "utils/goodput.py", "utils/monitor.py",
                 "utils/pipeline_trace.py", "utils/numerics.py", "utils/timer.py",
                 "serve/request_trace.py"):
        assert name in names, name


@pytest.mark.parametrize("call,prim", [
    ("x.item()", ".item()"), ("x.cpu()", ".cpu()"), ("x.tolist()", ".tolist()"),
    ("x.numpy()", ".numpy()"), ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("torch.cuda.synchronize(dev)", "torch.cuda.synchronize")])
def test_guard_catches_each_primitive(call, prim):
    src = f"class A:\n    def f(self, x, dev):\n        return {call}\n"
    assert scan_source(src) == {("<src>", "A.f", prim)}
    # a keyword or positional argument makes it another call (e.g. .cpu is
    # never called with one; .numpy(force=True) is not a device fetch here)
    assert scan_source("def g(x):\n    return x.tolist\n") == set()
