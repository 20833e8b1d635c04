"""AST lint passes: host-sync, tracer-hostile calls, recompile hazards
(``deepspeed_tpu/lint/ast_passes.py`` retargeted to PyTorch).

Scoping differs by pass, as in the JAX package:

- ``HostSyncPass`` scans whole modules — it is applied only to modules that
  PROMISE never to sync (the observability tier under ``utils/`` and the
  serving request ledger); the engine fetches the loss every step and is
  not in its scope. It forbids the calls that make the host wait for the
  card: ``.cpu()`` (rule ``device-get``, JAX's ``jax.device_get``),
  ``torch.cuda.synchronize`` (``block-until-ready``), ``.numpy()``
  (``np-asarray``), ``.item()`` (``item-call``) and ``.tolist()``
  (``tolist``); a method call counts when it has no arguments.
- ``TracerHostilePass`` / ``RecompileHazardPass`` scan only the code a CUDA
  graph captures or a dispatcher op runs, plus its same-module call-graph
  closure (by bare name, as JAX's ``_jitted_closure``). The roots are the
  functions marked ``@graph_captured`` (``serve/paged.py``: the only
  functions ``GraphedProgram`` captures), those named as the first argument
  of ``GraphedProgram(...)`` or ``torch.library.custom_op(...)(f)``, and the
  bodies of ``@torch.library.custom_op`` functions. There a host cast
  (``float``/``int``/``bool`` of a non-constant; rule ``host-cast``) or
  ``.item()`` (``item-call``) either fails the capture or freezes one value
  into every replay, and a clock or host-RNG read (``time.time()`` and the
  like; ``nondeterminism-in-trace``) is replayed as the captured value.

JAX's ``unhashable-static`` rule (a ``static_argnums`` parameter defaulting
to an unhashable literal) has no counterpart: no cache of the port keys on a
user argument's value the way ``jax.jit``'s static arguments do.

Subjects are ``<repo-relative-path>::<qualname>``; the same primitive
appearing N times in one function is one violation with
``details["occurrences"] = N``.
"""

import ast
import os

from .model import Violation

# method name -> rule (JAX's rule name where the call is the counterpart)
HOST_SYNC_METHODS = {"cpu": "device-get", "numpy": "np-asarray", "item": "item-call",
                     "tolist": "tolist"}
HOST_SYNC_CALLS = {"torch.cuda.synchronize": "block-until-ready"}
HOST_CASTS = ("float", "int", "bool")
# attribute chains whose call inside captured code is frozen into the graph
NONDETERMINISM_CHAINS = (
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("datetime", "now"), ("datetime", "utcnow"), ("date", "today"),
    ("random", "random"), ("random", "randint"), ("random", "uniform"),
)
CAPTURE_MARKER = "graph_captured"
CAPTURE_CALLS = ("GraphedProgram",)


def _qualname(stack):
    return ".".join(stack) or "<module>"


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _tail(node):
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def parse_module(path, root=None):
    """(tree, repo-relative path) for one source file."""
    with open(path) as f:
        src = f.read()
    rel = os.path.relpath(path, root) if root else path
    return ast.parse(src, filename=path), rel.replace(os.sep, "/")


def _is_custom_op(node):
    """``torch.library.custom_op(...)`` / ``custom_op(...)``."""
    return isinstance(node, ast.Call) and _tail(node.func) == "custom_op"


def _is_root_decorator(node):
    return _tail(node) == CAPTURE_MARKER or _is_custom_op(node)


class _FunctionIndex(ast.NodeVisitor):
    """Collects every function def with its qualname, called names, and
    whether a capture construct roots it."""

    def __init__(self):
        self.funcs = {}        # qualname -> node
        self.by_name = {}      # bare name -> [qualname] (lexical resolution)
        self.calls = {}        # qualname -> set of bare names it calls
        self.roots = set()     # qualnames a capture or an op roots
        self._stack = []

    def _mark_target(self, node):
        if isinstance(node, ast.Name):
            for q in self.by_name.get(node.id, ()):
                self.roots.add(q)
        elif isinstance(node, ast.Lambda):
            self.roots.add(_qualname(self._stack))

    def visit_FunctionDef(self, node):
        self._stack.append(node.name)
        q = _qualname(self._stack)
        self.funcs[q] = node
        self.by_name.setdefault(node.name, []).append(q)
        self.calls.setdefault(q, set())
        if any(_is_root_decorator(d) for d in node.decorator_list):
            self.roots.add(q)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def visit_Call(self, node):
        if self._stack:
            q = _qualname(self._stack)
            if isinstance(node.func, ast.Name):
                self.calls.setdefault(q, set()).add(node.func.id)
        if _tail(node.func) in CAPTURE_CALLS or _is_custom_op(node.func):
            for arg in node.args[:1]:
                self._mark_target(arg)
        self.generic_visit(node)


def _captured_closure(index):
    """Roots plus every same-module function transitively called by name.
    Two defs sharing a bare name both enter the closure — over-approximate
    rather than miss captured code."""
    reached = set(index.roots)
    frontier = list(reached)
    while frontier:
        q = frontier.pop()
        for name in index.calls.get(q, ()):
            for callee in index.by_name.get(name, ()):
                if callee not in reached:
                    reached.add(callee)
                    frontier.append(callee)
    return reached


def _collect(tree, visit):
    """Run ``visit(qualname, node)`` over every node with scope tracking."""
    stack = []

    class W(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        def generic_visit(self, node):
            visit(_qualname(stack), node)
            super().generic_visit(node)

    W().visit(tree)


def _dedupe(pass_id, raw):
    """[(rule, subject, message)] -> [Violation] with occurrence counts."""
    seen = {}
    for rule, subject, message in raw:
        key = (rule, subject)
        if key in seen:
            seen[key].details["occurrences"] += 1
        else:
            seen[key] = Violation(pass_id, rule, subject, message,
                                  details={"occurrences": 1})
    return [seen[k] for k in sorted(seen)]


class HostSyncPass:
    """Forbidden host-sync calls anywhere in the module. Scope this pass to
    modules that promise non-perturbation."""

    pass_id = "ast-host-sync"

    def run(self, tree, rel):
        raw = []

        def visit(qual, node):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                return
            name = _dotted(node.func)
            if name in HOST_SYNC_CALLS:
                raw.append((HOST_SYNC_CALLS[name], f"{rel}::{qual}",
                            f"host-sync call {name} in {qual}"))
            elif node.func.attr in HOST_SYNC_METHODS and not node.args \
                    and not node.keywords:
                raw.append((HOST_SYNC_METHODS[node.func.attr], f"{rel}::{qual}",
                            f"host-sync call .{node.func.attr}() in {qual} waits "
                            "for the device"))

        _collect(tree, visit)
        return _dedupe(self.pass_id, raw)


def _closure_nodes(tree):
    index = _FunctionIndex()
    index.visit(tree)
    index.visit(tree)  # second sweep: by_name is complete for call-site roots
    return index, sorted(_captured_closure(index))


class TracerHostilePass:
    """``float()``/``int()``/``bool()`` and ``.item()`` inside captured code
    or an op's body: on a device value these synchronize, which a CUDA-graph
    capture refuses, or freeze the value into every replay."""

    pass_id = "ast-tracer-hostile"

    def run(self, tree, rel):
        index, captured = _closure_nodes(tree)
        raw = []
        for q in captured:
            node = index.funcs.get(q)
            if node is None:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if isinstance(f, ast.Name) and f.id in HOST_CASTS and \
                        len(sub.args) == 1 and \
                        not isinstance(sub.args[0], ast.Constant):
                    raw.append(("host-cast", f"{rel}::{q}",
                                f"{f.id}() inside captured {q} reads a value on the host"))
                elif isinstance(f, ast.Attribute) and f.attr == "item":
                    raw.append(("item-call", f"{rel}::{q}",
                                f".item() inside captured {q} blocks on the device"))
        return _dedupe(self.pass_id, raw)


class RecompileHazardPass:
    """Clock or host-RNG reads inside captured code: a CUDA graph replays
    the value read at capture."""

    pass_id = "ast-recompile-hazard"

    def run(self, tree, rel):
        index, captured = _closure_nodes(tree)
        raw = []
        for q in captured:
            node = index.funcs.get(q)
            if node is None:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
                    base = sub.func.value
                    base_name = base.id if isinstance(base, ast.Name) else None
                    if (base_name, sub.func.attr) in NONDETERMINISM_CHAINS:
                        raw.append((
                            "nondeterminism-in-trace", f"{rel}::{q}",
                            f"{base_name}.{sub.func.attr}() inside captured {q} is "
                            "read once, at capture"))
        return _dedupe(self.pass_id, raw)


def run_ast_passes(files, passes, root=None):
    """Run each pass over each file; returns all violations."""
    out = []
    for path in sorted(files):
        tree, rel = parse_module(path, root=root)
        for p in passes:
            out.extend(p.run(tree, rel))
    return out
