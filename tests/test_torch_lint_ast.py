"""The port's AST lint passes and report model (``deepspeed_tpu_torch/lint/``)
against the JAX package's, on the CPU.

Each JAX fixture of ``tests/unit/test_lint_ast.py`` is translated to its
torch counterpart (``jax.device_get`` -> ``.cpu()``, ``block_until_ready``
-> ``torch.cuda.synchronize``, ``np.asarray`` -> ``.numpy()``, a ``jax.jit``
root -> a ``@graph_captured`` / ``GraphedProgram`` root) and both passes must
give the same ``(pass, rule, subject)`` set. ``unhashable-static`` has no
counterpart (no port cache keys on a static argument's value). The report
model is a copy: the same violations and allowlist give the same bytes.
"""

import json
import os
import textwrap

import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.lint import ast_passes as jast
from deepspeed_tpu.lint import model as jmodel
from deepspeed_tpu_torch.lint import ast_passes as tast
from deepspeed_tpu_torch.lint import model as tmodel

PKG = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))


def _facts(tmp_path, source, passes):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(source))
    mod = jast if passes[0].__class__.__module__.startswith("deepspeed_tpu.") else tast
    return {(v.pass_id, v.rule, v.subject)
            for v in mod.run_ast_passes([str(p)], passes, root=str(tmp_path))}


# (JAX source, torch source, pass name): each pair is one construct
PAIRS = {
    "host-sync-primitives": ("""
        import jax
        import numpy as np

        def fetch(x):
            host = jax.device_get(x)
            x.block_until_ready()
            return np.asarray(x)
    """, """
        import torch

        def fetch(x):
            host = x.cpu()
            torch.cuda.synchronize()
            return x.numpy()
    """, "HostSyncPass"),
    "host-sync-qualname": ("""
        import jax

        class Session:
            def end(self, x):
                return jax.device_get(x)
    """, """
        class Session:
            def end(self, x):
                return x.cpu()
    """, "HostSyncPass"),
    "tracer-hostile-closure": ("""
        import jax

        @jax.jit
        def step(x):
            return helper(x)

        def helper(x):
            return float(x)

        def host_only(x):
            return float(x)
    """, """
        from deepspeed_tpu_torch.serve.paged import graph_captured

        @graph_captured
        def step(x):
            return helper(x)

        def helper(x):
            return float(x)

        def host_only(x):
            return float(x)
    """, "TracerHostilePass"),
    "tracer-hostile-call-site-item": ("""
        import jax

        def compiled(x):
            return x.item()

        run = jax.jit(compiled)
    """, """
        from deepspeed_tpu_torch.serve.paged import GraphedProgram

        def compiled(x):
            return x.item()

        prog = GraphedProgram(compiled, "p", [], None, None, None, None)
    """, "TracerHostilePass"),
    "tracer-hostile-literal-cast": ("""
        import jax

        @jax.jit
        def step(x):
            return x * int("42")
    """, """
        from deepspeed_tpu_torch.serve.paged import graph_captured

        @graph_captured
        def step(x):
            return x * int("42")
    """, "TracerHostilePass"),
    "recompile-hazard-clock": ("""
        import jax
        import time

        @jax.jit
        def step(x):
            return x + time.time()
    """, """
        import time
        from deepspeed_tpu_torch.serve.paged import graph_captured

        @graph_captured
        def step(x):
            return x + time.time()
    """, "RecompileHazardPass"),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_pass_facts_equal_jax(tmp_path, case):
    jsrc, tsrc, name = PAIRS[case]
    j = _facts(tmp_path, jsrc, (getattr(jast, name)(),))
    t = _facts(tmp_path, tsrc, (getattr(tast, name)(),))
    assert t == j
    assert j or case == "tracer-hostile-literal-cast"


def test_custom_op_bodies_are_roots(tmp_path):
    """A dispatcher op's body (decorated, or named as custom_op(...)(f)) and
    its same-module callees are scanned; a host helper is not."""
    src = """
        import time
        import torch

        @torch.library.custom_op("ns::a", mutates_args=())
        def a(x: torch.Tensor) -> torch.Tensor:
            return launch(x)

        def launch(x):
            return x * float(x.sum()) + time.perf_counter()

        def b_impl(x):
            return x.item()

        b = torch.library.custom_op("ns::b", mutates_args=())(b_impl)

        def host(x):
            return int(x)
    """
    facts = _facts(tmp_path, src, (tast.TracerHostilePass(), tast.RecompileHazardPass()))
    assert facts == {("ast-tracer-hostile", "host-cast", "mod.py::launch"),
                     ("ast-recompile-hazard", "nondeterminism-in-trace", "mod.py::launch"),
                     ("ast-tracer-hostile", "item-call", "mod.py::b_impl")}


@pytest.mark.parametrize("call,rule", [
    ("x.item()", "item-call"), ("x.tolist()", "tolist"), ("x.cpu(); y = x.cpu()", "device-get")])
def test_host_sync_rules_and_occurrences(tmp_path, call, rule):
    p = tmp_path / "m.py"
    p.write_text(f"def f(x):\n    {call}\n    return x.cpu(non_blocking=True)\n")
    vs = tast.run_ast_passes([str(p)], (tast.HostSyncPass(),), root=str(tmp_path))
    assert [(v.rule, v.subject) for v in vs] == [(rule, "m.py::f")]
    assert vs[0].details["occurrences"] == (2 if ";" in call else 1)


def test_graphed_program_captures_only_marked_functions():
    from deepspeed_tpu_torch.serve.paged import GraphedProgram, build_paged_programs
    with pytest.raises(ValueError, match="graph_captured"):
        GraphedProgram(lambda *a: None, "p", [], None, None, None, None)
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    import torch
    m = GPT2Model(GPT2Config(vocab_size=16, n_positions=8, n_embd=8, n_layer=1, n_head=2,
                             compute_dtype=torch.float32), device="cpu")
    progs = build_paged_programs(m, num_slots=1, block_size=4, max_blocks=2,
                                 prefill_chunk=4, verify_width=2)
    assert all(progs[k].graph_captured for k in ("decode_step", "prefill_chunk",
                                                 "spec_verify"))


# ------------------------------------------------------------------ repo baseline
def test_package_ast_baseline_is_clean_modulo_shipped_allowlist():
    """The live port, as ``ds-tpu-torch lint`` sees it: no AST violation the
    shipped allowlist does not cover, and no stale AST entry."""
    from deepspeed_tpu_torch.lint.cli import _DEFAULT_ALLOWLIST, run_ast_surface
    allowlist = tmodel.Allowlist.load(_DEFAULT_ALLOWLIST)
    report = tmodel.LintReport()
    run_ast_surface(report, allowlist, package_dir=PKG)
    report.finish(allowlist)
    assert report.violations == [], "\n".join(v.vid for v in report.violations)
    assert report.unused_allow == []
    # the scan reaches the captured serving programs and every kernel op
    index = tast._FunctionIndex()
    tree, _ = tast.parse_module(os.path.join(PKG, "serve", "paged.py"))
    index.visit(tree)
    assert {"build_paged_programs.decode_step", "build_paged_programs.prefill_chunk_fn",
            "build_paged_programs.spec_verify"} <= index.roots


# ------------------------------------------------------------ model semantics
def _violations(mod):
    return [mod.Violation("p", "r", s, f"msg {s}", details={"n": i} if i % 2 else None)
            for i, s in enumerate(["s2", "s1", "s3", "s0"])]


def test_report_bytes_equal_jax():
    entries = [{"id": "p:r:s1", "reason": "x"}, {"id": "p:r:zz*", "reason": "y"}]
    out = []
    for mod in (jmodel, tmodel):
        allow = mod.Allowlist(entries)
        r = mod.LintReport()
        r.passes = ["z", "a"]
        r.programs = ["b", "a"]
        r.extend(_violations(mod), allow)
        r.finish(allow)
        out.append(r.to_json())
    assert out[0] == out[1]
    parsed = json.loads(out[1])
    assert parsed["unused_allowlist_entries"] == ["p:r:zz*"]
    assert [v["subject"] for v in parsed["violations"]] == ["s0", "s2", "s3"]


def test_allowlist_requires_reason_and_tracks_unused():
    with pytest.raises(ValueError):
        tmodel.Allowlist([{"id": "a:*"}])
    al = tmodel.Allowlist([{"id": "a:*", "reason": "x"}, {"id": "b:*", "reason": "y"}])
    assert al.match("a:r:s") is not None
    assert al.match("c:r:s") is None
    assert al.unused() == ["b:*"]
    v = tmodel.Violation("p", "r", "s", "msg", details={"n": 1})
    assert v.vid == "p:r:s" and v.to_dict()["details"] == {"n": 1}
