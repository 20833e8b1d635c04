"""Static no-host-sync guard for the PyTorch port's observability tier
(``deepspeed_tpu_torch/utils/`` and ``serve/request_trace.py``), the port's
counterpart of ``tests/unit/test_no_sync_guard.py``: a thin wrapper over the
lint suite's ``HostSyncPass`` (the pass ``ds-tpu-torch lint`` runs) and the
shipped allowlist, so the guard and the linter cannot drift.

The pass forbids the calls that synchronize the host with the device:
``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()`` (without arguments) and
``torch.cuda.synchronize``. The sanctioned set is exactly the shipped
allowlist's ``ast-host-sync`` entries:
- the step's one loss fetch, ``TelemetrySession.fetch_window`` (a single
  ``.cpu()`` of the stacked window losses, which ``end_step`` and the
  engine's ``Train/Samples/*`` scalars share: the JAX guard's
  ``TelemetrySession.end_step`` device_get);
- the ``wall_clock_breakdown`` timers' fence, ``timer.py::device_sync``
  (``torch.cuda.synchronize``; JAX's ``jax.effects_barrier``, which its
  guard's pass does not list), which telemetry suppresses unless
  ``telemetry.perturbing_breakdown`` asks for it.
"""

import json
from pathlib import Path

import pytest

from deepspeed_tpu_torch.lint.ast_passes import HostSyncPass, run_ast_passes
from deepspeed_tpu_torch.lint.cli import _DEFAULT_ALLOWLIST, host_sync_files

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deepspeed_tpu_torch"

PINNED = {
    "ast-host-sync:device-get:deepspeed_tpu_torch/utils/telemetry.py::"
    "TelemetrySession.fetch_window",
    "ast-host-sync:block-until-ready:deepspeed_tpu_torch/utils/timer.py::device_sync",
}


def _files():
    return host_sync_files(str(PORT))


def _scan():
    return {v.vid for v in run_ast_passes(_files(), (HostSyncPass(),), root=str(ROOT))}


def scan_source(text, tmp_path):
    """{(rule, subject)} of ``text`` as a module ``m.py``."""
    p = tmp_path / "m.py"
    p.write_text(text)
    return {(v.rule, v.subject)
            for v in run_ast_passes([str(p)], (HostSyncPass(),), root=str(tmp_path))}


def test_utils_sync_set_is_exactly_pinned():
    found = _scan()
    assert found - PINNED == set(), f"new host-sync primitive: {found - PINNED}"
    assert PINNED - found == set(), f"stale pinned entry: {PINNED - found}"
    shipped = {e["id"] for e in json.loads(Path(_DEFAULT_ALLOWLIST).read_text())["allow"]
               if e["id"].startswith("ast-host-sync:")}
    assert shipped == PINNED


def test_guard_scans_the_real_files():
    names = {Path(p).relative_to(PORT).as_posix() for p in _files()}
    for name in ("utils/telemetry.py", "utils/cluster.py", "utils/metrics.py",
                 "utils/alerts.py", "utils/goodput.py", "utils/monitor.py",
                 "utils/pipeline_trace.py", "utils/numerics.py", "utils/timer.py",
                 "utils/flops_profiler.py", "utils/hbm.py", "utils/roofline.py",
                 "utils/profile_ingest.py", "utils/anatomy.py", "utils/op_record.py",
                 "serve/request_trace.py"):
        assert name in names, name


@pytest.mark.parametrize("call,rule", [
    ("x.item()", "item-call"), ("x.cpu()", "device-get"), ("x.tolist()", "tolist"),
    ("x.numpy()", "np-asarray"), ("torch.cuda.synchronize()", "block-until-ready"),
    ("torch.cuda.synchronize(dev)", "block-until-ready")])
def test_guard_catches_each_primitive(call, rule, tmp_path):
    src = f"class A:\n    def f(self, x, dev):\n        return {call}\n"
    assert scan_source(src, tmp_path) == {(rule, "m.py::A.f")}
    # a keyword or positional argument makes it another call (e.g. .cpu is
    # never called with one; .numpy(force=True) is not a device fetch here)
    assert scan_source("def g(x):\n    return x.tolist\n", tmp_path) == set()
