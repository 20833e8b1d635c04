"""Non-perturbing telemetry: step metrics, trace windows, compile watchdog, ledger.

PyTorch port of ``deepspeed_tpu/utils/telemetry.py`` (lines 1-920). The JAX
session rides XLA's machinery; the port maps each pillar onto eager PyTorch:

1. **Step metrics** (``TelemetrySession.end_step``, JAX lines 624-818): the
   only blocking operation is the engine's own loss fetch — one ``.cpu()`` of
   the stacked window losses (``fetch_window``, which the engine's
   ``Train/Samples/*`` scalars read too, so the step fetches once) where JAX
   runs ``jax.device_get`` at lines 665-667. Step time, samples/sec and a
   rolling MFU are host arithmetic over counters the watched programs feed.
2. **Trace windows** (``on_step_begin``, JAX lines 556-579): a
   ``torch.profiler.profile`` (CPU and, on the card, CUDA activities) started
   and stopped on ``trace_steps``, exported as a Chrome trace
   (``trace.json``) into ``trace_<run>_host<h>/`` under ``trace_dir``; the
   engines' ``named_scope`` ranges (utils/cluster.py) name its regions.
3. **Compile watchdog** (``CompileWatchdog``, JAX lines 159-227;
   ``_WatchedProgram`` in place of ``_WatchedJit``, lines 229-297). Eager
   PyTorch has no AOT compile. A training program's first call on a new
   abstract signature (shapes, dtypes and devices of its tensor arguments,
   ``_abstract_signature``) is recorded with its wall time, which is what
   JAX's own ``_call_fallback`` (lines 247-257) records. A serving program's
   record is its CUDA-graph capture (``serve/paged.py`` ``GraphedProgram``),
   with the capture's graph-pool bytes as its temp bytes
   (``record_capture``). "Recompile" means a second record under one name.
4. **Flops and bytes** (``_analyze_compiled``, lines 61-127, reads XLA's
   cost analysis). Each program's cost is counted once per signature, on
   that first call, by ``utils/flops_profiler.py`` ``count``: the flop
   counter over the matrix products and every kernel op of the port (the
   flash forward and both backward kernels, block-sparse, the fused block:
   each a dispatcher op with its formula), and the byte counter over every
   dispatched op. Every later call of the program adds the recorded counts.
5. **The anatomy, the memory manifest, the profile ingest, the sentinel**
   (JAX lines 400-475, 581-600, 624-818): with an anatomy spec
   (``utils/roofline.py``) ``end_step`` prices the step's measured wall by
   its counted flops and bytes (``Anatomy/*``; exposed collective time is 0
   at world 1: no program text says what overlaps, and the measured
   exposure is the profile's); ``set_memory_manifest`` installs the
   engine's per-class bytes (``Memory/*``); ``configure_profile`` makes the
   trace window's close ingest its Chrome trace (``utils/profile_ingest.py``,
   ``Profile/*``); ``end_step(numerics=...)`` hands back the sentinel's host
   values, which rode the step's one fetch (``fetch_window``: one float64
   buffer, so int32-range counts stay exact). What reads HLO stays out: the
   ICI/DCN wire-byte split and ``set_comm_topology`` (the wire-byte scalars
   are 0 at world 1).
6. **Memory.** ``hbm_stats`` (JAX line 300) reads ``torch.cuda.memory_stats``:
   allocated bytes in use and their peak; None on the CPU. A host read of
   the caching allocator's counters, no device work.
"""

import atexit
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from .logging import logger


def _abstract_signature(args) -> tuple:
    """Per-leaf (shape, dtype, device) signature of a call's inputs — the key
    a program is recorded under; host values (numpy arrays, Python scalars)
    carry device None."""
    from torch.utils import _pytree as pytree
    sig = []
    for leaf in pytree.tree_leaves(args):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), leaf.dtype, str(leaf.device)))
            continue
        a = np.asarray(leaf)
        sig.append((tuple(a.shape), a.dtype, None))
    return tuple(sig)


class CompileRecord:
    """One observed first call (or capture) of one program signature: the
    JAX record's fields that the port measures."""

    __slots__ = ("signature", "compile_seconds", "flops", "hbm_bytes", "temp_bytes",
                 "flops_by_op", "count")

    def __init__(self, signature, compile_seconds, flops=0.0, temp_bytes=0, hbm_bytes=0.0,
                 flops_by_op=None):
        self.signature = signature
        self.compile_seconds = compile_seconds
        self.flops = flops
        self.hbm_bytes = hbm_bytes          # the byte counter's bytes of one call
        self.temp_bytes = temp_bytes        # a capture's graph-pool bytes
        self.flops_by_op = flops_by_op or {}
        self.count = 1


class CompileWatchdog:
    """Registry of every observed first call (training) or capture (serving),
    keyed (program name, abstract input signature). A program accumulating
    ``recompile_warn`` distinct signatures warns once by name."""

    def __init__(self, recompile_warn: int = 3):
        self.recompile_warn = max(int(recompile_warn), 2)
        self.records: Dict[str, Dict[tuple, CompileRecord]] = {}
        self._storm_warned = set()

    def record(self, name: str, sig, seconds: float, flops: float = 0.0,
               temp_bytes: int = 0, hbm_bytes: float = 0.0,
               flops_by_op=None) -> CompileRecord:
        per = self.records.setdefault(name, {})
        rec = per.get(sig)
        if rec is not None:
            rec.count += 1
            rec.compile_seconds += seconds
        else:
            rec = per[sig] = CompileRecord(sig, seconds, flops, temp_bytes=int(temp_bytes),
                                           hbm_bytes=hbm_bytes, flops_by_op=flops_by_op)
        n = sum(r.count for r in per.values())
        if len(per) >= self.recompile_warn and name not in self._storm_warned:
            self._storm_warned.add(name)
            logger.warning(
                f"[deepspeed_tpu_torch] telemetry: recompile storm — program {name!r} "
                f"has been recorded {n} times ({len(per)} distinct input signatures, "
                f"{self.compile_seconds(name):.1f} s total). Varying shapes/dtypes are "
                f"reaching the step; pad or bucket them.")
        return rec

    def compiles(self, name: Optional[str] = None) -> int:
        per = ([self.records.get(name, {})] if name is not None
               else self.records.values())
        return sum(r.count for d in per for r in d.values())

    def recompiles(self, name: Optional[str] = None) -> int:
        """Records beyond each program's first — the waste the watchdog hunts."""
        names = [name] if name is not None else list(self.records)
        return sum(max(self.compiles(n) - 1, 0) for n in names)

    def compile_seconds(self, name: Optional[str] = None) -> float:
        per = ([self.records.get(name, {})] if name is not None
               else self.records.values())
        return sum(r.compile_seconds for d in per for r in d.values())

    def peak_temp_bytes(self) -> int:
        return max((r.temp_bytes for d in self.records.values()
                    for r in d.values()), default=0)


class _WatchedProgram:
    """Watchdog proxy around one program (a callable on tensors): its first
    call on each abstract signature runs under the flop and byte counters
    and is recorded with its wall time; every call feeds the session's
    counters and runs inside a ``ds_program/<name>`` profiler range (what
    the profile ingest attributes device slices by). Adds no device work
    and no synchronization."""

    def __init__(self, name: str, fn, session: "TelemetrySession"):
        self._name = name
        self._fn = fn
        self._session = session
        self._range = PROGRAM_SCOPE_PREFIX + name
        self._costs: Dict[tuple, tuple] = {}

    def __call__(self, *args):
        sig = _abstract_signature(args)
        cost = self._costs.get(sig)
        with torch.profiler.record_function(self._range):
            if cost is None:
                out, flops, nbytes, per_op, seconds = self._session.count_call(self._fn, *args)
                cost = self._costs[sig] = (flops, nbytes)
                self._session.watchdog.record(self._name, sig, seconds, flops,
                                              hbm_bytes=nbytes, flops_by_op=per_op)
            else:
                out = self._fn(*args)
        self._session.note_execution(cost[0], hbm_bytes=cost[1])
        return out


# the profiler range each watched program's calls run in
PROGRAM_SCOPE_PREFIX = "ds_program/"


def pack_fetch(values, numerics=None):
    """One float64 buffer of 0-d ``values`` and the 1-D tensors of a
    ``numerics`` dict (host numpy entries pass through), and the function
    that unpacks its host copy into (floats, {key: numpy array}); integer
    tensors come back as int64 (float64 holds them exactly below 2^53)."""
    parts = [torch.as_tensor(v).detach().reshape(1).to(torch.float64) for v in values]
    layout = []
    host_entries = {}
    for key, t in (numerics or {}).items():
        if isinstance(t, torch.Tensor):
            flat = t.detach().reshape(-1)
            layout.append((key, flat.numel(), not flat.is_floating_point()))
            parts.append(flat.to(torch.float64))
        else:
            host_entries[key] = np.asarray(t)
    buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64)

    def unpack(host):
        host = np.asarray(host, dtype=np.float64)
        n = len(values)
        floats = [float(v) for v in host[:n]]
        out = dict(host_entries)
        for key, size, integral in layout:
            vals = host[n:n + size]
            out[key] = vals.astype(np.int64) if integral else vals
            n += size
        return floats, out

    return buf, unpack


def hbm_stats() -> Optional[Dict[str, int]]:
    """The current CUDA device's allocator counters as the JAX session's
    ``memory_stats`` keys (``bytes_in_use``, ``peak_bytes_in_use``), or None
    where CUDA is not in use (the CPU, as JAX's CPU backend). An alias of
    ``utils/hbm.py`` ``device_memory_stats``."""
    from .hbm import device_memory_stats
    return device_memory_stats()


class TelemetrySession:
    """One engine's telemetry: watched programs, per-step scalars through a
    SummaryMonitor, and the configured profiler trace window.

    ``monitor``: an existing SummaryMonitor to emit through; when None, the
    session opens its own at ``output_path``/``job_name`` (scalars.jsonl always;
    TensorBoard when importable). ``device``: the engine's device — the
    trace window records CUDA activity only on the card."""

    def __init__(self, monitor=None, peak_tflops: Optional[float] = None,
                 trace_dir: Optional[str] = None, trace_steps=None,
                 mfu_window: int = 20, recompile_warn: int = 3,
                 output_path: Optional[str] = None, job_name: Optional[str] = None,
                 run_id: Optional[str] = None, host_id: Optional[int] = None,
                 device=None, anatomy_spec=None):
        self.watchdog = CompileWatchdog(recompile_warn=recompile_warn)
        self.device = torch.device(device) if device is not None else None
        # step anatomy: a roofline ChipSpec (utils/roofline.resolve_spec)
        # switches on the Anatomy/* end_step scalars; None keeps it off
        self.anatomy_spec = anatomy_spec
        self.last_anatomy = None
        self.peak_tflops = float(peak_tflops) if peak_tflops else None
        self.trace_dir = trace_dir or "deepspeed_telemetry_trace"
        if run_id is None:
            from .numerics import default_run_id
            run_id = default_run_id()
        self.run_id = run_id
        if host_id is None:
            from .cluster import _process_index
            host_id = _process_index()
        self.host_id = int(host_id)
        self.trace_output_dir = (
            os.path.join(self.trace_dir,
                         f"trace_{self.run_id}_host{self.host_id}")
            if self.run_id else self.trace_dir)
        self.trace_steps = tuple(trace_steps) if trace_steps is not None else None
        self.trace_path = None              # the exported Chrome trace
        # profile observatory: off until configure_profile
        self.profile_enabled = False
        self.profile_rel_tol = None
        self.profile_emit_scalars = True
        self.last_profile = None
        self._window_counters = None        # counters when the trace window opened
        self.metric_store = None
        self.alert_engine = None
        self.metrics_export_path = None
        self._owns_monitor = monitor is None
        if monitor is None:
            from .monitor import SummaryMonitor
            monitor = SummaryMonitor(output_path or None,
                                     job_name or "DeepSpeedTelemetry")
        self.monitor = monitor

        # step-metric state: host counters fed by the watched programs
        self.flops_executed = 0.0
        self.wire_bytes_executed = 0
        self.hbm_bytes_executed = 0.0
        self.exposed_ici_executed = 0.0
        self.exposed_dcn_executed = 0.0
        self.steps_recorded = 0
        self.last_mfu = None
        self.last_step_ms = None
        self.last_dispatch_ms = None
        self._dispatch_base = None
        self.last_wire_bytes = 0
        self.last_wire_bytes_ici = 0
        self.last_wire_bytes_dcn = 0
        self.last_losses = None             # host floats of the last fetch
        self.last_numerics = None           # the sentinel's host values, same fetch
        self._fetched = None                # (id of the pending list, values)
        self._dispatch_mark = None
        self._window = deque(maxlen=max(int(mfu_window), 1))  # (dt, flops)
        self._last_end = time.perf_counter()
        self._last_flops = 0.0
        self._last_wire = 0
        self._last_hbm = 0.0
        self._last_exp_ici = 0.0
        self._last_exp_dcn = 0.0
        self._last_compiles = 0

        # memory observatory: per-class resident bytes from the engine's
        # memory_manifest, set once, emitted as Memory/* in end_step
        self._memory_class_bytes = None
        self._memory_geometry = None
        self._forecast_config = None

        self._profiler = None
        self._trace_active = False
        self._trace_done = False
        self._trace_failed = False
        self._warned_perturbing = False
        self._noted_suppressed = False
        self._closed = False
        atexit.register(self.close)

    # ------------------------------------------------------------- watchdog
    def watch(self, name: str, fn):
        """Wrap a program in the compile watchdog (None passes through)."""
        if fn is None:
            return None
        return _WatchedProgram(name, fn, self)

    def count_call(self, fn, *args):
        """Run ``fn(*args)`` once under the flop and byte counters
        (``utils/flops_profiler.py``): returns (output, flops, bytes,
        {op: flops}, wall seconds)."""
        from .flops_profiler import count
        t0 = time.perf_counter()
        out, flops, nbytes, per_op = count(fn, *args)
        return out, flops, nbytes, per_op, time.perf_counter() - t0

    def record_capture(self, name: str, sig, seconds: float, pool_bytes: int):
        """A serving program's CUDA-graph capture: its record, the graph
        pool's bytes as its temp bytes."""
        return self.watchdog.record(name, sig, seconds, temp_bytes=pool_bytes)

    def note_execution(self, flops: float, wire_bytes: int = 0, hbm_bytes: float = 0.0,
                       exposed_ici_s: float = 0.0, exposed_dcn_s: float = 0.0):
        self.flops_executed += flops
        self.wire_bytes_executed += wire_bytes
        self.hbm_bytes_executed += hbm_bytes
        self.exposed_ici_executed += exposed_ici_s
        self.exposed_dcn_executed += exposed_dcn_s

    def set_memory_manifest(self, class_bytes, geometry=None, forecast_config=None):
        """Install the engine's per-class resident bytes (``utils/hbm.py``
        ``manifest_signatures`` over ``engine.memory_manifest()``), its
        geometry and an optional ``utils/hbm.forecast`` config (the flight
        recorder's OOM forensics suggest fitting deltas from it). Host state
        only: ``end_step`` emits the classes as ``Memory/*`` scalars."""
        self._memory_class_bytes = dict(class_bytes) if class_bytes else None
        self._memory_geometry = dict(geometry) if geometry else None
        self._forecast_config = forecast_config

    def memory_snapshot(self) -> Optional[Dict[str, Any]]:
        """The OOM-forensics input: manifest classes, geometry, the
        allocator's watermarks and the watchdog's temp peak; None without a
        manifest (telemetry.hbm off)."""
        if self._memory_class_bytes is None:
            return None
        return {
            "classes": dict(self._memory_class_bytes),
            "geometry": dict(self._memory_geometry or {}),
            "measured": hbm_stats(),
            "temp_peak_bytes": self.watchdog.peak_temp_bytes(),
            "forecast_config": self._forecast_config,
        }

    def configure_profile(self, enabled: bool, reconcile_tolerance=None,
                          emit_scalars: bool = True):
        """Switch the profile observatory on: when a trace window closes,
        ``end_step`` ingests the Chrome trace it wrote
        (``utils/profile_ingest.py``) into ``last_profile`` and
        ``Profile/*`` scalars."""
        self.profile_enabled = bool(enabled)
        self.profile_rel_tol = reconcile_tolerance
        self.profile_emit_scalars = bool(emit_scalars)

    def profile_snapshot(self) -> Optional[Dict[str, Any]]:
        """Flight-recorder embedding: the last ingested window's report and
        the window's disposition; None when nothing was ingested and the
        trace never failed."""
        if self.last_profile is None and not self._trace_failed:
            return None
        return {"trace_dir": self.trace_output_dir, "trace_failed": self._trace_failed,
                "report": self.last_profile}

    def _program_bytes(self, name):
        per = self.watchdog.records.get(name) or {}
        return float(list(per.values())[-1].hbm_bytes) if per else 0.0

    def _window_counter_values(self):
        return {"flops": self.flops_executed, "wire_ici": self.wire_bytes_executed,
                "wire_dcn": 0}

    def _ingest_profile(self, steps_wall_ms=None):
        """Read the just-closed window's Chrome trace back into the measured
        profile report (``utils/profile_ingest.py``), reconciled against the
        catalog and the session's counters over the window. Host file
        parsing after the export. On the card an empty trace raises
        (``ProfileParseError``): a window that saw no kernel is a fault, not
        a zero."""
        from .profile_ingest import (catalog_from_watchdog, device_slices, load_trace_dir,
                                     reconcile_profile, summarize_slices)
        a, b = self.trace_steps
        steps = max(b - a, 1)
        events, _files = load_trace_dir(self.trace_output_dir)
        cuda = self.device is not None and self.device.type == "cuda"
        catalog = catalog_from_watchdog(self.watchdog)
        slices = device_slices(events, device="cuda" if cuda else "cpu")
        report = summarize_slices(slices, catalog=catalog, devices=1, steps=steps,
                                  peak_tflops=self.peak_tflops)
        base = self._window_counters or self._window_counter_values()
        end = self._window_counter_values()
        derived = {"flops_per_step": (end["flops"] - base["flops"]) / steps,
                   "wire_ici_per_step": (end["wire_ici"] - base["wire_ici"]) // steps,
                   "wire_dcn_per_step": 0, "step_wall_ms": steps_wall_ms}
        rec = reconcile_profile(report, catalog, derived,
                                rel_tol=self.profile_rel_tol or 0.05)
        report["reconcile"] = {k: v for k, v in rec.items() if k != "measured"}
        if self.anatomy_spec is not None:
            # each traced program's anatomy: its counted cost beside its
            # measured collectives
            from .anatomy import analyze_program
            report["anatomy"] = [
                analyze_program(facts | {"hbm_bytes": self._program_bytes(name)},
                                self.anatomy_spec,
                                [x for x in slices if x["module"] == name], name=name)
                for name, facts in sorted(catalog.items())
                if any(x["module"] == name for x in slices)]
        self.last_profile = report
        return report

    def configure_metrics(self, enabled: bool = True, ring_len: int = 512,
                          strict: bool = False,
                          export_path: Optional[str] = None):
        """Switch the metric catalog router on (JAX lines 488-506)."""
        if not enabled:
            return
        from .metrics import MetricStore, default_catalog
        self.metric_store = MetricStore(catalog=default_catalog(),
                                        ring_len=ring_len, strict=strict,
                                        host=self.host_id)
        if self.monitor is not None:
            self.monitor.metrics = self.metric_store
        self.metrics_export_path = export_path or None

    def configure_alerts(self, rules=None, recorder=None,
                         ring_len: int = 512):
        """Arm the alert plane (JAX lines 508-520)."""
        if self.metric_store is None:
            self.configure_metrics(ring_len=ring_len)
        from .alerts import AlertEngine
        self.alert_engine = AlertEngine(rules=rules, store=self.metric_store,
                                        monitor=self.monitor,
                                        recorder=recorder)

    def alerts_snapshot(self) -> Optional[Dict[str, Any]]:
        if self.metric_store is None and self.alert_engine is None:
            return None
        out: Dict[str, Any] = {}
        if self.alert_engine is not None:
            out.update(self.alert_engine.snapshot())
        if self.metric_store is not None:
            out["ring"] = self.metric_store.to_dict()
        return out

    # ------------------------------------------------------------- trace window
    def on_step_begin(self, global_step: int):
        """Trace-window bookkeeping; called at the first micro-step of a window
        with the number of COMPLETED optimizer steps (captures steps a..b-1 for
        ``trace_steps = [a, b]``)."""
        if self.trace_steps is None or self._trace_failed:
            return
        a, b = self.trace_steps
        if self._trace_active and global_step >= b:
            self._stop_trace()
        if not self._trace_active and not self._trace_done and a <= global_step < b:
            self._start_trace()

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        a, b = self.trace_steps
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(self.trace_output_dir, exist_ok=True)
            self._profiler = profile(activities=activities)
            self._profiler.start()
        except Exception as e:
            self._profiler = None
            self._trace_failed = True
            logger.warning(f"[deepspeed_tpu_torch] telemetry: profiler trace "
                           f"unavailable ({e!r}); trace window [{a}, {b}) skipped")
            return
        self._trace_active = True
        self._window_counters = self._window_counter_values()
        self._window_walls = []
        logger.info(f"[deepspeed_tpu_torch] telemetry: profiler trace started for "
                    f"steps {a}..{b - 1} -> {self.trace_output_dir}")

    def _stop_trace(self):
        path = os.path.join(self.trace_output_dir, "trace.json")
        try:
            self._profiler.stop()
            self._profiler.export_chrome_trace(path)
            self.trace_path = path
            logger.info(f"[deepspeed_tpu_torch] telemetry: profiler trace written "
                        f"to {path}")
        except Exception as e:
            self._trace_failed = True
            logger.warning(f"[deepspeed_tpu_torch] telemetry: stop_trace failed "
                           f"({e!r})")
        self._profiler = None
        self._trace_active = False
        self._trace_done = True

    # ------------------------------------------------------------- step metrics
    def mark_step_dispatched(self):
        """Host-local step boundary (JAX lines 605-614): the engine calls this
        when every host-side phase of the step is done and it is about to run
        the update; end_step turns it into ``last_dispatch_ms``."""
        self._dispatch_mark = time.perf_counter()

    def rebase_dispatch_window(self):
        """Restart the host-local dispatch window NOW (after the cluster
        heartbeat's allgather, a cross-host rendezvous)."""
        self._dispatch_base = time.perf_counter()

    def fetch_window(self, pending, extra=(), numerics=None):
        """The step's one blocking operation: a single ``.cpu()`` of one
        float64 buffer holding the window's loss scalars (0-d tensors),
        ``extra`` scalars (the engine's grad norm) and the ``numerics``
        sentinel's vectors (``pack_fetch``). Returns (losses, extras) as
        host floats and remembers them with the sentinel's host values
        (``last_numerics``), so ``end_step`` on the same list fetches
        nothing."""
        if not pending and numerics is None:
            return [], []
        key = id(pending)
        if self._fetched is not None and self._fetched[0] == key:
            return self._fetched[1]
        values = list(pending) + list(extra)
        buf, unpack = pack_fetch(values, numerics)
        host, self.last_numerics = unpack(buf.cpu())
        out = (host[:len(pending)], host[len(pending):])
        self._fetched = (key, out)
        if pending:
            self.last_losses = out[0]
        return out

    def end_step(self, global_step: int, samples_per_step: int, pending=None,
                 numerics=None, serving=None, schedule_goodput=None, run_goodput=None):
        """Close one optimizer step's metrics (JAX lines 624-818). The ONLY
        blocking operation is the fetch of ``pending``'s loss scalars with
        the ``numerics`` sentinel's vectors (``fetch_window``; already done
        when the engine emitted its own scalars from it). ``global_step`` is
        the count of completed steps. Returns the sentinel's host values (or
        None). ``schedule_goodput``, ``run_goodput`` and ``serving`` emit
        ``Pipeline/Goodput/*``, ``Run/Goodput/*`` and ``Serving/Latency/*``
        scalars, as in JAX."""
        fetch_start = self._dispatch_mark
        if fetch_start is None:
            fetch_start = time.perf_counter()
        self._dispatch_mark = None
        numerics_host = None
        if pending or numerics is not None:
            self.fetch_window(pending, numerics=numerics)
            if numerics is not None:
                numerics_host = self.last_numerics
        self._fetched = None
        now = time.perf_counter()
        compiles = self.watchdog.compiles()
        dt = now - self._last_end
        dispatch_base = (self._dispatch_base if self._dispatch_base is not None
                         else self._last_end)
        dispatch_dt = fetch_start - dispatch_base
        self._dispatch_base = None
        flops_d = self.flops_executed - self._last_flops
        wire_d = self.wire_bytes_executed - self._last_wire
        hbm_d = self.hbm_bytes_executed - self._last_hbm
        exp_ici_d = self.exposed_ici_executed - self._last_exp_ici
        exp_dcn_d = self.exposed_dcn_executed - self._last_exp_dcn
        had_compile = compiles != self._last_compiles
        self._last_end = now
        self._last_flops = self.flops_executed
        self._last_wire = self.wire_bytes_executed
        self._last_hbm = self.hbm_bytes_executed
        self._last_exp_ici = self.exposed_ici_executed
        self._last_exp_dcn = self.exposed_dcn_executed
        self._last_compiles = compiles

        samples = global_step * samples_per_step
        mon = self.monitor
        self.last_step_ms = dt * 1000.0
        self.last_dispatch_ms = max(dispatch_dt, 0.0) * 1000.0
        self.last_wire_bytes = wire_d
        self.last_wire_bytes_ici = wire_d
        self.last_wire_bytes_dcn = 0
        self.steps_recorded += 1
        if self._trace_active:
            self._window_walls.append(self.last_step_ms)
        mon.add_scalar("Telemetry/Samples/step_time_ms", dt * 1000.0, samples)
        if dt > 0:
            mon.add_scalar("Telemetry/Samples/samples_per_sec",
                           samples_per_step / dt, samples)
        mon.add_scalar("Telemetry/Samples/wire_bytes", wire_d, samples)
        mon.add_scalar("Telemetry/Samples/wire_bytes_ici", wire_d, samples)
        mon.add_scalar("Telemetry/Samples/wire_bytes_dcn", 0, samples)
        # rolling MFU over record-free steps: a step that paid a first call
        # would poison the window with its counting overhead
        if not had_compile and flops_d > 0 and dt > 0:
            self._window.append((dt, flops_d))
        if self.peak_tflops and self._window:
            from .flops_profiler import mfu as _mfu
            tot_dt = sum(d for d, _ in self._window)
            tot_f = sum(f for _, f in self._window)
            self.last_mfu = _mfu({"flops": tot_f}, tot_dt, self.peak_tflops)
            mon.add_scalar("Telemetry/Samples/mfu", self.last_mfu, samples)
        stats = hbm_stats()
        if stats is not None:
            mon.add_scalar("Telemetry/Samples/hbm_in_use_bytes",
                           stats.get("bytes_in_use", 0), samples)
            mon.add_scalar("Telemetry/Samples/hbm_peak_bytes",
                           stats.get("peak_bytes_in_use", 0), samples)
        mon.add_scalar("Telemetry/Samples/compile_count", compiles, samples)
        # per-class resident bytes: host constants the engine installed once
        if self._memory_class_bytes is not None:
            for cls, nbytes in sorted(self._memory_class_bytes.items()):
                mon.add_scalar(f"Memory/{cls}_bytes", nbytes, samples)
            mon.add_scalar("Memory/compiled_temp_peak_bytes",
                           self.watchdog.peak_temp_bytes(), samples)
        # step anatomy: the roofline attribution of this step's measured wall
        # from the counted flops and bytes (host arithmetic)
        if self.anatomy_spec is not None and dt > 0 and not had_compile:
            from .roofline import roofline
            rf = roofline(flops_d, hbm_d, exp_ici_d, exp_dcn_d, self.anatomy_spec,
                          measured_seconds=dt)
            self.last_anatomy = rf
            mon.add_scalar("Anatomy/compute_ms", rf["compute_s"] * 1000.0, samples)
            mon.add_scalar("Anatomy/hbm_bound_ms", rf["hbm_bound_s"] * 1000.0, samples)
            mon.add_scalar("Anatomy/exposed_ici_ms", rf["exposed_ici_s"] * 1000.0, samples)
            mon.add_scalar("Anatomy/exposed_dcn_ms", rf["exposed_dcn_s"] * 1000.0, samples)
            mon.add_scalar("Anatomy/host_gap_ms", rf["host_gap_s"] * 1000.0, samples)
            mon.add_scalar("Anatomy/predicted_floor_ms", rf["predicted_floor_s"] * 1000.0,
                           samples)
            mon.add_scalar("Anatomy/mfu_ceiling", rf["mfu_ceiling"], samples)
        if schedule_goodput:
            for key in ("fwd_seconds", "bwd_seconds", "p2p_seconds", "load_seconds",
                        "reduce_seconds", "opt_seconds", "bubble_seconds",
                        "pipeline_seconds"):
                if key in schedule_goodput:
                    mon.add_scalar(f"Pipeline/Goodput/{key}",
                                   schedule_goodput[key], samples)
            if schedule_goodput.get("bubble_fraction") is not None:
                mon.add_scalar("Pipeline/Goodput/bubble_fraction",
                               schedule_goodput["bubble_fraction"], samples)
        if run_goodput:
            for key in sorted(run_goodput):   # sorted: deterministic order
                mon.add_scalar(key, run_goodput[key], samples)
        if serving:
            for key in sorted(serving):   # sorted: deterministic scalar order
                mon.add_scalar(f"Serving/Latency/{key}", serving[key], samples)
        mon.flush()
        if self._trace_active and self.trace_steps is not None \
                and global_step >= self.trace_steps[1]:
            self._stop_trace()
            if self.profile_enabled and not self._trace_failed:
                walls = self._window_walls
                prof = self._ingest_profile(sum(walls) / len(walls) if walls else None)
                if self.profile_emit_scalars:
                    self._emit_profile(prof, samples)
        if self.alert_engine is not None:
            # host-side reads of the metric ring on the end_step axis
            self.alert_engine.evaluate(samples)
        return numerics_host

    def _emit_profile(self, prof, samples):
        mon = self.monitor
        steps = max(prof["steps"], 1)
        cls = prof["classes"]
        mon.add_scalar("Profile/compute_ms", cls["compute"]["busy_us"] / steps / 1e3, samples)
        mon.add_scalar("Profile/collective_ici_ms",
                       cls["collective_ici"]["busy_us"] / steps / 1e3, samples)
        mon.add_scalar("Profile/collective_dcn_ms",
                       cls["collective_dcn"]["busy_us"] / steps / 1e3, samples)
        mon.add_scalar("Profile/exposed_ici_ms",
                       cls["collective_ici"]["exposed_us"] / steps / 1e3, samples)
        mon.add_scalar("Profile/exposed_dcn_ms",
                       cls["collective_dcn"]["exposed_us"] / steps / 1e3, samples)
        mon.add_scalar("Profile/host_gap_ms", cls["host_gap"]["gap_us"] / steps / 1e3,
                       samples)
        mon.add_scalar("Profile/step_wall_ms", prof["step_wall_us"] / 1e3, samples)
        if prof.get("measured_mfu") is not None:
            mon.add_scalar("Profile/mfu", prof["measured_mfu"], samples)
        mon.flush()

    # ------------------------------------------------------------- breakdown gate
    def warn_perturbing_once(self):
        if not self._warned_perturbing:
            self._warned_perturbing = True
            logger.warning(
                "[deepspeed_tpu_torch] telemetry.perturbing_breakdown=true: barrier-"
                "per-section timers are ACTIVE — every section boundary synchronizes "
                "the device (torch.cuda.synchronize), serializing async dispatch. The "
                "numbers are for debugging section attribution only; disable for "
                "performance runs.")

    def note_breakdown_suppressed_once(self):
        if not self._noted_suppressed:
            self._noted_suppressed = True
            logger.info(
                "[deepspeed_tpu_torch] telemetry: wall_clock_breakdown=true is "
                "suppressed while telemetry is enabled (its per-section barriers "
                "would perturb the run being measured); set "
                "telemetry.perturbing_breakdown=true to force the breakdown timers "
                "anyway.")

    # ------------------------------------------------------------- reporting
    def summary(self) -> Dict[str, Any]:
        """One-shot digest (JAX lines 839-905)."""
        stats = hbm_stats() or {}
        anatomy = None
        if self.last_anatomy is not None:
            rf = self.last_anatomy
            anatomy = {
                "predicted_floor_ms": round(rf["predicted_floor_s"] * 1e3, 6),
                "compute_ms": round(rf["compute_s"] * 1e3, 6),
                "hbm_bound_ms": round(rf["hbm_bound_s"] * 1e3, 6),
                "exposed_ici_ms": round(rf["exposed_ici_s"] * 1e3, 6),
                "exposed_dcn_ms": round(rf["exposed_dcn_s"] * 1e3, 6),
                "host_gap_ms": round(rf["host_gap_s"] * 1e3, 6),
                "mfu_ceiling": round(rf["mfu_ceiling"], 4),
            }
        profile = None
        if self.last_profile is not None:
            prof = self.last_profile
            steps = max(prof["steps"], 1)
            cls = prof["classes"]
            profile = {
                "compute_ms": round(cls["compute"]["busy_us"] / steps / 1e3, 6),
                "collective_ici_ms": round(cls["collective_ici"]["busy_us"] / steps / 1e3, 6),
                "collective_dcn_ms": round(cls["collective_dcn"]["busy_us"] / steps / 1e3, 6),
                "exposed_ici_ms": round(cls["collective_ici"]["exposed_us"] / steps / 1e3, 6),
                "exposed_dcn_ms": round(cls["collective_dcn"]["exposed_us"] / steps / 1e3, 6),
                "host_gap_ms": round(cls["host_gap"]["gap_us"] / steps / 1e3, 6),
                "step_wall_ms": round(prof["step_wall_us"] / 1e3, 6),
                "measured_mfu": prof.get("measured_mfu"),
                "scopes": sorted(prof.get("scopes", {})),
                "steps": prof["steps"],
            }
        trace = None
        if self.trace_steps is not None:
            trace = {
                "trace_dir": self.trace_output_dir,
                "steps": list(self.trace_steps),
                "active": self._trace_active,
                "done": self._trace_done,
                "failed": self._trace_failed,
            }
        return {
            "mfu": self.last_mfu,
            "step_time_ms": self.last_step_ms,
            "steps_recorded": self.steps_recorded,
            "anatomy": anatomy,
            "trace": trace,
            "profile": profile,
            "wire_bytes_per_step": self.last_wire_bytes,
            "wire_bytes_per_step_ici": self.last_wire_bytes_ici,
            "wire_bytes_per_step_dcn": self.last_wire_bytes_dcn,
            "hbm_in_use_bytes": int(stats.get("bytes_in_use", 0)),
            "hbm_peak_bytes": int(stats.get("peak_bytes_in_use", 0)),
            "compile_count": self.watchdog.compiles(),
            "recompile_count": self.watchdog.recompiles(),
            "compile_seconds": round(self.watchdog.compile_seconds(), 3),
            "compiled_temp_bytes_peak": self.watchdog.peak_temp_bytes(),
        }

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._trace_active:
            self._stop_trace()
        if self.metrics_export_path and self.metric_store is not None:
            try:
                from .metrics import export_store
                export_store(self.metric_store, self.metrics_export_path)
            except OSError as e:  # export failure must never kill shutdown
                logger.warning(f"[deepspeed_tpu_torch] metrics export failed: {e}")
        if self._owns_monitor and self.monitor is not None:
            self.monitor.close()
