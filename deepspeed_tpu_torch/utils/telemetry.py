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
4. **Flops for MFU.** ``cost_analysis()`` (``_analyze_compiled``, lines
   61-127) has no counterpart. Each program's flops are counted once per
   signature, on that first call, by ``torch.utils.flop_counter.
   FlopCounterMode``: the matrix products (``mm``, ``bmm``, ``addmm``,
   ``baddbmm``, convolutions, scaled-dot-product attention) of everything
   dispatched through ATen in the call — the forward, autograd's backward
   and any recompute under activation checkpointing — plus the port's flash
   forward op (``deepspeed_tpu_torch::flash_fwd``, 4·B·H·Tq·Tk·D, registered
   here as the sdpa formula counts it). Not counted: elementwise work
   (LayerNorm, GELU, softmax, the optimizer; XLA's count includes it) and
   the flash backward kernels, which autograd launches through ctypes
   without a dispatcher op. Every later call of the program adds the
   recorded count.
5. **What reads HLO stays out** (ROADMAP.md item 22b): the step anatomy
   (``summary()["anatomy"]`` is None), the ICI/DCN wire-byte split and
   ``set_comm_topology`` (the wire-byte scalars are 0 at world 1), the
   memory manifest (``Memory/*``), the measured-profile ingest
   (``Profile/*``) and the numerics sentinel ``end_step`` fetches in JAX;
   the engine refuses their config blocks.
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


_FLASH_FORMULA = []


def _register_flash_formula():
    """Count the port's flash forward op as ``FlopCounterMode`` counts
    scaled-dot-product attention: two ``[Tq, D] x [D, Tk]``-sized products a
    head."""
    if _FLASH_FORMULA:
        return
    _FLASH_FORMULA.append(True)
    from torch.utils.flop_counter import register_flop_formula
    from ..ops import flash_attention  # noqa: F401  (defines the op)

    @register_flop_formula(torch.ops.deepspeed_tpu_torch.flash_fwd)
    def _flash_fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs):
        B, H, Tq, D = q_shape
        return 4 * B * H * Tq * k_shape[2] * D


class CompileRecord:
    """One observed first call (or capture) of one program signature: the
    JAX record's fields that the port measures."""

    __slots__ = ("signature", "compile_seconds", "flops", "temp_bytes", "count")

    def __init__(self, signature, compile_seconds, flops=0.0, temp_bytes=0):
        self.signature = signature
        self.compile_seconds = compile_seconds
        self.flops = flops
        self.temp_bytes = temp_bytes        # a capture's graph-pool bytes
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
               temp_bytes: int = 0) -> CompileRecord:
        per = self.records.setdefault(name, {})
        rec = per.get(sig)
        if rec is not None:
            rec.count += 1
            rec.compile_seconds += seconds
        else:
            rec = per[sig] = CompileRecord(sig, seconds, flops,
                                           temp_bytes=int(temp_bytes))
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
    call on each abstract signature runs under ``FlopCounterMode`` and is
    recorded with its wall time and flops; every call feeds the session's
    flops counter. Adds no device work and no synchronization."""

    def __init__(self, name: str, fn, session: "TelemetrySession"):
        self._name = name
        self._fn = fn
        self._session = session
        self._flops: Dict[tuple, float] = {}

    def __call__(self, *args):
        sig = _abstract_signature(args)
        flops = self._flops.get(sig)
        if flops is None:
            out, flops, seconds = self._session.count_call(self._fn, *args)
            self._flops[sig] = flops
            self._session.watchdog.record(self._name, sig, seconds, flops)
        else:
            out = self._fn(*args)
        self._session.note_execution(flops)
        return out


def hbm_stats() -> Optional[Dict[str, int]]:
    """The current CUDA device's allocator counters as the JAX session's
    ``memory_stats`` keys (``bytes_in_use``, ``peak_bytes_in_use``), or None
    where CUDA is not in use (the CPU, as JAX's CPU backend)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0))}


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
                 device=None):
        self.watchdog = CompileWatchdog(recompile_warn=recompile_warn)
        self.device = torch.device(device) if device is not None else None
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
        self.steps_recorded = 0
        self.last_mfu = None
        self.last_step_ms = None
        self.last_dispatch_ms = None
        self._dispatch_base = None
        self.last_wire_bytes = 0
        self.last_wire_bytes_ici = 0
        self.last_wire_bytes_dcn = 0
        self.last_losses = None             # host floats of the last fetch
        self._fetched = None                # (id of the pending list, values)
        self._dispatch_mark = None
        self._window = deque(maxlen=max(int(mfu_window), 1))  # (dt, flops)
        self._last_end = time.perf_counter()
        self._last_flops = 0.0
        self._last_wire = 0
        self._last_compiles = 0

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
        """Run ``fn(*args)`` once under ``FlopCounterMode``: returns (output,
        flops, wall seconds)."""
        from torch.utils.flop_counter import FlopCounterMode
        _register_flash_formula()
        t0 = time.perf_counter()
        counter = FlopCounterMode(display=False)
        with counter:
            out = fn(*args)
        return out, float(counter.get_total_flops()), time.perf_counter() - t0

    def record_capture(self, name: str, sig, seconds: float, pool_bytes: int):
        """A serving program's CUDA-graph capture: its record, the graph
        pool's bytes as its temp bytes."""
        return self.watchdog.record(name, sig, seconds, temp_bytes=pool_bytes)

    def note_execution(self, flops: float, wire_bytes: int = 0):
        self.flops_executed += flops
        self.wire_bytes_executed += wire_bytes

    def profile_snapshot(self) -> Optional[Dict[str, Any]]:
        if not self._trace_failed:
            return None
        return {"trace_dir": self.trace_output_dir, "trace_failed": True,
                "report": None}

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

    def fetch_window(self, pending, extra=()):
        """The step's one blocking operation: a single ``.cpu()`` of the
        window's loss scalars (0-d tensors) stacked with ``extra`` scalars
        (the engine's grad norm). Returns (losses, extras) as host floats and
        remembers them, so ``end_step`` on the same list fetches nothing."""
        if not pending:
            return [], []
        key = id(pending)
        if self._fetched is not None and self._fetched[0] == key:
            return self._fetched[1]
        vals = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                            for v in list(pending) + list(extra)])
        host = [float(v) for v in np.asarray(vals.cpu(), dtype=np.float64)]
        out = (host[:len(pending)], host[len(pending):])
        self._fetched = (key, out)
        self.last_losses = out[0]
        return out

    def end_step(self, global_step: int, samples_per_step: int, pending=None,
                 serving=None, schedule_goodput=None, run_goodput=None):
        """Close one optimizer step's metrics (JAX lines 624-816, without the
        numerics sentinel, item 22b). The ONLY blocking operation is the fetch
        of ``pending``'s loss scalars (``fetch_window``; already done when the
        engine emitted its own scalars from it). ``global_step`` is the count
        of completed steps. ``schedule_goodput``, ``run_goodput`` and
        ``serving`` emit ``Pipeline/Goodput/*``, ``Run/Goodput/*`` and
        ``Serving/Latency/*`` scalars, as in JAX."""
        fetch_start = self._dispatch_mark
        if fetch_start is None:
            fetch_start = time.perf_counter()
        self._dispatch_mark = None
        if pending:
            self.fetch_window(pending)
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
        had_compile = compiles != self._last_compiles
        self._last_end = now
        self._last_flops = self.flops_executed
        self._last_wire = self.wire_bytes_executed
        self._last_compiles = compiles

        samples = global_step * samples_per_step
        mon = self.monitor
        self.last_step_ms = dt * 1000.0
        self.last_dispatch_ms = max(dispatch_dt, 0.0) * 1000.0
        self.last_wire_bytes = wire_d
        self.last_wire_bytes_ici = wire_d
        self.last_wire_bytes_dcn = 0
        self.steps_recorded += 1
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
            tot_dt = sum(d for d, _ in self._window)
            tot_f = sum(f for _, f in self._window)
            self.last_mfu = tot_f / (tot_dt * self.peak_tflops * 1e12)
            mon.add_scalar("Telemetry/Samples/mfu", self.last_mfu, samples)
        stats = hbm_stats()
        if stats is not None:
            mon.add_scalar("Telemetry/Samples/hbm_in_use_bytes",
                           stats.get("bytes_in_use", 0), samples)
            mon.add_scalar("Telemetry/Samples/hbm_peak_bytes",
                           stats.get("peak_bytes_in_use", 0), samples)
        mon.add_scalar("Telemetry/Samples/compile_count", compiles, samples)
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
        if self.alert_engine is not None:
            # host-side reads of the metric ring on the end_step axis
            self.alert_engine.evaluate(samples)

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
            "anatomy": None,
            "trace": trace,
            "profile": None,
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
