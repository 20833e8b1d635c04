"""Training-scalar monitor (TensorBoard + JSONL).

PyTorch port of ``deepspeed_tpu/utils/monitor.py`` (lines 1-101), unchanged
but for the writer's rank: ``jax.process_index()`` (line 25) becomes the
``torch.distributed`` rank when a process group is initialized, else 0.

TPU-native analog of the reference's tensorboardX wiring
(``deepspeed/runtime/engine.py:151-152, 246-261`` creates a SummaryWriter behind the
``tensorboard`` config block; scalars emitted at engine.py:779-790, 920-936,
950-974). Differences: scalars are ALWAYS mirrored to a newline-delimited JSON file
(cheap, dependency-free, machine-parseable) and TensorBoard events are written
additionally when a writer implementation is importable. Only process 0 writes.
"""

import atexit
import json
import os
import time
from typing import Optional

from .logging import logger


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class SummaryMonitor:
    """Scalar sink: JSONL always, TensorBoard when available."""

    def __init__(self, output_path: Optional[str] = None, job_name: Optional[str] = None,
                 enabled: bool = True):
        self.enabled = enabled and _rank() == 0
        self._tb = None
        self._jsonl = None
        self._events = None
        # MetricStore hook (utils/metrics.py), set by
        # TelemetrySession.configure_metrics. Lives on EVERY rank and is fed
        # before the rank-0 early return so each host's metric ring is
        # populated even though only process 0 writes files.
        self.metrics = None
        # log_dir is part of the public surface on EVERY rank (rank-agnostic
        # callers read it), so it must be set before the disabled early-return.
        output_path = output_path or os.path.join(os.environ.get("DLWS_JOB_ID", "."),
                                                  "deepspeed_monitor")
        job_name = job_name or "DeepSpeedJobName"
        self.log_dir = os.path.join(output_path, job_name)
        if not self.enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        # block-buffered: one write syscall per flush() (telemetry flushes at
        # every end_step), not one per scalar. The flight recorder flushes
        # this stream before dumping so a crash loses nothing (numerics.py).
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        atexit.register(self.close)  # flush TB events on normal interpreter exit
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=self.log_dir)
        except Exception as e:  # tensorboard package missing etc. — JSONL still works
            logger.info(f"[deepspeed_tpu_torch] tensorboard writer unavailable ({e!r}); "
                        f"scalars go to {self.log_dir}/scalars.jsonl only")

    def add_scalar(self, name: str, value, global_step: int):
        if self.metrics is not None:
            # catalog routing + ring recording happens on every rank and for
            # every emitter (engine, serving, router, cluster, numerics all
            # share this monitor object) — strict mode may raise here, which
            # is the drift guard doing its job.
            self.metrics.observe(name, value, global_step)
        if not self.enabled:
            return
        value = float(value)
        self._jsonl.write(json.dumps({"tag": name, "value": value, "step": int(global_step),
                                      "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, global_step)

    def event(self, name: str, payload, step: Optional[int] = None):
        """Structured (non-scalar) event sink — loss-scale journal entries,
        desync-audit results, etc. Written to events.jsonl beside scalars.jsonl;
        the file is created lazily so scalar-only jobs keep a clean log dir."""
        if not self.enabled:
            return
        if self._events is None:
            self._events = open(os.path.join(self.log_dir, "events.jsonl"), "a")
        self._events.write(json.dumps(
            {"event": name, "step": None if step is None else int(step),
             "payload": payload, "time": time.time()}, default=repr) + "\n")

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._events is not None:
            self._events.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.enabled = False  # a late add_scalar (e.g. one more step) becomes a no-op
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._events is not None:
            self._events.close()
            self._events = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
