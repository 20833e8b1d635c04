"""Wall-clock and throughput timers (PyTorch port).

Counterpart of ``deepspeed_tpu/utils/timer.py``. A timer boundary must
drain the device's queue, or it measures the enqueue: the engine hands the
timers ``torch.cuda.synchronize`` when it runs on the card and nothing on
the CPU (``device_sync``).
"""

import time
from typing import Callable, Dict, List, Optional

import torch

from .logging import logger


def device_sync(device) -> Callable[[], None]:
    """The boundary fence for ``device``: ``torch.cuda.synchronize`` on a
    card, a no-op on the CPU (its ops complete before they return)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def _memory_usage() -> str:
    if not torch.cuda.is_available():
        return "Mem stats unavailable"
    in_use = torch.cuda.memory_allocated() / (1024**3)
    peak = torch.cuda.max_memory_allocated() / (1024**3)
    return f"Mem in-use {round(in_use, 2)} GB | peak {round(peak, 2)} GB"


class SynchronizedWallClockTimer:
    """Group of named timers whose start/stop drain the device work queue."""

    class Timer:

        def __init__(self, name: str, sync_fn: Callable[[], None]):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0
            self._sync = sync_fn

        def start(self):
            if self.started_:
                raise RuntimeError(f"timer {self.name_} has already been started")
            self._sync()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False):
            if not self.started_:
                raise RuntimeError(f"timer {self.name_} is not started")
            self._sync()
            if reset:
                self.elapsed_ = time.time() - self.start_time
            else:
                self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

    def __init__(self, sync_fn: Optional[Callable[[], None]] = None):
        self.timers: Dict[str, SynchronizedWallClockTimer.Timer] = {}
        self._sync = sync_fn or (lambda: None)

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self._sync)
        return self.timers[name]

    @staticmethod
    def memory_usage() -> str:
        return _memory_usage()

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False):
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += " | {}: {:.2f}".format(name, elapsed_time)
        if memory_breakdown:
            string += " | " + self.memory_usage()
        logger.info(string)


class ThroughputTimer:

    def __init__(self,
                 batch_size: int,
                 num_workers: int,
                 start_step: int = 2,
                 steps_per_output: int = 50,
                 monitor_memory: bool = False,
                 logging_fn=None,
                 sync_fn: Optional[Callable[[], None]] = None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self._sync = sync_fn or (lambda: None)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def start(self):
        self.started = True
        if self.total_step_count >= self.start_step:
            self._sync()
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count > self.start_step:
            self._sync()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if report_speed and self.local_step_count % self.steps_per_output == 0:
                self.logging("{}/{}, SamplesPerSec={:.4f}".format(self.epoch_count, self.local_step_count,
                                                                  self.avg_samples_per_sec()))
                if self.monitor_memory:
                    self.logging(_memory_usage())

    def avg_samples_per_sec(self):
        if self.total_step_count > self.start_step and self.total_elapsed_time > 0:
            samples_per_step = self.batch_size * self.num_workers
            avg_time_per_step = self.total_elapsed_time / (self.total_step_count - self.start_step)
            return samples_per_step / avg_time_per_step
        return float("-inf")
