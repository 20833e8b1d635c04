"""Static and dynamic loss scaling (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` with the same
ramp, backoff and hysteresis. The JAX state is a pytree of device scalars so
that the jitted step never leaves the device; the port's engine runs eagerly
and already reads the overflow flag on the host, so the state here is plain
Python numbers (the scale stays a power of two, or the floor, exactly as in
float32).
"""

from collections import deque
from typing import NamedTuple


class LossScaleState(NamedTuple):
    cur_scale: float
    cur_hysteresis: int
    last_overflow_iter: int
    iter_count: int


def init_state(static_loss_scale: float = 0,
               initial_scale_power: int = 32,
               hysteresis: int = 2) -> LossScaleState:
    """static_loss_scale > 0 -> fixed scale; 0 -> dynamic starting at 2**initial_scale_power."""
    init_scale = float(static_loss_scale) if static_loss_scale and static_loss_scale > 0 \
        else float(2**initial_scale_power)
    return LossScaleState(cur_scale=init_scale, cur_hysteresis=int(hysteresis),
                          last_overflow_iter=-1, iter_count=0)


def update(state: LossScaleState,
           overflow: bool,
           dynamic: bool,
           scale_window: int = 1000,
           scale_factor: float = 2.0,
           min_scale: float = 1.0,
           hysteresis: int = 2) -> LossScaleState:
    """Advance the scaler after a step whose grads overflowed (or not).

    On overflow, consume hysteresis; only when it is exhausted divide the
    scale by scale_factor (floored at min_scale). After ``scale_window``
    iterations since the last overflow, multiply by scale_factor and reset
    the hysteresis.
    """
    it = state.iter_count + 1
    if not dynamic:
        return state._replace(iter_count=it)
    if overflow:
        if state.cur_hysteresis <= 1:
            return LossScaleState(max(state.cur_scale / scale_factor, min_scale),
                                  state.cur_hysteresis, it, it)
        return LossScaleState(state.cur_scale, max(state.cur_hysteresis - 1, 0), it, it)
    if (it - state.last_overflow_iter) % scale_window == 0:
        return LossScaleState(state.cur_scale * scale_factor, int(hysteresis),
                              state.last_overflow_iter, it)
    return state._replace(iter_count=it)


class LossScaleJournal:
    """Host-side shadow of :func:`update` that turns the state transitions
    into structured events (ramp, backoff, skip, min-scale floor,
    consecutive-skip streaks), replaying the update on the per-step
    overflow bool. A copy of the JAX package's journal (host-only)."""

    def __init__(self, dynamic, init_scale, scale_window=1000, scale_factor=2.0,
                 min_scale=1.0, hysteresis=2, emit=None, max_events=1024):
        self.dynamic = bool(dynamic)
        self.cur_scale = float(init_scale)
        self.scale_window = int(scale_window)
        self.scale_factor = float(scale_factor)
        self.min_scale = float(min_scale)
        self.hysteresis = int(hysteresis)
        self.cur_hysteresis = int(hysteresis)
        self.last_overflow_iter = -1
        self.iter_count = 0
        self.skip_streak = 0
        self.emit = emit  # callable(event_dict, step)
        self.events = deque(maxlen=int(max_events))

    def _event(self, step, kind, **fields):
        ev = dict(fields, kind=kind, step=step, scale=self.cur_scale)
        self.events.append(ev)
        if self.emit is not None:
            self.emit(ev, step)
        return ev

    def record(self, step, overflowed):
        """Advance the shadow state one step; returns the events it emitted."""
        emitted = []
        it = self.iter_count + 1
        if overflowed:
            self.skip_streak += 1
            if self.dynamic:
                if self.cur_hysteresis <= 1:
                    prev = self.cur_scale
                    self.cur_scale = max(self.cur_scale / self.scale_factor,
                                         self.min_scale)
                    emitted.append(self._event(step, "backoff", previous=prev))
                    if self.cur_scale <= self.min_scale:
                        emitted.append(self._event(step, "min_scale_floor"))
                else:
                    self.cur_hysteresis -= 1
                    emitted.append(self._event(
                        step, "hysteresis", remaining=self.cur_hysteresis))
            self.last_overflow_iter = it
            emitted.append(self._event(step, "skip", streak=self.skip_streak))
        else:
            if self.skip_streak:
                emitted.append(self._event(step, "recovered",
                                           streak=self.skip_streak))
            self.skip_streak = 0
            if self.dynamic and (it - self.last_overflow_iter) % self.scale_window == 0:
                prev = self.cur_scale
                self.cur_scale *= self.scale_factor
                self.cur_hysteresis = self.hysteresis
                emitted.append(self._event(step, "ramp", previous=prev))
        self.iter_count = it
        return emitted
