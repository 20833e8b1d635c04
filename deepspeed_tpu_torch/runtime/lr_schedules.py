"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` for the PyTorch port (it
uses no JAX): the schedulers mutate the host-side ``param_groups`` dicts of
the engine's optimizer handle, which the engine reads at every step.
"""

import math
from typing import Union, List

from ..utils import logger

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"
CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"
CYCLE_MOMENTUM = "cycle_momentum"
CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"


def _get_optimizer_handle(optimizer):
    """Any object with a ``param_groups`` list of dicts works as the handle."""
    if hasattr(optimizer, "param_groups"):
        return optimizer
    raise TypeError(f"{type(optimizer).__name__} does not expose param_groups; "
                    "wrap it in an engine optimizer handle")


def _format_param(optimizer, param_value, param_name) -> List[float]:
    if isinstance(param_value, (list, tuple)):
        if len(param_value) != len(optimizer.param_groups):
            raise ValueError("expected {} value for {}, got {}".format(
                len(optimizer.param_groups), param_name, param_value))
        return list(param_value)
    return [param_value] * len(optimizer.param_groups)


class LRRangeTest:
    """LR range test: lr = min_lr * (1 + step_rate * interval(step))."""

    def __init__(self,
                 optimizer,
                 lr_range_test_min_lr: Union[float, List[float]] = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        self.optimizer = _get_optimizer_handle(optimizer)
        self.min_lr = _format_param(self.optimizer, lr_range_test_min_lr, "lr_range_test_min_lr")
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _interval(self) -> float:
        frac = float(self.last_batch_iteration) / self.step_size
        return float(math.floor(frac)) if self.staircase else frac

    def get_lr(self):
        increase = 1 + self.step_rate * self._interval()
        return [lr * increase for lr in self.min_lr]

    def get_last_lr(self):
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        self._last_lr = list(group_lrs)
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group["lr"] = lr

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class OneCycle:
    """1-cycle policy: lr rises over the first leg, falls over the second, then decays;
    momentum cycles inversely when cycle_momentum is set."""

    def __init__(self,
                 optimizer,
                 cycle_min_lr,
                 cycle_max_lr,
                 decay_lr_rate=0.0,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 cycle_momentum=True,
                 cycle_min_mom=0.8,
                 cycle_max_mom=0.9,
                 decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        self.optimizer = _get_optimizer_handle(optimizer)

        cycle_first_step_size = float(cycle_first_step_size)
        cycle_second_step_size = float(
            cycle_second_step_size) if cycle_second_step_size is not None else cycle_first_step_size
        self.total_size = cycle_first_step_size + cycle_second_step_size
        self.step_ratio = cycle_first_step_size / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count
                                   if cycle_second_stair_count is None else cycle_second_stair_count)
        self.decay_step_size = max(decay_step_size, 1)

        self.min_lrs = [cycle_min_lr] * len(self.optimizer.param_groups)
        self.max_lrs = [cycle_max_lr] * len(self.optimizer.param_groups)
        self.decay_lr_rate = decay_lr_rate

        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            self.min_moms = [(cycle_min_mom, 0.99)] * len(self.optimizer.param_groups)
            self.max_moms = [(cycle_max_mom, 0.99)] * len(self.optimizer.param_groups)
            self.decay_mom_rate = decay_mom_rate

        self.last_batch_iteration = last_batch_iteration
        if last_batch_iteration == -1:
            self._update_optimizer(self.get_lr())

    def _cycle_progress(self):
        cycle = math.floor(1 + self.last_batch_iteration / self.total_size)
        x = 1.0 + self.last_batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            scale_factor = x / self.step_ratio
            stair_count = self.first_stair_count
        else:
            scale_factor = (x - 1) / (self.step_ratio - 1)
            stair_count = self.second_stair_count
        if stair_count:
            scale_factor = math.floor(scale_factor * stair_count) / stair_count
        return scale_factor

    def _get_cycle_lr(self):
        scale_factor = self._cycle_progress()
        lrs = [min_lr + (max_lr - min_lr) * scale_factor
               for min_lr, max_lr in zip(self.min_lrs, self.max_lrs)]
        if self.cycle_momentum:
            moms = [(max_mom[0] - (max_mom[0] - min_mom[0]) * scale_factor, max_mom[1])
                    for min_mom, max_mom in zip(self.min_moms, self.max_moms)]
            for param_group, momentum in zip(self.optimizer.param_groups, moms):
                param_group["betas"] = momentum
        return lrs

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        lr_decay_factor = 1 + self.decay_lr_rate * decay_interval
        lrs = [lr / lr_decay_factor for lr in self.min_lrs]
        if self.cycle_momentum:
            mom_decay_factor = 1 + self.decay_mom_rate * decay_interval
            moms = [(beta0 * mom_decay_factor, beta1) for beta0, beta1 in self.max_moms]
            for param_group, momentum in zip(self.optimizer.param_groups, moms):
                param_group["betas"] = momentum
        return lrs

    def get_lr(self):
        if self.last_batch_iteration <= self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size)

    def get_last_lr(self):
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        self._last_lr = list(group_lrs)
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group["lr"] = lr

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR:
    """Log-warmup from min_lr to max_lr over warmup_num_steps, then constant."""

    def __init__(self,
                 optimizer,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        self.optimizer = _get_optimizer_handle(optimizer)
        self.min_lrs = _format_param(self.optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = _format_param(self.optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [big - small for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = 1.0 / math.log(max(warmup_num_steps, 2))
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = list(self.min_lrs)

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta_lr * gamma) for min_lr, delta_lr in zip(self.min_lrs, self.delta_lrs)]

    def get_last_lr(self):
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        self._last_lr = list(lrs)
        for param_group, lr in zip(self.optimizer.param_groups, lrs):
            param_group["lr"] = lr

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 over total_num_steps."""

    def __init__(self,
                 optimizer,
                 total_num_steps: int,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning("total_num_steps {} is less than warmup_num_steps {}".format(
                total_num_steps, warmup_num_steps))

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


_SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_scheduler(name, optimizer, params: dict):
    """Instantiate a scheduler by config name (engine: reference engine.py:402-417)."""
    if name not in _SCHEDULES:
        raise ValueError(f"unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _SCHEDULES[name](optimizer, **params)


# ---------------------------------------------------------------------------
# CLI convergence-tuning arguments (reference lr_schedules.py:54-239): schedules can be
# configured/overridden from the command line in addition to the JSON config.
# ---------------------------------------------------------------------------

def add_tuning_arguments(parser):
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # Learning rate range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=None,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=None,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=None,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", default=None, action="store_true",
                       help="use staircase scaling for LR range test.")
    # OneCycle schedule
    group.add_argument("--cycle_first_step_size", type=int, default=None,
                       help="size of first step of 1Cycle schedule (training steps).")
    group.add_argument("--cycle_first_stair_count", type=int, default=None,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=None,
                       help="size of second step of 1Cycle schedule (default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=None,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=None,
                       help="size of intervals for applying post cycle decay (training steps).")
    group.add_argument("--cycle_min_lr", type=float, default=None,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=None,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=None,
                       help="post cycle LR decay rate.")
    group.add_argument("--cycle_momentum", default=None, action="store_true",
                       help="Enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=None,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=None,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=None,
                       help="post cycle momentum decay rate.")
    # Warmup LR
    group.add_argument("--warmup_min_lr", type=float, default=None,
                       help="WarmupLR minimum/initial LR value")
    group.add_argument("--warmup_max_lr", type=float, default=None,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=None,
                       help="WarmupLR step count for LR warmup.")
    return parser


def parse_arguments():
    import argparse
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


def _override_from(args, params, keys):
    for key in keys:
        if getattr(args, key, None) is not None:
            params[key] = getattr(args, key)


def override_lr_range_test_params(args, params):
    _override_from(args, params, (LR_RANGE_TEST_MIN_LR, LR_RANGE_TEST_STEP_RATE,
                                  LR_RANGE_TEST_STEP_SIZE, LR_RANGE_TEST_STAIRCASE))


def override_1cycle_params(args, params):
    _override_from(args, params, (CYCLE_FIRST_STEP_SIZE, CYCLE_FIRST_STAIR_COUNT,
                                  CYCLE_SECOND_STEP_SIZE, CYCLE_SECOND_STAIR_COUNT,
                                  DECAY_STEP_SIZE, CYCLE_MIN_LR, CYCLE_MAX_LR,
                                  DECAY_LR_RATE, CYCLE_MOMENTUM, CYCLE_MIN_MOM, CYCLE_MAX_MOM,
                                  DECAY_MOM_RATE))


def override_warmupLR_params(args, params):
    _override_from(args, params, (WARMUP_MIN_LR, WARMUP_MAX_LR, WARMUP_NUM_STEPS))


def override_params(args, params):
    override_lr_range_test_params(args, params)
    override_1cycle_params(args, params)
    override_warmupLR_params(args, params)
