"""Standalone mixed-precision optimizer wrapper for custom training loops
(PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/fp16/fused_optimizer.py``
(``FP16_Optimizer``, ``FP16_UnfusedOptimizer``) with the PyTorch idiom of the
reference DeepSpeed class: it wraps the model's compute-dtype parameters
(an iterable of tensors), keeps a float32 master copy of each, scales the
loss before autograd and writes the updated master back into the
parameters in place::

    opt = FP16_Optimizer(model.parameters(), optimizer="adamw", clip_grad=1.0)
    loss = model(batch)
    opt.backward(loss)        # (loss * scale).backward()
    opt.step()                # unscale, overflow check, clip, update, re-cast
    opt.zero_grad()

``step`` follows the JAX ``_step_impl`` in order: the grads (each
parameter's ``.grad``, or ``grads`` given explicitly) are widened to float32
and unscaled; ``detect_overflow`` flags an inf or nan; the clip scales them
to ``clip_grad``; on overflow the update is skipped and the master and the
optimizer state are left untouched; the loss scaler advances with its
hysteresis; the master is re-cast into the parameters; the step goes to the
``LossScaleJournal``. The one host read of a step is the overflow flag, as
the JAX wrapper's ``bool(jax.device_get(overflow))``; it is read before the
update, which is then skipped by a branch instead of a select.

The inner update is the port's ``ops/adam.py`` (``"adam"``: classic L2
Adam; ``"adamw"``: decoupled decay) or ``ops/lamb.py`` (``"lamb"``), with the
JAX ``groups`` per-leaf group ids and per-group hyper values (``lr=[1e-3,
5e-4]``); or a client ``inner_apply(grads, state, master, step, hyper) ->
(master, state)`` with ``inner_init(master) -> state`` on lists of float32
tensors, ``hyper`` a dict of Python floats and ``step`` the 1-based update
count.
"""

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ...ops import adam as adam_opt
from ...ops import lamb as lamb_opt
from ...utils import logger
from ..utils import clip_grads_by_global_norm, detect_overflow
from . import loss_scaler as ls


def _per_group(hyper: dict, groups) -> list:
    """The JAX hyper dict (a value, or one value a group) as the port's list
    of per-group dicts."""
    n = 1 if groups is None else max(int(g) for g in groups) + 1
    out = []
    for gi in range(n):
        out.append({k: (v[gi] if isinstance(v, (list, tuple)) else v)
                    for k, v in hyper.items()})
    return out


class FP16_Optimizer:
    """Mixed-precision wrapper around an inner update rule (reference
    fused_optimizer.py l.17). ``optimizer``: "adam" | "adamw" | "lamb", or a
    client ``inner_apply`` with its ``inner_init``."""

    def __init__(self,
                 init_params,
                 optimizer: str = "adamw",
                 static_loss_scale: float = 0.0,
                 dynamic_loss_scale: bool = True,
                 initial_scale_power: int = 16,
                 scale_window: int = 1000,
                 min_loss_scale: float = 1.0,
                 hysteresis: int = 2,
                 clip_grad: float = 0.0,
                 lr: float = 1e-3,
                 betas=(0.9, 0.999),
                 eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 inner_apply: Optional[Callable] = None,
                 inner_init: Optional[Callable] = None,
                 groups=None):
        self.params = [p for p in init_params]
        if not self.params or not all(isinstance(p, torch.Tensor) for p in self.params):
            raise TypeError("FP16_Optimizer takes an iterable of the model's parameters")
        self.clip_grad = float(clip_grad)
        self.dynamic = bool(dynamic_loss_scale) and not static_loss_scale
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.hysteresis = hysteresis
        self.hyper = {"lr": lr, "beta1": betas[0], "beta2": betas[1], "eps": eps,
                      "weight_decay": weight_decay}
        self.groups = None if groups is None else [int(g) for g in groups]
        if inner_apply is not None:
            if groups is not None:
                raise AssertionError("groups require a built-in inner optimizer")
            self._apply, self._init = inner_apply, inner_init
        elif optimizer in ("adam", "adamw"):
            adamw = optimizer == "adamw"
            self._apply = lambda g, s, p, t, h: adam_opt.apply(
                g, s, p, t, _per_group(h, self.groups), adamw=adamw, groups=self.groups)
            self._init = adam_opt.init
        elif optimizer == "lamb":
            self._apply = lambda g, s, p, t, h: lamb_opt.apply(
                g, s, p, t, _per_group(h, self.groups), groups=self.groups)
            self._init = lamb_opt.init
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")

        # float32 master copy (reference fused_optimizer.py:48-66)
        with torch.no_grad():
            self.master = [p.detach().float().clone() for p in self.params]
        self.state = self._init(self.master)
        self.scaler = ls.init_state(static_loss_scale, initial_scale_power, hysteresis)
        # host-side shadow of the scaler: structured loss-scale events
        self.journal = ls.LossScaleJournal(self.dynamic, self.scaler.cur_scale,
                                           scale_window=scale_window,
                                           min_scale=min_loss_scale,
                                           hysteresis=hysteresis)
        self.steps = 0
        self.overflow = False   # the last step's overflow flag (reference l.245)

    # ------------------------------------------------------------------ loss scaling
    @property
    def cur_scale(self) -> float:
        return float(self.scaler.cur_scale)

    # reference property name
    loss_scale = cur_scale

    def scale_loss(self, loss):
        return loss * torch.tensor(self.scaler.cur_scale, dtype=loss.dtype,
                                   device=loss.device)

    def backward(self, loss, retain_graph: bool = False):
        """Scaled backward (reference backward l.159: loss * scale ->
        autograd). The scaled grads land in each parameter's ``.grad``;
        returns the unscaled loss, detached."""
        self.scale_loss(loss).backward(retain_graph=retain_graph)
        return loss.detach()

    # ------------------------------------------------------------------ step
    @torch.no_grad()
    def step(self, grads=None):
        """Unscale, overflow check, clip, inner update, re-cast (reference
        l.191-273). ``grads``: the scaled grads, one a parameter; default
        each parameter's ``.grad`` (a parameter without one contributes
        zeros). Returns the overflow flag."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        scale = self.scaler.cur_scale
        inv = 1.0 / scale if scale > 0 else 1.0
        grads = [g.float() * inv for g in grads]
        overflow, _ = detect_overflow(grads, fp16_active=True)
        overflow = bool(overflow)           # the step's one host read
        if not overflow:
            if self.clip_grad > 0:
                clip_grads_by_global_norm(grads, self.clip_grad)
            self.steps += 1
            master, self.state = self._apply(grads, self.state, self.master, self.steps,
                                             dict(self.hyper))
            for m, new in zip(self.master, master):
                if new is not m:
                    m.copy_(new)
        self.scaler = ls.update(self.scaler, overflow, dynamic=self.dynamic,
                                scale_window=self.scale_window,
                                min_scale=self.min_loss_scale, hysteresis=self.hysteresis)
        if not overflow:
            for p, m in zip(self.params, self.master):
                p.copy_(m.to(p.dtype))
        self.overflow = overflow
        self.journal.record(self.journal.iter_count + 1, overflow)
        if overflow:
            logger.info(f"[fp16] OVERFLOW — skipping step, new loss scale {self.cur_scale}")
        return overflow

    def zero_grad(self, set_grads_to_None: bool = True):
        for p in self.params:
            if set_grads_to_None:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    # ------------------------------------------------------------------ checkpointing
    def state_dict(self):
        return {"master": self.master, "state": self.state, "scaler": self.scaler,
                "steps": self.steps, "overflow": self.overflow,
                "dynamic_loss_scale": self.dynamic, "clip_grad": self.clip_grad}

    @torch.no_grad()
    def load_state_dict(self, sd, load_optimizer_states: bool = True):
        """Copy the saved master into this wrapper's (and re-cast it into the
        parameters, which are the model's state in the PyTorch idiom), a copy
        of the optimizer state when asked, the scaler and the step count."""
        for m, s in zip(self.master, sd["master"]):
            m.copy_(torch.as_tensor(s))
        if load_optimizer_states and "state" in sd:
            # a copy: the inner rules update their state in place
            self.state = pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, sd["state"])
        self.scaler = ls.LossScaleState(*sd["scaler"])
        self.steps = int(sd["steps"])
        self.overflow = bool(sd.get("overflow", False))
        for p, m in zip(self.params, self.master):
            p.copy_(m.to(p.dtype))


class FP16_UnfusedOptimizer(FP16_Optimizer):
    """Reference ``unfused_optimizer.py`` hosted LAMB per tensor (l.376); as
    in the JAX package, this subclass only defaults to LAMB."""

    def __init__(self, init_params, optimizer: str = "lamb", **kw):
        super().__init__(init_params, optimizer=optimizer, **kw)
