"""SGD with momentum (PyTorch port of ``deepspeed_tpu/ops/sgd.py``): the same
math, ``_foreach`` ops, the contract of ``ops/adam.py`` (in place)."""

from typing import NamedTuple

import torch

from .adam import buckets, f32, group_hyper


class SgdState(NamedTuple):
    momentum_buf: list


def init(master) -> SgdState:
    return SgdState(momentum_buf=[torch.zeros_like(p, dtype=torch.float32) for p in master])


def apply(grads, state: SgdState, master, step, hyper, groups=None):
    hyper = group_hyper(hyper)
    for gi, idx in buckets(groups, len(master), [p.numel() for p in master]):
        h = hyper[gi]
        lr, wd = f32(h["lr"]), f32(h["weight_decay"])
        mom = f32(h.get("beta1", 0.0))  # momentum rides the beta1 slot
        p = [master[i] for i in idx]
        b = [state.momentum_buf[i] for i in idx]
        g = [grads[i].float() for i in idx]
        if wd:
            g = torch._foreach_add(g, p, alpha=wd)
        torch._foreach_mul_(b, mom)
        torch._foreach_add_(b, g)
        torch._foreach_add_(p, b, alpha=-lr)
    return master, state
