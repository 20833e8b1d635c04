"""LAMB (PyTorch port of ``deepspeed_tpu/ops/lamb.py``): an Adam-style update
with a per-tensor trust ratio ||p|| / ||update||, clamped to [min_coeff,
max_coeff]. The contract of ``ops/adam.py`` (in place), plus ``sumsq``: the
function that gives a leaf's squared norm, so that a ZeRO engine whose
leaves are shards can sum the squares over its ranks (default: local)."""

from typing import NamedTuple

import torch

from .adam import f32, group_hyper


class LambState(NamedTuple):
    exp_avg: list
    exp_avg_sq: list


def init(master) -> LambState:
    return LambState(exp_avg=[torch.zeros_like(p, dtype=torch.float32) for p in master],
                     exp_avg_sq=[torch.zeros_like(p, dtype=torch.float32) for p in master])


def _local_sumsq(i, t):
    return torch.sum(torch.square(t))


def apply(grads, state: LambState, master, step, hyper, max_coeff: float = 10.0,
          min_coeff: float = 0.01, groups=None, sumsq=_local_sumsq):
    hyper = group_hyper(hyper)
    ids = [0] * len(master) if groups is None else list(groups)
    for i, (g, m, v, p) in enumerate(zip(grads, state.exp_avg, state.exp_avg_sq, master)):
        h = hyper[ids[i]]
        lr, b1, b2 = f32(h["lr"]), f32(h["beta1"]), f32(h["beta2"])
        eps, wd = f32(h["eps"]), f32(h["weight_decay"])
        g = g.float()
        m.mul_(b1).add_(g, alpha=f32(1.0 - b1))
        v.mul_(b2).addcmul_(g, g, value=f32(1.0 - b2))
        update = m / (torch.sqrt(v) + eps) + wd * p
        w_norm = torch.sqrt(sumsq(i, p))
        u_norm = torch.sqrt(sumsq(i, update))
        one = torch.ones((), dtype=torch.float32, device=p.device)
        trust = torch.where(u_norm > 0, torch.where(w_norm > 0, w_norm / u_norm, one), one)
        trust = torch.clamp(trust, min_coeff, max_coeff)
        p.sub_(lr * trust * update)
    return master, state
