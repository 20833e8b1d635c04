"""Adam / AdamW (PyTorch port).

Counterpart of ``deepspeed_tpu/ops/adam.py`` with the same update math and
the same split: ``adamw=False`` is classic L2 Adam (weight decay folded into
the gradient before the moments), ``adamw=True`` decoupled decay. The JAX
package has no Pallas kernel here (XLA fuses the update), so these are torch
``_foreach`` ops.

The functional contract is the JAX one over lists of float32 tensors:
  init(master) -> AdamState
  apply(grads, state, master, step, hyper, adamw=True, groups=None)
where ``hyper`` is a list of per-group dicts {lr, beta1, beta2, eps,
weight_decay} (one dict for one group) and ``groups`` the group index of
each leaf. Unlike the JAX function, ``apply`` updates ``master`` and the
moments in place (the port keeps one copy of each at 1.5B parameters) and
returns them. The scalar hyper-parameters are rounded to float32 first, as
the JAX package holds them.
"""

from typing import NamedTuple

import numpy as np
import torch

# leaves per _foreach call are batched up to this many elements, which bounds
# the float32 temporaries of one call
_BUCKET_ELEMENTS = 1 << 28


class AdamState(NamedTuple):
    exp_avg: list      # float32, like master
    exp_avg_sq: list


def init(master) -> AdamState:
    return AdamState(exp_avg=[torch.zeros_like(p, dtype=torch.float32) for p in master],
                     exp_avg_sq=[torch.zeros_like(p, dtype=torch.float32) for p in master])


def group_hyper(hyper):
    """``hyper`` as a list of per-group dicts (a lone dict is group 0)."""
    return [hyper] if isinstance(hyper, dict) else list(hyper)


def f32(x) -> float:
    """``x`` rounded to float32 (the JAX package's scalar precision)."""
    return float(np.float32(x))


def buckets(groups, n_leaves, sizes):
    """[(group id, [leaf indices])]: the leaves of each group, batched so that
    one batch holds at most ``_BUCKET_ELEMENTS`` elements (or one leaf)."""
    ids = [0] * n_leaves if groups is None else list(groups)
    if len(ids) != n_leaves:
        raise ValueError(f"groups has {len(ids)} entries for {n_leaves} leaves")
    out = []
    for gi in sorted(set(ids)):
        batch, size = [], 0
        for i in (i for i in range(n_leaves) if ids[i] == gi):
            if batch and size + sizes[i] > _BUCKET_ELEMENTS:
                out.append((gi, batch))
                batch, size = [], 0
            batch.append(i)
            size += sizes[i]
        if batch:
            out.append((gi, batch))
    return out


def apply(grads, state: AdamState, master, step, hyper, adamw: bool = True,
          groups=None):
    """One Adam step in place. ``step`` is the 1-based update count."""
    hyper = group_hyper(hyper)
    stepf = np.float32(step)
    for gi, idx in buckets(groups, len(master), [p.numel() for p in master]):
        h = hyper[gi]
        b1, b2 = np.float32(h["beta1"]), np.float32(h["beta2"])
        lr, eps, wd = f32(h["lr"]), f32(h["eps"]), f32(h["weight_decay"])
        bc1 = float(np.float32(1.0) - np.power(b1, stepf))
        bc2 = float(np.float32(1.0) - np.power(b2, stepf))
        p = [master[i] for i in idx]
        m = [state.exp_avg[i] for i in idx]
        v = [state.exp_avg_sq[i] for i in idx]
        g = [grads[i].float() for i in idx]
        if not adamw and wd:
            # classic L2 Adam: the decay term enters the gradient before the
            # moment updates
            g = torch._foreach_add(g, p, alpha=wd)
        torch._foreach_mul_(m, float(b1))
        torch._foreach_add_(m, g, alpha=float(np.float32(1.0) - b1))
        torch._foreach_mul_(v, float(b2))
        torch._foreach_addcmul_(v, g, g, value=float(np.float32(1.0) - b2))
        del g
        upd = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        del den
        if adamw and wd:
            torch._foreach_add_(upd, p, alpha=wd)
        torch._foreach_add_(p, upd, alpha=-lr)
    return master, state


DEFAULT_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)


def hyper_from_params(params: dict) -> dict:
    """Translate a DeepSpeed optimizer-params dict into the hyper dict."""
    betas = params.get("betas", (0.9, 0.999))
    return dict(lr=params.get("lr", 1e-3),
                beta1=betas[0],
                beta2=betas[1],
                eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.0))
