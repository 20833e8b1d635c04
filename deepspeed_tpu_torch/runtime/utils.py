"""Shared numeric and partitioning helpers (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/utils.py``: global norms, clipping
and the overflow check over the port's parameter and gradient containers (a
tensor, or a list / tuple / dict of them, nested), ``param_count``, and
copies of the partition math (host-only, no tensors). The norms are float32
sums of squares, as in the JAX package; ``get_grad_norm`` adds the squares
of the other ranks of a ``torch.distributed`` group when one is given.
"""

from bisect import bisect_left
from typing import List, Sequence

import torch
import torch.distributed as dist


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tensor / list / tuple / dict tree, in order (dicts in
    insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    for t in tree:
        out.extend(leaves(t))
    return out


def param_count(params) -> int:
    """Total element count of a parameter tree."""
    return sum(int(t.numel()) for t in leaves(params))


def _sumsq(tree) -> torch.Tensor:
    ts = leaves(tree)
    if not ts:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([torch.sum(torch.square(t.float())) for t in ts]).sum()


def global_norm(tree) -> torch.Tensor:
    """L2 norm over a whole tree, computed in float32 (0-dim tensor)."""
    return torch.sqrt(_sumsq(tree))


def get_grad_norm(grads, group=None) -> torch.Tensor:
    """Gradient L2 norm; with ``group`` (a process group, or ``dist.group.WORLD``)
    the squared local norm is summed over its ranks first (the JAX package's
    psum over the model axis)."""
    sq = _sumsq(grads)
    if group is not None:
        dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=group)
    return torch.sqrt(sq)


def get_weight_norm(params, group=None) -> torch.Tensor:
    return get_grad_norm(params, group)


def clip_grads_by_global_norm(grads, max_norm: float, norm=None):
    """Scale grads so that the global norm is at most ``max_norm``, each
    leaf through float32 and back to its dtype. In place (the JAX function
    returns a new tree; the port saves the copy); returns ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in leaves(grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return grads


def has_inf_or_nan_tree(tree) -> torch.Tensor:
    """True (0-dim bool tensor) if any leaf holds an inf or a nan."""
    ts = leaves(tree)
    if not ts:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([~torch.isfinite(t).all() for t in ts]).any()


def detect_overflow(tree, fp16_active: bool, index=None):
    """``(overflow, None)``: the global inf/nan flag when fp16 is active, a
    constant False otherwise. The per-subtree ``index`` of the numerics
    observatory is not ported (ROADMAP.md item 22b)."""
    if index is not None:
        raise NotImplementedError(
            "detect_overflow(index=...): the numerics sentinel (per-subtree "
            "overflow attribution) is not in the PyTorch port yet: ROADMAP.md item 22b")
    if fp16_active:
        return has_inf_or_nan_tree(tree), None
    return torch.zeros((), dtype=torch.bool), None


# ---------------------------------------------------------------------------
# Partitioning math (pipeline layer balancing, ZeRO sub-partitions)
# ---------------------------------------------------------------------------

def prefix_sum_inc(weights: Sequence[float]) -> List[float]:
    """Inclusive prefix sum: [3,4,5] -> [3,7,12]."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries of a uniform split of ``num_items`` into ``num_parts`` (len = parts+1)."""
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    for p in range(num_parts):
        parts[p] = min(chunksize * p, num_items)
    parts[num_parts] = num_items
    return parts


def _linear_probe(csum: List[float], num_parts: int, bottleneck: float):
    """Greedily place boundaries so no partition's weight exceeds ``bottleneck``.

    ``csum`` is the inclusive prefix sum. Returns (parts, feasible).
    """
    num_items = len(csum)
    total = csum[-1]
    parts = [0] * (num_parts + 1)
    for p in range(1, num_parts + 1):
        parts[p] = num_items

    target = bottleneck
    for p in range(1, num_parts):
        # boundary = first index whose prefix sum reaches the target
        parts[p] = bisect_left(csum, target, lo=parts[p - 1], hi=num_items)
        if parts[p] == num_items:
            # everything placed; feasible iff the last nonempty partition fits
            part_weight = total - (csum[parts[p - 1] - 1] if parts[p - 1] > 0 else 0.0)
            return parts, part_weight < bottleneck
        target = csum[parts[p] - 1] + bottleneck if parts[p] > 0 else bottleneck
    return parts, target >= total


def partition_balanced(weights: Sequence[float], num_parts: int, eps: float = 1e-3) -> List[int]:
    """Split items into parts minimizing the heaviest partition (binary search on the
    bottleneck + linear probe)."""
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)

    csum = prefix_sum_inc(list(map(float, weights)))
    total = csum[-1]
    lower = total / num_parts
    upper = total
    while upper > lower + eps:
        mid = lower + (upper - lower) / 2
        _, feasible = _linear_probe(csum, num_parts, mid)
        if feasible:
            upper = mid
        else:
            lower = mid + eps
    parts, feasible = _linear_probe(csum, num_parts, upper)
    if not feasible:
        raise RuntimeError("partition_balanced: no feasible split found")
    return parts
