"""Client ``(init, apply)`` optimizer pairs (PyTorch port).

``shard_optimizer`` is ``bench.py:354-388`` ``_shard_optimizer`` in torch: the
pair the main path's published configuration (``bench.py:391-420``) trains
with. The contract is the engine's (``runtime/engine.py``): ``init(master)``
gives the state, ``apply(grads, state, master, step, hyper)`` gives
``(master, state)``; trees are ``params_tree()``'s dicts with sorted keys,
so their leaves come in ``jax.tree_util`` order.
"""

import torch
from torch.utils import _pytree as pytree


def shard_optimizer(dp):
    """One ZeRO-2 rank's optimizer work out of ``dp``: Adam over a 1/dp
    float32 shard of the gradient stream (each leaf's first 1/dp, rounded to
    bf16, in ``jax.tree_util`` leaf order), marked ``external_master``: the
    shard lives in the state, the engine keeps no float32 master and
    re-casts nothing, so the params never change."""

    def shard_of(tree):
        leaves = pytree.tree_leaves(tree)
        n = sum(leaf.numel() for leaf in leaves) // dp
        flat = torch.cat([leaf.reshape(-1)[:max(leaf.numel() // dp, 1)].to(torch.bfloat16)
                          for leaf in leaves])
        if flat.shape[0] < n:
            flat = torch.nn.functional.pad(flat, (0, n - flat.shape[0]))
        return flat[:n].float(), n

    def init(master):
        leaves = pytree.tree_leaves(master)
        n = sum(leaf.numel() for leaf in leaves) // dp
        return {k: torch.zeros(n, device=leaves[0].device) for k in ("shard", "m1", "m2")}

    def apply(grads, state, master, step, hyper):
        gs, _ = shard_of(grads)
        m1 = hyper["beta1"] * state["m1"] + (1.0 - hyper["beta1"]) * gs
        m2 = hyper["beta2"] * state["m2"] + (1.0 - hyper["beta2"]) * gs * gs
        shard = state["shard"] - hyper["lr"] * m1 / (torch.sqrt(m2) + hyper["eps"])
        return master, {"shard": shard, "m1": m1, "m2": m2}

    apply.external_master = True
    return init, apply
