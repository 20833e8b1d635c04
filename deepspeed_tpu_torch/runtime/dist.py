"""Process-group bootstrap (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/dist.py``. The JAX package joins a
``jax.distributed`` world; the port joins a ``torch.distributed`` process
group through the env rendezvous (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL when the ranks run on cards, gloo on the CPU. With a
world of 1 (or no world configured) nothing happens. ``LOCAL_RANK`` picks a
rank's card.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import logger


def init_distributed(device=None, world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group if the environment (or the arguments) name a
    world of more than one rank. Returns True when a group is (or already
    was) up, False for a single process. ``device``: the device type the
    ranks run on ("cuda" -> NCCL, else gloo)."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ["RANK"])
    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if on_card else "gloo", init_method="env://",
                            world_size=world_size, rank=rank)
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} "
                f"({dist.get_backend()})")
    return True


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
