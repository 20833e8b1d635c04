"""Per-node process spawner (the port's ``deepspeed_tpu/launcher/launch.py``).

One process per local slot, each with torch.distributed's env contract:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, which ``runtime/dist.py``
``init_distributed`` reads.

GPU visibility: every process of a host sees the host's slot list, in slot
order, as ``CUDA_VISIBLE_DEVICES`` (slot ids index the parent's own
``CUDA_VISIBLE_DEVICES`` where it is set), and rank ``LOCAL_RANK`` takes
device ``LOCAL_RANK`` of that list (``torch.cuda.set_device``). So an
``--include host:1,3`` run gives local rank 0 the card with id 1 and local
rank 1 the card with id 3. The JAX launcher pins one chip per process
instead (``TPU_VISIBLE_DEVICES``); that contract and device ``LOCAL_RANK``
cannot both hold, and this one keeps every rank's peers visible. No
``TPU_*`` and no ``DS_COORDINATOR_*`` variable is set.
"""

import base64
import json
import os
import subprocess
import sys
from argparse import REMAINDER, ArgumentParser
from collections import defaultdict

from ..utils import logger
from .constants import TORCH_DISTRIBUTED_DEFAULT_PORT


def parse_args(args=None):
    parser = ArgumentParser(description="deepspeed_tpu_torch per-node launcher: spawns one "
                                        "process per local slot.")
    parser.add_argument("--node_rank", type=int, default=0,
                        help="Rank of this node in the world-info host list.")
    parser.add_argument("--master_addr", default="127.0.0.1", type=str,
                        help="Address of node 0 (torch.distributed rendezvous).")
    parser.add_argument("--master_port", default=TORCH_DISTRIBUTED_DEFAULT_PORT, type=int,
                        help="Rendezvous port.")
    parser.add_argument("--world_info", default="None", type=str,
                        help="base64-encoded {host: [slot ids]} dictionary.")
    parser.add_argument("training_script", type=str,
                        help="User training script (launched once per local slot).")
    parser.add_argument("training_script_args", nargs=REMAINDER)
    return parser.parse_args(args=args)


def build_rank_mapping(world_info: dict):
    """Global rank assignment: hosts in world-info order, slots in order within
    a host (reference launch.py:90-101). Returns ({host: [global ranks]},
    world_size)."""
    global_rank_mapping = defaultdict(list)
    rank = 0
    for node_id, gids in world_info.items():
        for _ in gids:
            global_rank_mapping[node_id].append(rank)
            rank += 1
    return dict(global_rank_mapping), rank


def visible_devices(base_env: dict, slot_ids) -> str:
    """The host's slot list as ``CUDA_VISIBLE_DEVICES``: slot ids index the
    parent's ``CUDA_VISIBLE_DEVICES`` where it is set, else name card ids."""
    parent = base_env.get("CUDA_VISIBLE_DEVICES")
    if parent:
        cards = [c.strip() for c in parent.split(",") if c.strip()]
        for s in slot_ids:
            if not 0 <= int(s) < len(cards):
                raise ValueError(f"slot {s} is outside CUDA_VISIBLE_DEVICES={parent!r}")
        return ",".join(cards[int(s)] for s in slot_ids)
    return ",".join(str(int(s)) for s in slot_ids)


def child_env(base_env: dict, world_info: dict, node_rank: int, local_rank: int,
              master_addr: str, master_port: int) -> dict:
    """Environment for one spawned process. Pure function for testability."""
    node_list = list(world_info.keys())
    local_node = node_list[node_rank]
    local_slot_ids = world_info[local_node]
    mapping, world_size = build_rank_mapping(world_info)
    dist_rank = mapping[local_node][local_rank]

    env = dict(base_env)
    env["MASTER_ADDR"] = master_addr
    env["MASTER_PORT"] = str(master_port)
    env["WORLD_SIZE"] = str(world_size)
    env["RANK"] = str(dist_rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["LOCAL_WORLD_SIZE"] = str(len(local_slot_ids))
    env["CUDA_VISIBLE_DEVICES"] = visible_devices(base_env, local_slot_ids)
    return env


def main(args=None):
    args = parse_args(args)
    current_env = os.environ.copy()

    if args.world_info == "None":
        raise ValueError("must provide world info dict (--world_info)")
    world_info = json.loads(base64.urlsafe_b64decode(args.world_info))
    logger.info(f"WORLD INFO DICT: {world_info}")

    node_list = list(world_info.keys())
    local_node = node_list[args.node_rank]
    num_local_procs = len(world_info[local_node])
    _, world_size = build_rank_mapping(world_info)
    logger.info(f"nnodes={len(node_list)}, num_local_procs={num_local_procs}, "
                f"node_rank={args.node_rank}, world_size={world_size}")

    processes = []
    for local_rank in range(num_local_procs):
        env = child_env(current_env, world_info, args.node_rank, local_rank,
                        args.master_addr, args.master_port)
        cmd = [sys.executable, "-u", args.training_script,
               f"--local_rank={local_rank}"] + args.training_script_args
        processes.append(subprocess.Popen(cmd, env=env))

    exit_code = 0
    for process in processes:
        process.wait()
        exit_code = exit_code or process.returncode
    sys.exit(exit_code)


if __name__ == "__main__":
    main()
