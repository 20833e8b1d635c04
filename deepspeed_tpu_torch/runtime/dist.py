"""Process-group bootstrap (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/dist.py``. The JAX package joins a
``jax.distributed`` world; the port joins a ``torch.distributed`` process
group: NCCL when the ranks run on cards, gloo on the CPU. With a world of 1
(or no world configured) nothing happens.

Identity is found in this order (JAX lines 31-58):

1. the arguments;
2. torch.distributed's env contract, which ``launcher/launch.py`` sets:
   ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` (the
   ``env://`` rendezvous);
3. an ``mpirun`` launch without the per-node launcher: OpenMPI's
   ``OMPI_COMM_WORLD_SIZE/RANK``, MVAPICH's ``MV2_COMM_WORLD_SIZE/RANK`` or
   ``PMI_SIZE/RANK``, with the rendezvous at ``MASTER_ADDR`` (``mpirun -x
   MASTER_ADDR``), or negotiated from rank 0 over ``mpi4py``; with neither,
   a world of more than one rank raises, naming ``MASTER_ADDR``.

A rank's card is device ``LOCAL_RANK`` of the ``CUDA_VISIBLE_DEVICES`` its
launcher gave it (``OMPI_COMM_WORLD_LOCAL_RANK`` / ``MV2_COMM_WORLD_LOCAL_RANK``
under mpirun).
"""

import os
import shutil
import socket
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import logger

_MPI_IDENTITY = (("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
                 ("MV2_COMM_WORLD_SIZE", "MV2_COMM_WORLD_RANK", "MV2_COMM_WORLD_LOCAL_RANK"),
                 ("PMI_SIZE", "PMI_RANK", "MPI_LOCALRANKID"))


def _master():
    from ..launcher.constants import TORCH_DISTRIBUTED_DEFAULT_PORT
    addr = os.environ.get("MASTER_ADDR")
    if not addr:
        return None
    return f"{addr}:{os.environ.get('MASTER_PORT', TORCH_DISTRIBUTED_DEFAULT_PORT)}"


def _env_identity():
    """``(rendezvous "host:port", world size, rank)`` from the environment,
    or None when nothing names a world."""
    coord = _master()
    nprocs, pid = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    if nprocs is not None and pid is not None:
        if coord is None and int(nprocs) > 1:
            raise RuntimeError(f"WORLD_SIZE={nprocs} names a world but MASTER_ADDR is "
                               "unset: export MASTER_ADDR (and MASTER_PORT) of rank 0")
        return coord or "", int(nprocs), int(pid)
    for size_key, rank_key, _ in _MPI_IDENTITY:
        if os.environ.get(size_key) is not None:
            nprocs, pid = int(os.environ[size_key]), int(os.environ[rank_key])
            if nprocs <= 1:
                # single-rank mpirun: no world to join, no rendezvous needed
                return coord or "", nprocs, pid
            # every rank takes part in the negotiation: OpenMPI does not
            # forward user env by default, so a collective only some ranks
            # entered would hang the rest
            return _mpi_negotiate_master(coord), nprocs, pid
    return None


def _local_rank(rank: int) -> int:
    if os.environ.get("LOCAL_RANK") is not None:
        return int(os.environ["LOCAL_RANK"])
    for _, _, local_key in _MPI_IDENTITY:
        if os.environ.get(local_key) is not None:
            return int(os.environ[local_key])
    return rank


def _host_address() -> str:
    """First address of ``hostname -I`` (the runner's inference), else the
    host name."""
    if shutil.which("hostname"):
        try:
            out = subprocess.run(["hostname", "-I"], capture_output=True, text=True,
                                 timeout=5).stdout.split()
        except (OSError, subprocess.SubprocessError):
            out = []
        if out:
            return out[0]
    return socket.gethostname()


def _mpi_negotiate_master(local_coord):
    """Rank 0's rendezvous address broadcast over MPI (the reference's
    ``_mpi_check``, engine.py:198-235). Every rank must call it. Needs
    ``mpi4py``; without it ``MASTER_ADDR`` must be exported to every rank."""
    from ..launcher.constants import TORCH_DISTRIBUTED_DEFAULT_PORT
    try:
        from mpi4py import MPI
    except ImportError as e:
        if local_coord:
            return local_coord
        raise RuntimeError(
            "MPI launch detected but MASTER_ADDR is unset and mpi4py is unavailable "
            "to negotiate one; export MASTER_ADDR=<rank-0 host> (and MASTER_PORT) on "
            "every rank (mpirun -x MASTER_ADDR) or launch through the "
            "deepspeed_tpu_torch runner") from e
    comm = MPI.COMM_WORLD
    coord = None
    if comm.Get_rank() == 0:
        coord = local_coord or f"{_host_address()}:{TORCH_DISTRIBUTED_DEFAULT_PORT}"
    coord = comm.bcast(coord, root=0)
    logger.info(f"rendezvous address negotiated over MPI: {coord}")
    return coord


def init_distributed(device=None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     local_rank: Optional[int] = None) -> bool:
    """Join the process group if the environment (or the arguments) name a
    world of more than one rank. Returns True when a group is (or already
    was) up, False for a single process. ``device``: the device type the
    ranks run on ("cuda" -> NCCL, else gloo). ``backend`` overrides that
    choice, and ``local_rank`` the card a rank takes (default ``LOCAL_RANK``,
    else the rank): the caller's explicit choice, as for ranks that share
    one card over gloo; nothing here falls back from one backend to another."""
    if dist.is_initialized():
        return True
    init_method = "env://"
    if world_size is None:
        ident = _env_identity()
        if ident is None:
            return False
        coord, world_size, env_rank = ident
        rank = rank if rank is not None else env_rank
        if world_size > 1 and os.environ.get("RANK") is None:
            init_method = f"tcp://{coord}"      # an mpirun rank
    if world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ["RANK"])
    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        torch.cuda.set_device(_local_rank(rank) if local_rank is None else int(local_rank))
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"),
                            init_method=init_method, world_size=world_size, rank=rank)
    logger.info(f"torch.distributed initialized: rank {rank}/{world_size} "
                f"({dist.get_backend()})")
    return True


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
