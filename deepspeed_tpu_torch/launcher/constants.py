"""Launcher constants (the port's ``deepspeed_tpu/launcher/constants.py``).

The runner's ``--master_addr/--master_port`` become torch.distributed's
``MASTER_ADDR`` / ``MASTER_PORT`` rendezvous (``runtime/dist.py``).
"""

# rank-0 port of the torch.distributed rendezvous
TORCH_DISTRIBUTED_DEFAULT_PORT = 29500

PDSH_LAUNCHER = "pdsh"
PDSH_MAX_FAN_OUT = 1024

OPENMPI_LAUNCHER = "openmpi"

MVAPICH_LAUNCHER = "mvapich"
# the MVAPICH backend's hostfile, written under tempfile.gettempdir()
MVAPICH_TMP_HOSTFILE = "deepspeed_tpu_torch_mvapich_hostfile"

# hostfile default location (reference launcher/runner.py:26)
DLTS_HOSTFILE = "/job/hostfile"

# env prefixes forwarded to remote nodes: the reference's NCCL/PYTHON/MV2/UCX
# family, and torch's own (TORCH_NCCL_*, TORCH_DISTRIBUTED_*)
EXPORT_ENVS = ["NCCL", "PYTHON", "MV2", "UCX", "TORCH"]

DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
