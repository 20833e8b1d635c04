"""Front-end launcher for multi-node training jobs (the port's
``deepspeed_tpu/launcher/runner.py``; reference
``deepspeed/launcher/runner.py:251-357``).

Parses an MPI-style hostfile (``worker-0 slots=4``, slots = GPUs, one
process each), applies ``--include/--exclude`` node/slot filters
(reference runner.py:143-242), encodes the active resource map as urlsafe
base64 (runner.py:245-248), and either execs the per-node launcher
(``launcher/launch.py``) locally or fans out over pdsh/mpirun. The
rendezvous is torch.distributed's ``MASTER_ADDR`` / ``MASTER_PORT``. With no
hostfile the local host's GPUs are the pool, counted without creating a CUDA
context in this process (``_local_device_count``).
"""

import argparse
import base64
import collections
import json
import os
import shutil
import subprocess
import sys
from copy import deepcopy

from ..utils import logger
from .constants import (DEEPSPEED_ENVIRONMENT_NAME, DLTS_HOSTFILE, EXPORT_ENVS,
                        MVAPICH_LAUNCHER, OPENMPI_LAUNCHER, PDSH_LAUNCHER,
                        TORCH_DISTRIBUTED_DEFAULT_PORT)
from .multinode_runner import MVAPICHRunner, OpenMPIRunner, PDSHRunner

DEEPSPEED_ENVIRONMENT_PATHS = [os.path.expanduser("~"), "."]


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch runner: launch distributed multi-node GPU "
                    "training jobs.")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="MPI-style hostfile defining the resource pool "
                             "(e.g. 'worker-0 slots=4', slots = GPUs, one process each)")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Resources to use: NODE_SPEC[@NODE_SPEC ...] where "
                             "NODE_SPEC=NAME[:SLOT[,SLOT ...]]. Omitting :SLOT takes the whole host.")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Resources to skip; same syntax as --include, mutually exclusive with it.")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="Use only the first N hosts of the (filtered) pool.")
    parser.add_argument("--num_gpus", "--num_chips", dest="num_gpus", type=int, default=-1,
                        help="Max GPUs/slots per host; uses slot ids [0:N).")
    parser.add_argument("--master_port", default=TORCH_DISTRIBUTED_DEFAULT_PORT, type=int,
                        help="Port of the torch.distributed rendezvous on node 0.")
    parser.add_argument("--master_addr", default="", type=str,
                        help="Address of node 0; inferred via ssh `hostname -I` if empty.")
    parser.add_argument("--launcher", default=PDSH_LAUNCHER, type=str,
                        help="Multi-node backend: pdsh, openmpi, or mvapich.")
    parser.add_argument("--launcher_args", default="", type=str,
                        help="Backend-specific arguments, as one quoted string.")
    parser.add_argument("--force_multi", action="store_true",
                        help="Treat the job as multi-node even with a single host entry.")
    parser.add_argument("user_script", type=str,
                        help="User training script, followed by its arguments.")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path):
    """Parse 'host slots=N' lines into an ordered {host: slot_count} map
    (reference runner.py:115-140). Returns None when the file is absent."""
    if not os.path.isfile(hostfile_path):
        logger.warning("no hostfile found; falling back to the local host's devices")
        return None
    resource_pool = collections.OrderedDict()
    with open(hostfile_path, "r") as fd:
        for line in fd.readlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                _, slot_count = slots.split("=")
                slot_count = int(slot_count)
            except ValueError as err:
                logger.error("bad hostfile line (expected '<host> slots=<n>'); aborting launch")
                raise err
            if hostname in resource_pool:
                logger.error("hostfile lists the same host twice; aborting launch")
                raise ValueError(f"host {hostname} is already defined")
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info, include_str="", exclude_str=""):
    """Filter {host: [slot ids]} by an include or exclude spec (reference runner.py:143-242).

    Spec syntax: NODE_SPEC[@NODE_SPEC ...], NODE_SPEC = NAME[:SLOT[,SLOT ...]].
    Include builds the pool from scratch; exclude removes from a copy. Order of the
    original host_info is preserved so ranks map deterministically.
    """
    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually exclusive.")
    if not include_str and not exclude_str:
        return host_info

    filtered_hosts = dict()
    if include_str:
        parse_str = include_str
    else:
        filtered_hosts = deepcopy(host_info)
        parse_str = exclude_str

    for node_config in parse_str.split("@"):
        if ":" in node_config:
            hostname, slots = node_config.split(":")
            slots = [int(x) for x in slots.split(",")]
            if hostname not in host_info:
                raise ValueError(f"include/exclude filter references {hostname!r}, which the hostfile does not define")
            for s in slots:
                if s not in host_info[hostname]:
                    raise ValueError(f"No slot '{s}' specified on host '{hostname}'")
            if include_str:
                filtered_hosts[hostname] = slots
            else:
                for s in slots:
                    logger.info(f"removing {s} from {hostname}")
                    filtered_hosts[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(f"include/exclude filter references {hostname!r}, which the hostfile does not define")
            if include_str:
                filtered_hosts[hostname] = host_info[hostname]
            else:
                filtered_hosts[hostname] = []

    # Drop duplicates and emptied hosts, then restore hostfile ordering.
    del_keys = []
    for hostname in filtered_hosts:
        filtered_hosts[hostname] = sorted(set(filtered_hosts[hostname]))
        if len(filtered_hosts[hostname]) == 0:
            del_keys.append(hostname)
    for name in del_keys:
        del filtered_hosts[name]

    ordered_hosts = collections.OrderedDict()
    for host in host_info:
        if host in filtered_hosts:
            ordered_hosts[host] = filtered_hosts[host]
    return ordered_hosts


def parse_inclusion_exclusion(resource_pool, inclusion, exclusion):
    """{host: slot_count} → filtered {host: [slot ids]} (reference runner.py:235-242)."""
    active_resources = collections.OrderedDict()
    for hostname, slots in resource_pool.items():
        active_resources[hostname] = list(range(slots))
    return parse_resource_filter(active_resources, include_str=inclusion, exclude_str=exclusion)


def encode_world_info(world_info) -> str:
    """urlsafe-base64 JSON of the {host: [slots]} map (reference runner.py:245-248)."""
    world_info_json = json.dumps(world_info).encode("utf-8")
    return base64.urlsafe_b64encode(world_info_json).decode("utf-8")


def decode_world_info(world_info_base64: str):
    return json.loads(base64.urlsafe_b64decode(world_info_base64))


def _nvml_device_count():
    """GPUs NVML sees, or None without NVML. NVML reads the driver; it
    creates no CUDA context."""
    import ctypes
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        count = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return None
        return int(count.value)
    finally:
        nvml.nvmlShutdown()


def _local_device_count() -> int:
    """Local GPU count for the hostfile-less path, without creating a CUDA
    context here (the front end would then hold memory on a card its
    children need): ``CUDA_VISIBLE_DEVICES`` where it is set, else NVML,
    else ``nvidia-smi -L``, else 1 process."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([c for c in visible.split(",") if c.strip()])
    n = _nvml_device_count()
    if n is not None:
        return n
    if shutil.which("nvidia-smi"):
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                                 timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        n = sum(1 for line in out.splitlines() if line.startswith("GPU "))
        if n:
            return n
    return 1


def main(args=None):
    args = parse_args(args)

    if (args.num_nodes >= 0 or args.num_gpus >= 0) and (args.include or args.exclude):
        raise ValueError("Cannot specify num_nodes/num_gpus with include/exclude")

    multi_node_exec = True
    resource_pool = fetch_hostfile(args.hostfile)
    from_hostfile = bool(resource_pool)  # a comments-only hostfile declares nothing
    if not resource_pool:
        resource_pool = {"localhost": _local_device_count()}
        args.master_addr = "127.0.0.1"
        multi_node_exec = False

    if not multi_node_exec and args.num_nodes > 1:
        raise ValueError("--num_nodes > 1 requires a hostfile listing the extra nodes")

    active_resources = parse_inclusion_exclusion(resource_pool, args.include, args.exclude)
    env = os.environ.copy()

    if not args.master_addr:
        first_host = list(active_resources.keys())[0]
        result = subprocess.check_output([f"ssh {first_host} hostname -I"], shell=True)
        args.master_addr = result.decode("utf-8").split()[0]
        logger.info(f"resolved {first_host} -> {args.master_addr} as the rendezvous address")

    if args.num_nodes > 0:
        active_resources = collections.OrderedDict(
            (h, s) for i, (h, s) in enumerate(active_resources.items()) if i < args.num_nodes)
    if args.num_gpus > 0:
        if from_hostfile:
            # cap to slots the hostfile actually declares — fabricating ids would
            # fail GPU visibility at runtime instead of erroring here
            for h, slots in active_resources.items():
                if args.num_gpus > len(slots):
                    raise ValueError(f"--num_gpus {args.num_gpus} exceeds the {len(slots)} "
                                     f"slots declared for host '{h}'")
            active_resources = collections.OrderedDict(
                (h, slots[:args.num_gpus]) for h, slots in active_resources.items())
        else:
            # localhost slot count is a heuristic, not a declaration — honor the
            # explicit request (reference runner.py:295-299 behavior)
            active_resources = collections.OrderedDict(
                (h, list(range(args.num_gpus))) for h in active_resources)

    world_info_base64 = encode_world_info(active_resources)
    multi_node_exec = args.force_multi or len(active_resources) > 1

    if not multi_node_exec:
        cmd = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
               f"--world_info={world_info_base64}",
               f"--master_addr={args.master_addr}",
               f"--master_port={args.master_port}",
               args.user_script] + args.user_args
    else:
        launcher = args.launcher.lower()
        if launcher == PDSH_LAUNCHER:
            runner = PDSHRunner(args, world_info_base64)
        elif launcher == OPENMPI_LAUNCHER:
            runner = OpenMPIRunner(args, world_info_base64, resource_pool)
        elif launcher == MVAPICH_LAUNCHER:
            runner = MVAPICHRunner(args, world_info_base64, resource_pool)
        else:
            raise NotImplementedError(f"Unknown launcher {args.launcher}")
        if not runner.backend_exists():
            raise RuntimeError(f"launcher '{args.launcher}' not installed.")

        curr_path = os.path.abspath(".")
        env["PYTHONPATH"] = curr_path + ":" + env["PYTHONPATH"] if "PYTHONPATH" in env else curr_path

        for var in env:
            if any(var.startswith(name) for name in EXPORT_ENVS):
                runner.add_export(var, env[var])

        # Propagate user-pinned env via ~/.deepspeed_env or ./.deepspeed_env
        # (reference runner.py:345-351).
        for environ_path in DEEPSPEED_ENVIRONMENT_PATHS:
            environ_file = os.path.join(environ_path, DEEPSPEED_ENVIRONMENT_NAME)
            if os.path.isfile(environ_file):
                with open(environ_file, "r") as fd:
                    for var in fd.readlines():
                        var = var.strip()
                        if not var or var.startswith("#") or "=" not in var:
                            continue
                        key, val = var.split("=", 1)
                        runner.add_export(key, val)

        cmd = runner.get_cmd(env, active_resources)

    logger.info("cmd = {}".format(" ".join(cmd)))
    result = subprocess.Popen(cmd, env=env)
    result.wait()
    sys.exit(result.returncode)


if __name__ == "__main__":
    main()
