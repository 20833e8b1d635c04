"""Multi-node launch backends (pdsh / OpenMPI / MVAPICH; the port's
``deepspeed_tpu/launcher/multinode_runner.py``, reference
``deepspeed/launcher/multinode_runner.py:35-189``): each backend turns the
active resource map into one fan-out command that runs
``deepspeed_tpu_torch.launcher.launch`` on every host (pdsh) or the user
script once per slot (mpirun, whose ranks take their identity from
``OMPI_COMM_WORLD_*`` / ``MV2_COMM_WORLD_*`` / ``PMI_*`` in
``runtime/dist.py``, and the rendezvous from the exported ``MASTER_ADDR`` /
``MASTER_PORT``).
"""

import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import warnings
from abc import ABC, abstractmethod

from .constants import MVAPICH_TMP_HOSTFILE, PDSH_MAX_FAN_OUT


class MultiNodeRunner(ABC):
    def __init__(self, args, world_info_base64):
        self.args = args
        self.user_arguments = self.parse_user_args()
        self.user_script = args.user_script
        self.world_info_base64 = world_info_base64
        self.exports = {}

    @abstractmethod
    def backend_exists(self):
        ...

    @abstractmethod
    def get_cmd(self, environment, active_resources):
        ...

    def add_export(self, key, var):
        self.exports[key.strip()] = var.strip()

    def parse_user_args(self):
        return self.args.user_args


class PDSHRunner(MultiNodeRunner):
    """Parallel-ssh fan-out; %n expands to the pdsh node index = node_rank."""

    def backend_exists(self):
        return shutil.which("pdsh")

    def parse_user_args(self):
        return [x if x.startswith("-") else f"'{x}'" for x in self.args.user_args]

    def get_cmd(self, environment, active_resources):
        environment["PDSH_RCMD_TYPE"] = "ssh"
        active_workers = ",".join(active_resources.keys())

        pdsh_cmd_args = ["pdsh", "-f", str(PDSH_MAX_FAN_OUT), "-w", active_workers]
        if self.args.launcher_args:
            pdsh_cmd_args += self.args.launcher_args.split()

        # quote values: NCCL and torch settings may contain spaces
        exports = "".join(f"export {key}={shlex.quote(val)}; " for key, val in self.exports.items())
        launch_cmd = [
            exports,
            f"cd {os.path.abspath('.')};",
            sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
            f"--world_info={self.world_info_base64}",
            "--node_rank=%n",
            f"--master_addr={self.args.master_addr}",
            f"--master_port={self.args.master_port}",
        ]
        return pdsh_cmd_args + launch_cmd + [self.user_script] + self.user_arguments


class OpenMPIRunner(MultiNodeRunner):
    """mpirun fan-out: one MPI rank per slot; ranks discover their identity via the
    OMPI_COMM_WORLD_* env that runtime.dist.init_distributed understands."""

    def __init__(self, args, world_info_base64, resource_pool):
        super().__init__(args, world_info_base64)
        self.resource_pool = resource_pool
        self.add_export("UCX_TLS", "tcp")

    def backend_exists(self):
        return shutil.which("ompi_info")

    def get_cmd(self, environment, active_resources):
        assert self.args.include == "" and self.args.exclude == "", \
            "openmpi backend does not support worker include/exclusion"
        assert self.args.num_nodes == -1 and self.args.num_gpus == -1, \
            "openmpi backend does not support limiting num nodes/gpus"
        total_process_count = sum(self.resource_pool.values())

        mpirun_cmd = ["mpirun", "-n", f"{total_process_count}",
                      "-hostfile", f"{self.args.hostfile}",
                      "--mca", "btl", "^openib",
                      "--mca", "btl_tcp_if_include", "eth0"]
        if self.args.launcher_args:
            mpirun_cmd += self.args.launcher_args.split()

        export_cmd = []
        for k, v in self.exports.items():
            export_cmd += ["-x", f"{k}={v}"]
        export_cmd += ["-x", f"MASTER_ADDR={self.args.master_addr}",
                       "-x", f"MASTER_PORT={self.args.master_port}"]

        return mpirun_cmd + export_cmd + [sys.executable, "-u", self.user_script] + self.user_arguments


class MVAPICHRunner(MultiNodeRunner):
    def __init__(self, args, world_info_base64, resource_pool):
        super().__init__(args, world_info_base64)
        self.resource_pool = resource_pool
        self.add_export("MV2_SMP_USE_CMA", "0")
        self.add_export("MV2_DEBUG_SHOW_BACKTRACE", "1")
        self.add_export("MV2_ENABLE_AFFINITY", "0")
        self.add_export("MV2_SUPPORT_DL", "1")

    def backend_exists(self):
        mpiname = shutil.which("mpiname")
        if not mpiname:
            warnings.warn("mpiname does not exist, mvapich is not installed properly")
            return False
        results = subprocess.check_output("mpiname", shell=True).decode("utf-8").strip()
        if "MVAPICH2" in results:
            return True
        warnings.warn(f"Expected MVAPICH2 from mpiname but received {results}")
        return False

    def get_cmd(self, environment, active_resources):
        assert self.args.include == "" and self.args.exclude == "", \
            "mvapich backend does not support worker include/exclusion"
        assert self.args.num_nodes == -1 and self.args.num_gpus == -1, \
            "mvapich backend does not support limiting num nodes/gpus"
        devices_per_node = self.resource_pool.values()
        total_process_count = sum(devices_per_node)
        process_per_node = list(devices_per_node)[0]
        assert all(n == process_per_node for n in devices_per_node), \
            "mvapich requires same number of devices per node"

        hostfile = os.path.join(tempfile.gettempdir(), MVAPICH_TMP_HOSTFILE)
        with open(hostfile, "w") as fd:
            for host in self.resource_pool.keys():
                fd.write(f"{host}\n")

        mpirun_cmd = ["mpirun", "-np", f"{total_process_count}",
                      "-ppn", f"{process_per_node}",
                      "--hostfile", hostfile]
        if self.args.launcher_args:
            mpirun_cmd += self.args.launcher_args.split()

        export_cmd = []
        for k, v in self.exports.items():
            export_cmd += ["-env", f"{k}={v}"]
        export_cmd += ["-env", f"MASTER_ADDR={self.args.master_addr}",
                       "-env", f"MASTER_PORT={self.args.master_port}"]
        # MVAPICH exposes rank/size as MV2_COMM_WORLD_* / PMI_* in the children;
        # runtime.dist._env_identity reads those to complete the identity.

        return mpirun_cmd + export_cmd + [sys.executable, "-u", self.user_script] + self.user_arguments
