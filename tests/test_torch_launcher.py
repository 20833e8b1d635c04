"""The port's launcher (``deepspeed_tpu_torch/launcher/``), its process-group
identity (``runtime/dist.py``) and its command-line front end (``cli.py``),
against the JAX package's on the same inputs, on the CPU.

- The pure functions — hostfile parsing, include/exclude filters, world
  info, rank mapping, the runner's single-node, pdsh and mpirun commands —
  give JAX's results. The env contract differs by design: the port exports
  torch.distributed's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` (the same values as JAX's), no
  ``DS_COORDINATOR_*`` and no ``TPU_*``, and every process of a host sees
  the host's slot list as ``CUDA_VISIBLE_DEVICES`` and takes device
  ``LOCAL_RANK`` of it, where JAX pins one chip a process; mpirun commands
  export ``MASTER_ADDR`` / ``MASTER_PORT`` where JAX exports
  ``DS_COORDINATOR_ADDRESS``.
- MPI identity (``OMPI_COMM_WORLD_*``, ``MV2_COMM_WORLD_*``, ``PMI_*``)
  parses as JAX's; with no ``MASTER_ADDR`` a world of more than one rank
  raises, naming it.
- One 2-rank gloo run through the port's ``launch.py`` of a worker written
  into ``tmp_path``: its losses equal the JAX engine's at dp = 2 on the same
  numpy batch (float32, 1e-5).
"""

import base64
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import runner as jrun
from deepspeed_tpu_torch.launcher import launch as tlaunch
from deepspeed_tpu_torch.launcher import runner as trun

ROOT = Path(__file__).resolve().parents[1]
IDENTITY_VARS = ("DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES", "DS_PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "OMPI_COMM_WORLD_SIZE",
                 "OMPI_COMM_WORLD_RANK", "MV2_COMM_WORLD_SIZE", "MV2_COMM_WORLD_RANK",
                 "PMI_SIZE", "PMI_RANK")


@pytest.fixture
def no_identity(monkeypatch):
    for k in IDENTITY_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ------------------------------------------------------------ pure functions
@pytest.mark.parametrize("text", [
    "worker-0 slots=4\nworker-1 slots=4\n\n# comment\n",
    "a slots=1\nb slots=8\nc slots=2\n",
])
def test_hostfile_parse_equals_jax(tmp_path, text):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text(text)
    assert list(trun.fetch_hostfile(str(hostfile)).items()) == \
        list(jrun.fetch_hostfile(str(hostfile)).items())
    assert trun.fetch_hostfile(str(tmp_path / "missing")) is None
    for bad in ("worker-0 4\n", "worker-0 slots=4\nworker-0 slots=2\n"):
        hostfile.write_text(bad)
        with pytest.raises(ValueError):
            trun.fetch_hostfile(str(hostfile))
        with pytest.raises(ValueError):
            jrun.fetch_hostfile(str(hostfile))


@pytest.mark.parametrize("include,exclude", [
    ("worker-1", ""), ("worker-0@worker-1:0,2", ""), ("", "worker-0:1,3"),
    ("", "worker-1"), ("", "worker-0:0,1,2,3"), ("worker-1@worker-0", ""), ("", ""),
])
def test_resource_filters_equal_jax(include, exclude):
    pool = {"worker-0": 4, "worker-1": 4}
    assert trun.parse_inclusion_exclusion(pool, include, exclude) == \
        jrun.parse_inclusion_exclusion(pool, include, exclude)


@pytest.mark.parametrize("include,exclude", [("worker-9", ""), ("worker-0:7", ""),
                                             ("worker-0", "worker-1")])
def test_resource_filters_refuse_as_jax(include, exclude):
    pool = {"worker-0": [0, 1], "worker-1": [0, 1]}
    with pytest.raises(ValueError):
        jrun.parse_resource_filter(pool, include_str=include, exclude_str=exclude)
    with pytest.raises(ValueError):
        trun.parse_resource_filter(pool, include_str=include, exclude_str=exclude)


def test_world_info_and_rank_mapping_equal_jax():
    world = {"worker-0": [0, 1], "worker-1": [0, 1], "worker-2": [0]}
    encoded = trun.encode_world_info(world)
    assert encoded == jrun.encode_world_info(world)
    assert trun.decode_world_info(encoded) == world
    assert tlaunch.build_rank_mapping(world) == jlaunch.build_rank_mapping(world) == (
        {"worker-0": [0, 1], "worker-1": [2, 3], "worker-2": [4]}, 5)


@pytest.mark.parametrize("node_rank,local_rank", [(0, 0), (1, 1), (1, 0)])
def test_child_env_contract(node_rank, local_rank):
    world = {"worker-0": [0, 1], "worker-1": [2, 3]}
    kw = dict(node_rank=node_rank, local_rank=local_rank, master_addr="10.0.0.1",
              master_port=29500)
    t = tlaunch.child_env({"HOME": "/h"}, world, **kw)
    j = jlaunch.child_env({"HOME": "/h"}, world, **kw)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "HOME"):
        assert t[k] == j[k], k
    assert not [k for k in t if k.startswith(("DS_", "TPU_", "CLOUD_TPU"))]
    # the host's slot list, and device LOCAL_RANK of it
    assert t["CUDA_VISIBLE_DEVICES"] == ",".join(map(str, world[list(world)[node_rank]]))
    assert t["LOCAL_WORLD_SIZE"] == "2"
    # slot ids index the parent's own CUDA_VISIBLE_DEVICES
    t = tlaunch.child_env({"CUDA_VISIBLE_DEVICES": "4,5,6,7"}, world, **kw)
    assert t["CUDA_VISIBLE_DEVICES"] == ("4,5" if node_rank == 0 else "6,7")
    with pytest.raises(ValueError, match="outside"):
        tlaunch.child_env({"CUDA_VISIBLE_DEVICES": "0"}, world, **kw)


class _FakeProc:
    returncode = 0

    def wait(self):
        return 0


def _run_cmd(module, monkeypatch, args):
    captured = {}
    monkeypatch.setattr(module.subprocess, "Popen",
                        lambda cmd, env=None: captured.update(cmd=cmd) or _FakeProc())
    with pytest.raises(SystemExit):
        module.main(args=args)
    return captured["cmd"]


def test_single_node_command_equals_jax(monkeypatch):
    monkeypatch.setenv("DS_NUM_CHIPS", "4")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    args = ["--hostfile", "/nope", "train.py", "--foo", "1"]
    t, j = _run_cmd(trun, monkeypatch, args), _run_cmd(jrun, monkeypatch, args)
    assert t == [x.replace("deepspeed_tpu.launcher", "deepspeed_tpu_torch.launcher")
                 for x in j]
    world = [c for c in t if c.startswith("--world_info=")][0].split("=", 1)[1]
    assert trun.decode_world_info(world) == {"localhost": [0, 1, 2, 3]}
    # --num_gpus overrides the local count, as in the JAX runner
    t = _run_cmd(trun, monkeypatch, ["--hostfile", "/nope", "--num_gpus", "1", "x.py"])
    world = [c for c in t if c.startswith("--world_info=")][0].split("=", 1)[1]
    assert trun.decode_world_info(world) == {"localhost": [0]}


def test_local_device_count_reads_visible_devices_first(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert trun._local_device_count() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert trun._local_device_count() == 0
    # no variable: NVML or nvidia-smi where present, else one process
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(trun, "_nvml_device_count", lambda: None)
    monkeypatch.setattr(trun.shutil, "which", lambda name: None)
    assert trun._local_device_count() == 1
    monkeypatch.setattr(trun, "_nvml_device_count", lambda: 8)
    assert trun._local_device_count() == 8


def test_multinode_commands_equal_jax(monkeypatch, tmp_path):
    from deepspeed_tpu.launcher import multinode_runner as jmr
    from deepspeed_tpu_torch.launcher import multinode_runner as tmr
    argv = ["--hostfile", "/nope", "--master_addr", "10.0.0.1", "train.py", "--epochs", "2"]
    world = {"worker-0": [0], "worker-1": [0]}
    cmds = []
    for run, mr in ((trun, tmr), (jrun, jmr)):
        r = mr.PDSHRunner(run.parse_args(argv), world_info_base64="V0lORk8=")
        r.add_export("NCCL_DEBUG", "INFO")
        cmds.append(r.get_cmd({}, world))
    t, j = cmds
    assert t == [x.replace("deepspeed_tpu.launcher", "deepspeed_tpu_torch.launcher")
                 for x in j]
    assert "--node_rank=%n" in t and "'2'" in t
    pool = {"worker-0": 2, "worker-1": 2}
    t = tmr.OpenMPIRunner(trun.parse_args(argv), "V0lORk8=", pool).get_cmd({}, world)
    j = jmr.OpenMPIRunner(jrun.parse_args(argv), "V0lORk8=", pool).get_cmd({}, world)
    assert t[:t.index("-x")] == j[:j.index("-x")] == [
        "mpirun", "-n", "4", "-hostfile", "/nope", "--mca", "btl", "^openib",
        "--mca", "btl_tcp_if_include", "eth0"]
    assert "MASTER_ADDR=10.0.0.1" in t and "MASTER_PORT=29500" in t
    assert "DS_COORDINATOR_ADDRESS=10.0.0.1:29500" in j
    assert t[-3:] == j[-3:] == ["train.py", "--epochs", "2"]
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    t = tmr.MVAPICHRunner(trun.parse_args(argv), "V0lORk8=", pool).get_cmd({}, world)
    assert t[:5] == ["mpirun", "-np", "4", "-ppn", "2"]
    assert (tmp_path / "deepspeed_tpu_torch_mvapich_hostfile").read_text() == \
        "worker-0\nworker-1\n"


def test_num_filters_and_slots_refused_as_jax(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        trun.main(args="--num_nodes 1 --include worker-0 foo.py".split())
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("worker-0 slots=2\n")
    monkeypatch.setattr(trun.subprocess, "check_output", lambda *a, **k: b"10.0.0.1 ")
    with pytest.raises(ValueError, match="exceeds"):
        trun.main(args=["--hostfile", str(hostfile), "--num_gpus", "4", "train.py"])


# ------------------------------------------------------------------ identity
@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "8", "RANK": "5"},
    {"MV2_COMM_WORLD_SIZE": "4", "MV2_COMM_WORLD_RANK": "1"},
    {"PMI_SIZE": "2", "PMI_RANK": "0"},
    {"OMPI_COMM_WORLD_SIZE": "3", "OMPI_COMM_WORLD_RANK": "2"},
    {"OMPI_COMM_WORLD_SIZE": "1", "OMPI_COMM_WORLD_RANK": "0"},
    {},
])
def test_env_identity_equals_jax(no_identity, env):
    from deepspeed_tpu.runtime import dist as jdist
    from deepspeed_tpu_torch.runtime import dist as tdist
    for k, v in env.items():
        no_identity.setenv(k, v)
    no_identity.setenv("MASTER_ADDR", "h0")
    no_identity.setenv("MASTER_PORT", "1111")
    j = jdist._env_identity()
    assert tdist._env_identity() == j
    if env:
        assert j[0] == "h0:1111"


def test_mpi_world_without_master_addr_raises_naming_it(no_identity):
    from deepspeed_tpu_torch.runtime import dist as tdist
    no_identity.setitem(sys.modules, "mpi4py", None)     # no mpi4py to negotiate with
    no_identity.setenv("OMPI_COMM_WORLD_SIZE", "2")
    no_identity.setenv("OMPI_COMM_WORLD_RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tdist._env_identity()
    no_identity.delenv("OMPI_COMM_WORLD_SIZE")
    no_identity.setenv("WORLD_SIZE", "2")
    no_identity.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tdist.init_distributed("cpu")
    # a single-rank mpirun is no world to join
    no_identity.delenv("WORLD_SIZE")
    no_identity.delenv("RANK")
    no_identity.setenv("OMPI_COMM_WORLD_SIZE", "1")
    assert tdist._env_identity() == ("", 1, 0)
    assert tdist.init_distributed("cpu") is False
    no_identity.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "3")
    assert tdist._local_rank(0) == 3
    no_identity.setenv("LOCAL_RANK", "1")
    assert tdist._local_rank(0) == 1


# ----------------------------------------------------------------- front end
def test_cli_dispatches_and_refuses_by_item(capsys, tmp_path):
    """Every sub-command of the JAX front end dispatches; ``crash-sim`` and
    ``comm-sim`` write their JSON."""
    from deepspeed_tpu_torch import cli
    assert set(cli.COMMANDS) == {
        "inspect-dump", "timeline", "cluster-dump", "hang-sim", "goodput", "alerts",
        "metrics", "alert-sim", "serve-timeline", "lint", "anatomy", "hbm", "profile",
        "serve-sim", "crash-sim", "comm-sim"}
    import importlib
    for module, fn in cli.COMMANDS.values():
        assert callable(getattr(importlib.import_module(module), fn))
    crash, comm = tmp_path / "crash.json", tmp_path / "comm.json"
    assert cli.main(["crash-sim", "--kill-points", "auto_resume", "--device", "cpu",
                     "--json", str(crash)]) == 0
    assert json.loads(crash.read_text())["scenarios"]["trainer_auto_resume"]["ok"]
    assert cli.main(["comm-sim", "--out", str(comm)]) == 0
    assert json.loads(comm.read_text())["ok"]
    assert cli.main(["lint", "--ast-only"]) == 0
    assert "0 violation(s)" in capsys.readouterr().out


# --------------------------------------------------------- two ranks, gloo
WORKER = '''
import argparse, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import deepspeed_tpu_torch
from deepspeed_tpu_torch.lint.registry import LintModel

p = argparse.ArgumentParser()
p.add_argument("--local_rank", type=int)
p.add_argument("--data")
p.add_argument("--out")
a = p.parse_args()
data = np.load(a.data)
model = LintModel()
with torch.no_grad():
    for n, t in model.named_parameters():
        t.copy_(torch.from_numpy(data[n]))
cfg = json.loads(str(data["config"]))
eng, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config_params=cfg, device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
rows = slice(rank * 2, rank * 2 + 2)
losses = []
for x, y in zip(data["x"], data["y"]):
    loss = eng(x[rows], y[rows])
    eng.backward(loss)
    eng.step()
    t = loss.detach().clone()
    dist.all_reduce(t)
    losses.append(float(t) / world)
ident = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                    "CUDA_VISIBLE_DEVICES")}
ident["local_rank_arg"] = a.local_rank
with open(f"{a.out}.{rank}", "w") as f:
    json.dump({"losses": losses, "env": ident}, f)
'''

STEPS = 3
CONFIG = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000,
          "bf16": {"enabled": False},
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}


def _jax_losses(params, xs, ys):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.lint.registry import LintModel as JaxLintModel
    from deepspeed_tpu.parallel.mesh import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    eng = DeepSpeedEngine(model=JaxLintModel(),
                          model_parameters={k: jnp.asarray(v) for k, v in params.items()},
                          mesh=build_mesh(data=2, devices=jax.devices()[:2]),
                          config_params=CONFIG)
    out = []
    for x, y in zip(xs, ys):
        loss = eng(x, y)
        eng.backward(loss)
        eng.step()
        out.append(float(loss))
    return out


def test_two_ranks_through_launch_equal_the_jax_engine_at_dp2(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(32, 32)).astype(np.float32) * 0.1,
              "b1": np.zeros(32, np.float32),
              "w2": rng.normal(size=(32, 32)).astype(np.float32) * 0.1,
              "b2": np.zeros(32, np.float32)}
    xs = rng.normal(size=(STEPS, 4, 32)).astype(np.float32)
    ys = np.tanh(xs)
    np.savez(tmp_path / "data.npz", x=xs, y=ys, config=json.dumps(CONFIG), **params)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    world = base64.urlsafe_b64encode(json.dumps({"localhost": [0, 1]}).encode()).decode()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in IDENTITY_VARS and k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = str(ROOT)
    out = tmp_path / "out.json"
    r = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
                        "--node_rank=0", "--master_addr=127.0.0.1", f"--master_port={port}",
                        f"--world_info={world}", str(worker), f"--data={tmp_path / 'data.npz'}",
                        f"--out={out}"], env=env, capture_output=True, text=True,
                       timeout=240, cwd=str(tmp_path))
    assert r.returncode == 0, f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
    res = [json.loads(Path(f"{out}.{rank}").read_text()) for rank in (0, 1)]
    for rank, rr in enumerate(res):
        assert rr["env"] == {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                             "MASTER_ADDR": "127.0.0.1", "CUDA_VISIBLE_DEVICES": "0,1",
                             "local_rank_arg": rank}
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_allclose(res[0]["losses"], _jax_losses(params, xs, ys), rtol=1e-5, atol=0)


def test_inspect_dump_main_prints_jax_summary(tmp_path, capsys):
    """``ds-tpu-torch inspect-dump``, copied host code: the same summary as
    the JAX command for the same bundle, file and directory modes."""
    from deepspeed_tpu.utils import numerics as jnum
    from deepspeed_tpu_torch import cli
    bundle = {"reason": "nonfinite", "detail": "grad", "host": 0, "first_bad_step": 7,
              "offending_subtree": "blocks.0.attn", "steps": [{"step": 6}, {"step": 7}],
              "events": [], "loss_scale_trajectory": [[6, 1024.0], [7, 512.0]],
              "compile_records": [], "run_id": "r1"}
    path = tmp_path / "numerics_dump_r1_host0.json"
    path.write_text(json.dumps(bundle))
    for args in ([str(path), "--json"], [str(path)], [str(tmp_path), "--json"]):
        rc = cli.main(["inspect-dump", *args])
        out = capsys.readouterr().out
        assert (rc, out) == (jnum.inspect_dump_main(args), capsys.readouterr().out), args
