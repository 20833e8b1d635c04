"""The two-level exchange (``comm/topology.py``, ``comm/hierarchical.py``) and
the engine's ``comm.mode`` against the JAX package's, at 4 ranks factorized
2 x 2: four gloo processes against a 4-device JAX mesh (the only port test
with more than two processes: a 2 x 2 factorization needs four ranks).

- the topology rules and groups equal the JAX ones;
- ``two_level_sum`` is bit-equal to JAX's two-level mean on integer-valued
  data (every partial sum exact) and within 1e-6 on normal data;
- ``two_level_compressed``, two chained steps with the error feedback
  carried, within 1e-5 of the inputs' magnitude (the segment scales sum in
  another order; the signs are exact);
- the bucketed mean is bit-equal to the monolithic one;
- the engine at ``comm.mode: hierarchical`` and ``hierarchical_compressed``
  (float32, ZeRO 0, one row a rank) against the JAX engine: losses within
  1e-5, the masters within 1e-5 (hierarchical) and 1e-4 (compressed, whose
  sign flips of near-zero elements follow float32 rounding);
- the compressed engine's error feedback in checkpoints: the dp = 4 save
  restored at dp = 2 (``resilience/elastic.py``, remapped) by the port and by
  the JAX engine gives the same buffers.
"""

import os
import socket
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu_torch
from deepspeed_tpu.comm import CommTopology as JTopology
from deepspeed_tpu.comm import derive_num_slices as jderive
from deepspeed_tpu.comm import hierarchical as jhier
from deepspeed_tpu.parallel.mesh import DATA_AXIS, build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.comm import hierarchical as hier
from deepspeed_tpu_torch.comm.topology import (CommGroups, CommTopology, derive_num_slices,
                                               derive_topology)
from test_torch_onebit_adam import MLP, _JMLP, _params

H = 16
STEPS = 4
N = 4 * 128 * 2          # a vector the 4 ranks' chunks divide, packable by 8
MODES = {"hier": {"mode": "hierarchical", "dcn_slices": 2},
         "comp": {"mode": "hierarchical_compressed", "dcn_slices": 2}}


def _config(dp, comm):
    return {"train_batch_size": dp, "train_micro_batch_size_per_gpu": 1,
            "steps_per_print": 1000, "bf16": {"enabled": False},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}, "comm": comm}


def _batches(seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(4, H)).astype(np.float32)
        out.append((x, np.sin(x)))
    return out


def _vectors(seed=5):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-8, 8, size=(4, N)).astype(np.float32)
    normal = [rng.normal(size=(4, N)).astype(np.float32) * s for s in (1.0, 0.5)]
    seg = np.repeat(np.arange(5), [300, 200, 24, 300, N - 824]).astype(np.int32)
    return ints, normal, seg


# ------------------------------------------------------------------ topology
def test_topology_rules_equal_jax():
    for dp, req, procs in ((8, 4, 1), (8, 0, 2), (6, 0, 3), (6, 0, 4), (8, 0, 1),
                           (4, 0, 1), (4, 2, 1)):
        assert derive_num_slices(dp, req, process_count=procs) == jderive(dp, req, procs)
    with pytest.raises(ValueError, match="does not divide"):
        derive_num_slices(8, 3)
    for dp, s in ((8, 2), (4, 2), (6, 3), (4, 1)):
        t, jt = CommTopology(dp, s), JTopology(dp, s)
        assert (t.ici_groups, t.dcn_groups, t.slice_rows) == (jt.ici_groups, jt.dcn_groups,
                                                              jt.slice_rows)
        assert [t.slice_of(r) for r in range(dp)] == [jt.slice_of(r) for r in range(dp)]
    assert derive_topology(8, 0, process_count=1) == CommTopology(8, 2)
    # a world-less process: no groups, the two-level functions run locally
    g = CommGroups(CommTopology(1, 1))
    assert (g.world, g.ici, g.dcn) == (None, None, None)


def test_plans_and_state_shapes_equal_jax():
    leaves = [np.zeros(s, np.float32) for s in ((7,), (300, 4), (5, 5), (1000,), (3,))]
    tl = [torch.from_numpy(a) for a in leaves]
    for mb in (0.001, 0.004, 1.0):
        plan = hier.bucket_plan(tl, int(mb * (1 << 20)), 4)
        jplan = jhier.bucket_plan(leaves, int(mb * (1 << 20)), 4)
        assert plan == jplan
        topo, jtopo = CommTopology(4, 2), JTopology(4, 2)
        assert hier.bucketed_error_state_shapes(plan, topo) == \
            jhier.bucketed_error_state_shapes(jplan, jtopo)
    assert hier.error_state_shapes(1024, CommTopology(4, 2)) == \
        jhier.error_state_shapes(1024, JTopology(4, 2))
    np.testing.assert_array_equal(hier.grad_segment_ids(tl, 3072),
                                  jhier.grad_segment_ids(leaves, 3072))


# ------------------------------------------------------------------ 4 ranks
def _run_engine(rank, comm, params, batches):
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=MLP(params), config_params=_config(4, comm), device="cpu",
        dist_init_required=False)
    losses = []
    for x, y in batches:
        loss = eng(x[rank:rank + 1], y[rank:rank + 1])
        eng.backward(loss)
        eng.step()
        t = loss.detach().clone()
        dist.all_reduce(t)
        losses.append(float(t) / 4)
    return eng, losses


def _worker(rank, ports, out_dir, params, batches):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[0]}", world_size=4,
                            rank=rank)
    res = {}
    try:
        ints, normal, seg = _vectors()
        groups = CommGroups(CommTopology(4, 2), rank)
        res["int_sum"] = (hier.two_level_sum(torch.from_numpy(ints[rank]).clone(), groups)
                          / 4).numpy()
        res["float_sum"] = (hier.two_level_sum(torch.from_numpy(normal[0][rank]).clone(),
                                               groups) / 4).numpy()
        segs = hier.leaf_segments(np.bincount(seg).tolist(), N)
        we, se = torch.zeros(N // 2), torch.zeros(N // 4)
        for i, x in enumerate(normal):
            out, we, se = hier.two_level_compressed(torch.from_numpy(x[rank]), we, se,
                                                    groups, segs)
            res[f"comp_out{i}"], res[f"comp_we{i}"], res[f"comp_se{i}"] = (
                out.numpy(), we.numpy(), se.numpy())
        leaves = list(torch.from_numpy(normal[1][rank]).split([100, 212, 400, 312]))
        plan = hier.bucket_plan(leaves, 1600, 4)
        bucketed = hier.bucketed_two_level_mean(leaves, plan, groups)
        mono = hier.two_level_sum(torch.cat(leaves).clone(), groups) / 4
        res["bucketed_bit_equal"] = np.asarray(torch.equal(torch.cat(bucketed), mono))
        for name, comm in MODES.items():
            eng, losses = _run_engine(rank, comm, params, batches)
            res[f"{name}_losses"] = np.asarray(losses)
            for k, v in eng.master_params.items():
                res[f"{name}_master/{k}"] = v.numpy()
        res["comm_we"], res["comm_se"] = eng._comm_we.numpy(), eng._comm_se.numpy()
        eng.save_checkpoint(os.path.join(out_dir, "ckpt"), tag="dp4")
    finally:
        dist.destroy_process_group()
    if rank < 2:
        # the dp = 4 save restored at dp = 2 (2 slices of 1): remapped
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[1]}",
                                world_size=2, rank=rank)
        try:
            eng, _, _, _ = deepspeed_tpu_torch.initialize(
                model=MLP(params), config_params=_config(2, MODES["comp"]), device="cpu",
                dist_init_required=False)
            eng.load_checkpoint(os.path.join(out_dir, "ckpt"), tag="dp4")
            res["dp2_we"], res["dp2_se"] = eng._comm_we.numpy(), eng._comm_se.numpy()
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)


@pytest.fixture(scope="module")
def run4():
    params, batches = _params(), _batches()
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            ports.append(s.getsockname()[1])
    out_dir = tempfile.mkdtemp(prefix="comm_2x2_")
    mp.start_processes(_worker, args=(ports, out_dir, params, batches), nprocs=4,
                       start_method="spawn", join=True)
    return params, batches, out_dir, [dict(np.load(os.path.join(out_dir, f"r{r}.npz")))
                                      for r in range(4)]


def _mesh(dp):
    return build_mesh(data=dp, model=1, pipe=1, devices=jax.devices()[:dp])


def test_two_level_sum_equals_jax(run4):
    _, _, _, res = run4
    ints, normal, _ = _vectors()
    mesh, topo = _mesh(4), JTopology(4, 2)
    sh = NamedSharding(mesh, P(DATA_AXIS, None))
    want_int = np.asarray(jhier.two_level_allreduce(mesh, jax.device_put(ints, sh), topo))
    want = np.asarray(jhier.two_level_allreduce(mesh, jax.device_put(normal[0], sh), topo))
    for r in range(4):
        np.testing.assert_array_equal(res[r]["int_sum"], want_int)
        np.testing.assert_allclose(res[r]["float_sum"], want, rtol=1e-6, atol=1e-7)


def test_two_level_compressed_equals_jax(run4):
    _, _, _, res = run4
    _, normal, seg = _vectors()
    mesh, topo = _mesh(4), JTopology(4, 2)
    sh = NamedSharding(mesh, P(DATA_AXIS, None))
    we = jax.device_put(jnp.zeros((4, N // 2)), sh)
    se = jax.device_put(jnp.zeros((4, N // 4)), sh)
    for i, x in enumerate(normal):
        out, we, se = jhier.two_level_compressed_allreduce(
            mesh, jax.device_put(jnp.asarray(x), sh), we, se, topo, seg_ids=seg)
        atol = 1e-5 * np.abs(x).max()
        for r in range(4):
            np.testing.assert_allclose(res[r][f"comp_out{i}"], np.asarray(out), rtol=0,
                                       atol=atol)
            np.testing.assert_allclose(res[r][f"comp_we{i}"], np.asarray(we)[r], rtol=0,
                                       atol=atol)
            np.testing.assert_allclose(res[r][f"comp_se{i}"], np.asarray(se)[r], rtol=0,
                                       atol=atol)


def test_bucketed_mean_bit_equal_monolithic(run4):
    assert all(bool(r["bucketed_bit_equal"]) for r in run4[3])


@pytest.mark.parametrize("name,master_tol", [("hier", 1e-5), ("comp", 1e-4)])
def test_engine_comm_modes_equal_jax_engine(run4, name, master_tol):
    params, batches, _, res = run4
    jeng = DeepSpeedEngine(model=_JMLP(), model_parameters=jax.tree_util.tree_map(
        jnp.asarray, params), mesh=_mesh(4), config_params=_config(4, MODES[name]))
    losses = []
    for x, y in batches:
        loss = jeng(x, y)
        jeng.backward(loss)
        jeng.step()
        losses.append(float(jax.device_get(loss)))
    master = jax.device_get(jeng.master_params)
    for r in range(4):
        np.testing.assert_allclose(res[r][f"{name}_losses"], losses, rtol=1e-5, atol=0)
        for k, v in master.items():
            np.testing.assert_allclose(res[r][f"{name}_master/{k}"], np.asarray(v), rtol=0,
                                       atol=master_tol, err_msg=k)
    if name == "comp":
        jwe, jse = np.asarray(jeng._comm_we), np.asarray(jeng._comm_se)
        assert np.abs(jwe).max() > 0
        for r in range(4):
            assert res[r]["comm_we"].shape == jwe[r].shape
            assert res[r]["comm_se"].shape == jse[r].shape


def test_comm_ef_restores_across_world_sizes_as_jax(run4):
    params, _, out_dir, res = run4
    jeng = DeepSpeedEngine(model=_JMLP(), model_parameters=jax.tree_util.tree_map(
        jnp.asarray, params), mesh=_mesh(2), config_params=_config(2, MODES["comp"]))
    jeng.load_checkpoint(os.path.join(out_dir, "ckpt"), tag="dp4")
    jwe, jse = np.asarray(jeng._comm_we), np.asarray(jeng._comm_se)
    for r in range(2):
        np.testing.assert_array_equal(res[r]["dp2_we"], jwe[r])
        np.testing.assert_array_equal(res[r]["dp2_se"], jse[r])
    # the dp = 4 server residual's real elements survive the remap
    assert np.abs(jse).max() > 0
