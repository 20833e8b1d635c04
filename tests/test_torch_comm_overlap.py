"""``comm.overlap.mode: bucketed`` (``runtime/engine.py``, ``comm/hierarchical.py``):
the bucketed exchange against the monolithic one over two gloo processes,
and against the JAX engine.

- the bucket partition and plan equal the JAX ones;
- at dp = 2 the bucketed exchange is bit for bit the monolithic one: the
  flat per-leaf mean (ZeRO 0 float32 and ZeRO 2 bf16), the fused step, and
  the two-level schedule (``comm.mode: hierarchical``, 2 slices of 1);
- its buckets begin inside the backward: ``two_level_start`` runs from the
  grad hooks, while the engine collects (every bucket, since each bucket's
  leaves are all reached);
- ``hierarchical_compressed`` with the overlap keeps the bucketed error
  feedback layout (``bucketed_error_state_shapes``) and trains as the JAX
  engine does (losses within 1e-5, the master within 1e-4: sign flips of
  near-zero elements follow float32 rounding);
- at one rank the overlap is inert: bit for bit the flat engine.
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

import deepspeed_tpu_torch
from deepspeed_tpu.comm import CommTopology as JTopology
from deepspeed_tpu.comm import hierarchical as jhier
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.comm import hierarchical as hier
from deepspeed_tpu_torch.comm.topology import CommTopology
from test_torch_onebit_adam import MLP, _JMLP, _params

H = 16
STEPS = 4
TINY = {"mode": "bucketed", "bucket_mb": 0.001}     # (b1, b2) / (w1) / (w2)
# name: (config overrides of the monolithic run, of the bucketed run)
PAIRS = {
    "flat_f32": ({}, {"comm": {"overlap": TINY}}),
    "flat_zero2_bf16": ({"bf16": {"enabled": True}, "zero_optimization": {"stage": 2}},
                        {"bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                         "comm": {"overlap": TINY}}),
    "fused": ({"fused_step": True}, {"fused_step": True, "comm": {"overlap": TINY}}),
    "hierarchical": ({"comm": {"mode": "hierarchical", "dcn_slices": 2}},
                     {"comm": {"mode": "hierarchical", "dcn_slices": 2, "overlap": TINY}}),
}
COMPRESSED = {"comm": {"mode": "hierarchical_compressed", "dcn_slices": 2, "overlap": TINY}}


def _config(dp, **over):
    cfg = {"train_batch_size": dp, "train_micro_batch_size_per_gpu": 1,
           "steps_per_print": 1000, "bf16": {"enabled": False},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(over)
    return cfg


def _batches(seed=3):
    rng = np.random.default_rng(seed)
    return [(x, np.cos(x)) for x in (rng.normal(size=(2, H)).astype(np.float32)
                                     for _ in range(STEPS))]


def _train(eng, batches, rows):
    losses = []
    for x, y in batches:
        loss = eng(x[rows], y[rows])
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
    return losses


def _worker(rank, port, out_dir, params, batches):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    res = {}
    rows = slice(rank, rank + 1)
    starts = []
    real_start = hier.two_level_start

    def start(x, groups):
        eng = starts[-1][0] if starts else None
        starts.append((eng, bool(getattr(eng, "_collecting", False))))
        return real_start(x, groups)

    try:
        for name, (mono_cfg, buck_cfg) in PAIRS.items():
            for kind, cfg in (("mono", mono_cfg), ("buck", buck_cfg)):
                eng, _, _, _ = deepspeed_tpu_torch.initialize(
                    model=MLP(params), config_params=_config(2, **cfg), device="cpu",
                    dist_init_required=False)
                if kind == "buck":
                    starts.clear()
                    starts.append((eng, False))
                    hier.two_level_start = start
                try:
                    res[f"{name}/{kind}/losses"] = np.asarray(_train(eng, batches, rows))
                finally:
                    hier.two_level_start = real_start
                for k, v in eng.master_params.items():
                    res[f"{name}/{kind}/master/{k}"] = v.float().numpy()
                if kind == "buck":
                    res[f"{name}/buckets"] = np.asarray(len(eng._overlap_plan))
                    res[f"{name}/starts_in_backward"] = np.asarray(
                        sum(inside for _, inside in starts[1:]))
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=MLP(params), config_params=_config(2, **COMPRESSED), device="cpu",
            dist_init_required=False)
        res["comp/losses"] = np.asarray(_train(eng, batches, rows))
        for k, v in eng.master_params.items():
            res[f"comp/master/{k}"] = v.numpy()
        res["comp/we"], res["comp/se"] = eng._comm_we.numpy(), eng._comm_se.numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)


@pytest.fixture(scope="module")
def run2():
    params, batches = _params(), _batches()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="comm_overlap_")
    mp.start_processes(_worker, args=(port, out_dir, params, batches), nprocs=2,
                       start_method="spawn", join=True)
    return params, batches, [dict(np.load(os.path.join(out_dir, f"r{r}.npz")))
                             for r in (0, 1)]


def test_bucket_partition_and_plan_equal_jax():
    shapes = [(16,), (16,), (16, 16), (16, 16), (3,), (1000,)]
    leaves = [np.zeros(s, np.float32) for s in shapes]
    tl = [torch.from_numpy(a) for a in leaves]
    for nbytes in (1, 100, 1100, 1 << 20):
        assert hier.bucket_partition(tl, nbytes) == jhier.bucket_partition(leaves, nbytes)
        plan = hier.bucket_plan(tl, nbytes, 2)
        assert plan == jhier.bucket_plan(leaves, nbytes, 2)
        for s in (1, 2):
            assert hier.bucketed_error_state_shapes(plan, CommTopology(2, s)) == \
                jhier.bucketed_error_state_shapes(plan, JTopology(2, s))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_bucketed_bit_equal_monolithic(run2, name):
    for res in run2[2]:
        np.testing.assert_array_equal(res[f"{name}/buck/losses"], res[f"{name}/mono/losses"])
        keys = [k for k in res if k.startswith(f"{name}/mono/master/")]
        assert len(keys) == 4
        for k in keys:
            np.testing.assert_array_equal(res[k.replace("/mono/", "/buck/")], res[k], err_msg=k)
        assert int(res[f"{name}/buckets"]) == 3
        # every bucket of every micro-step began from a grad hook
        assert int(res[f"{name}/starts_in_backward"]) == 3 * STEPS


def test_compressed_overlap_layout_and_training_equal_jax(run2):
    params, batches, res = run2
    mesh = build_mesh(data=2, model=1, pipe=1, devices=jax.devices()[:2])
    jeng = DeepSpeedEngine(model=_JMLP(), model_parameters=jax.tree_util.tree_map(
        jnp.asarray, params), mesh=mesh, config_params=_config(2, **COMPRESSED))
    losses = []
    for x, y in batches:
        loss = jeng(x, y)
        jeng.backward(loss)
        jeng.step()
        losses.append(float(jax.device_get(loss)))
    master = jax.device_get(jeng.master_params)
    jwe, jse = np.asarray(jeng._comm_we), np.asarray(jeng._comm_se)
    ordered = [np.zeros(params[k].shape) for k in sorted(params)]
    (_, we_cols), (_, se_cols) = jhier.bucketed_error_state_shapes(
        jhier.bucket_plan(ordered, int(TINY["bucket_mb"] * (1 << 20)), 2), JTopology(2, 2))
    for r, out in enumerate(res):
        assert out["comp/we"].shape == (we_cols,) and out["comp/se"].shape == (se_cols,)
        np.testing.assert_allclose(out["comp/we"], jwe[r], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["comp/se"], jse[r], rtol=0, atol=1e-4)
        for k, v in master.items():
            np.testing.assert_allclose(out[f"comp/master/{k}"], np.asarray(v), rtol=0,
                                       atol=1e-4, err_msg=k)
    mean = (res[0]["comp/losses"] + res[1]["comp/losses"]) / 2
    np.testing.assert_allclose(mean, losses, rtol=1e-5, atol=0)


def test_overlap_is_inert_at_one_rank():
    params, batches = _params(), _batches()
    runs = []
    for over in ({}, {"comm": {"overlap": TINY}},
                 {"comm": {"mode": "hierarchical_compressed", "overlap": TINY}}):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=MLP(params),
                                                      config_params=_config(1, **over),
                                                      device="cpu")
        assert eng._exchange_kind == "flat" and eng._overlap_plan is None
        assert eng._comm_we is None
        runs.append((_train(eng, batches, slice(0, 1)),
                     {k: v.clone() for k, v in eng.master_params.items()}))
    for losses, master in runs[1:]:
        assert losses == runs[0][0]
        for k in master:
            assert torch.equal(master[k], runs[0][1][k])
