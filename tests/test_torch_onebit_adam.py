"""1-bit Adam and its compressed allreduce (``ops/onebit_adam.py``,
``runtime/custom_collectives.py``) against the JAX package's, on the same
seeded inputs and weights:

- the bit-packed sign wire format equals ``jnp.packbits(..., bitorder=
  "little")``; the per-leaf scale segments equal the JAX segment sums;
- ``compressed_allreduce`` at dp = 1 and, over two gloo processes, at dp = 2
  against the JAX function on a 2-device mesh (two chained steps, the error
  feedback carried): outputs and error buffers within 1e-5 of the inputs'
  largest magnitude (the per-segment scales sum their squares in another
  order, and a server residual at one rank is rounding noise; the signs are
  exact);
- the engine's 1-bit Adam at dp = 2 (two gloo ranks, one row each) against
  the JAX engine on a 2-device mesh, float32, through the warmup and the
  frozen phase: losses and state within 1e-5; the master within 1e-4 of
  its own movement over the run (an update divides the compressed momentum
  by the frozen sqrt(v), so the grads' float32 reassociation, 1e-5
  relative in v's smallest elements, reaches the master amplified);
- the 1-bit state in checkpoints, the JAX engine's format: the dp = 2 save
  restored at dp = 1 by both packages (the elastic adaptation) gives the
  same state, and a checkpoint crosses both ways at dp = 1;
- the error-feedback remap across world sizes 2 -> 4 -> 2, against the JAX
  function: the server error's real elements survive bit for bit.
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
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu.ops.onebit_adam import OneBitAdam as JOneBitAdam
from deepspeed_tpu.parallel.mesh import DATA_AXIS, build_mesh
from deepspeed_tpu.resilience.elastic import remap_ef_block as jremap
from deepspeed_tpu.runtime import custom_collectives as jcc
from deepspeed_tpu.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.ops.onebit_adam import OneBitAdam
from deepspeed_tpu_torch.resilience.elastic import remap_ef_block
from deepspeed_tpu_torch.runtime import custom_collectives as cc

H = 16
STEPS = 5
FREEZE = 2
TOL = 1e-5


class _JMLP:
    def apply(self, params, x, y):
        h = jnp.tanh(x @ params["w1"] + params["b1"])
        return jnp.mean(jnp.square(h @ params["w2"] + params["b2"] - y))


class MLP(nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(np.array(v, np.float32))))

    def forward(self, x, y):
        # in the parameters' dtype (the engine's compute dtype), the loss in float32
        h = torch.tanh(x.to(self.w1.dtype) @ self.w1 + self.b1)
        return torch.mean(torch.square((h @ self.w2 + self.b2).float() - y))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(H, H)) * 0.3).astype(np.float32),
            "b1": np.zeros(H, np.float32),
            "w2": (rng.normal(size=(H, H)) * 0.3).astype(np.float32),
            "b2": (rng.normal(size=H) * 0.1).astype(np.float32)}


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(2, H)).astype(np.float32)
        out.append((x, np.tanh(x @ np.eye(H, dtype=np.float32)[::-1])))
    return out


def _config(dp, freeze=FREEZE):
    return {"train_batch_size": dp, "train_micro_batch_size_per_gpu": 1,
            "steps_per_print": 1000, "bf16": {"enabled": False},
            "optimizer": {"type": "OneBitAdam",
                          "params": {"lr": 1e-2, "freeze_step": freeze}}}


def _allreduce_inputs(n=2 * 128 * 3, dp=2, seed=7):
    rng = np.random.default_rng(seed)
    seg = np.repeat(np.arange(4), [100, 300, 200, n - 600]).astype(np.int32)
    x = [rng.normal(size=(dp, n)).astype(np.float32) * s for s in (1.0, 0.3)]
    return x, seg


# ------------------------------------------------------------------ wire format
def test_pack_signs_is_jnp_packbits_little():
    rng = np.random.default_rng(0)
    pos = rng.random((3, 64)) > 0.5
    packed = cc._pack_signs(torch.from_numpy(pos))
    want = np.asarray(jnp.packbits(jnp.asarray(pos), axis=-1, bitorder="little"))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(cc._unpack_signs(packed).numpy(), np.where(pos, 1.0, -1.0))


def test_segment_map_equals_segment_sums():
    rng = np.random.default_rng(1)
    sizes = [5, 0, 17, 3, 39]
    segs = cc.SegmentMap(sizes)
    buf = rng.normal(size=64).astype(np.float32)
    ids = np.repeat(np.arange(len(sizes)), sizes)
    for start, stop in ((0, 64), (8, 40), (22, 23)):
        part = torch.from_numpy(buf[start:stop])
        got = segs.rms(part, start).numpy()
        sub = ids[start:stop]
        ss = np.bincount(sub, weights=buf[start:stop].astype(np.float64) ** 2,
                         minlength=len(sizes))
        want = np.sqrt(ss / np.maximum(np.bincount(sub, minlength=len(sizes)), 1))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_array_equal(segs.expand(torch.from_numpy(want).float(), start,
                                                  stop).numpy(),
                                      want[sub].astype(np.float32))
    assert cc.SegmentMap.from_ids(ids).sizes == sizes


# ------------------------------------------------------------------ dp = 1
def test_compressed_allreduce_dp1_equals_jax_and_keeps_the_identity():
    """At one rank the collectives are the identity and the compression runs:
    m + we + se = out + we' + se' to float32 rounding, and equal to JAX's."""
    (x, _), seg = _allreduce_inputs(dp=1)
    mesh = build_mesh(data=1, model=1, pipe=1, devices=jax.devices()[:1])
    we = np.zeros_like(x)
    se = np.zeros((1, x.shape[1]), np.float32)
    jout, jwe, jse = jcc.compressed_allreduce(mesh, jnp.asarray(x), jnp.asarray(we),
                                              jnp.asarray(se), seg_ids=seg)
    out, nwe, nse = cc.compressed_allreduce(torch.from_numpy(x[0]), torch.from_numpy(we[0]),
                                            torch.from_numpy(se[0]), seg_ids=seg)
    atol = TOL * np.abs(x).max()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=atol)
    np.testing.assert_allclose(nwe.numpy(), np.asarray(jwe)[0], rtol=0, atol=atol)
    np.testing.assert_allclose(nse.numpy(), np.asarray(jse)[0], rtol=0, atol=atol)
    lhs = x[0] + we[0] + se[0]
    np.testing.assert_allclose(out.numpy() + nwe.numpy() + nse.numpy(), lhs, rtol=0,
                               atol=4e-6 * np.abs(lhs).max())


# ------------------------------------------------------------------ dp = 2
def _worker(rank, port, out_dir, params, batches):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        xs, seg = _allreduce_inputs()
        n = xs[0].shape[1]
        we, se = torch.zeros(n), torch.zeros(n // 2)
        outs = {}
        for i, x in enumerate(xs):
            out, we, se = cc.compressed_allreduce(torch.from_numpy(x[rank]), we, se,
                                                  seg_ids=seg)
            outs[f"out{i}"], outs[f"we{i}"], outs[f"se{i}"] = out.numpy(), we.numpy(), se.numpy()
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=MLP(params), config_params=_config(2), device="cpu",
            dist_init_required=False)
        losses = []
        for x, y in batches:
            loss = eng(x[rank:rank + 1], y[rank:rank + 1])
            eng.backward(loss)
            eng.step()
            t = loss.detach().clone()
            dist.all_reduce(t)
            losses.append(float(t) / 2)
        eng.save_checkpoint(os.path.join(out_dir, "ckpt"), tag="dp2")
        st = eng.opt_state
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), losses=np.asarray(losses),
                 **outs, **{f"master/{k}": v.numpy() for k, v in eng.master_params.items()},
                 **{f"opt/{f}": t.numpy() for f, t in zip(st._fields, st)})
    finally:
        dist.destroy_process_group()


def _jax_engine(params, dp):
    mesh = build_mesh(data=dp, model=1, pipe=1, devices=jax.devices()[:dp])
    return DeepSpeedEngine(model=_JMLP(), model_parameters=jax.tree_util.tree_map(
        jnp.asarray, params), mesh=mesh, config_params=_config(dp))


def _jax_state(eng):
    st = jax.device_get(eng.opt_state)
    return {f: np.asarray(v) for f, v in zip(st._fields, st)}


@pytest.fixture(scope="module")
def dp2_run():
    params, batches = _params(), _batches()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="onebit_dp2_")
    mp.start_processes(_worker, args=(port, out_dir, params, batches), nprocs=2,
                       start_method="spawn", join=True)
    res = [dict(np.load(os.path.join(out_dir, f"r{r}.npz"))) for r in (0, 1)]
    return params, batches, out_dir, res


def test_compressed_allreduce_dp2_equals_jax(dp2_run):
    _, _, _, res = dp2_run
    xs, seg = _allreduce_inputs()
    mesh = build_mesh(data=2, model=1, pipe=1, devices=jax.devices()[:2])
    sh = NamedSharding(mesh, P(DATA_AXIS, None))
    n = xs[0].shape[1]
    we = jax.device_put(jnp.zeros((2, n)), sh)
    se = jax.device_put(jnp.zeros((2, n // 2)), sh)
    for i, x in enumerate(xs):
        out, we, se = jcc.compressed_allreduce(mesh, jax.device_put(jnp.asarray(x), sh), we,
                                               se, seg_ids=seg)
        atol = TOL * np.abs(x).max()
        for r in (0, 1):
            np.testing.assert_allclose(res[r][f"out{i}"], np.asarray(out), rtol=0, atol=atol)
            np.testing.assert_allclose(res[r][f"we{i}"], np.asarray(we)[r], rtol=0, atol=atol)
            np.testing.assert_allclose(res[r][f"se{i}"], np.asarray(se)[r], rtol=0, atol=atol)


def test_engine_onebit_dp2_equals_jax_engine(dp2_run):
    params, batches, _, res = dp2_run
    jeng = _jax_engine(params, 2)
    losses = []
    for x, y in batches:
        loss = jeng(x, y)
        jeng.backward(loss)
        jeng.step()
        losses.append(float(jax.device_get(loss)))
    master = jax.device_get(jeng.master_params)
    state = _jax_state(jeng)
    for r in (0, 1):
        np.testing.assert_allclose(res[r]["losses"], losses, rtol=1e-5, atol=0)
        for k, v in master.items():
            moved = np.abs(np.asarray(v) - params[k]).max()
            np.testing.assert_allclose(res[r][f"master/{k}"], np.asarray(v), rtol=0,
                                       atol=1e-4 * moved, err_msg=k)
        np.testing.assert_allclose(res[r]["opt/exp_avg"], state["exp_avg"], rtol=0, atol=1e-5)
        # the variance froze after the warmup, the error buffers are each rank's row
        np.testing.assert_allclose(res[r]["opt/exp_avg_sq"], state["exp_avg_sq"], rtol=1e-5,
                                   atol=1e-9)
        for f in ("worker_error", "server_error"):
            np.testing.assert_allclose(res[r][f"opt/{f}"], state[f][r], rtol=0, atol=1e-5)
    assert np.abs(state["worker_error"]).max() > 0


def test_dp2_checkpoint_restores_elastically_at_dp1(dp2_run):
    """The dp = 2 save (the JAX engine's files) restored at dp = 1 by the port
    and by the JAX engine: the same adapted state, the moments whole."""
    params, _, out_dir, res = dp2_run
    ckpt = os.path.join(out_dir, "ckpt")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=MLP(params), config_params=_config(1),
                                                  device="cpu")
    eng.load_checkpoint(ckpt, tag="dp2")
    jeng = _jax_engine(params, 1)
    jeng.load_checkpoint(ckpt, tag="dp2")
    want = _jax_state(jeng)
    for f, t in zip(eng.opt_state._fields, eng.opt_state):
        got = t.numpy()
        np.testing.assert_array_equal(got, want[f][0] if f.endswith("_error") else want[f],
                                      err_msg=f)
    n = sum(v.size for v in params.values())
    np.testing.assert_array_equal(eng.opt_state.exp_avg.numpy()[:n], res[0]["opt/exp_avg"][:n])
    assert eng.global_steps == jeng.global_steps == STEPS


def test_checkpoint_crosses_both_ways_at_dp1(tmp_path):
    params, batches = _params(), _batches()
    jeng = _jax_engine(params, 1)
    for x, y in batches[:4]:
        loss = jeng(x[:1], y[:1])
        jeng.backward(loss)
        jeng.step()
    jeng.save_checkpoint(str(tmp_path), tag="jax")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=MLP(params), config_params=_config(1),
                                                  device="cpu")
    eng.load_checkpoint(str(tmp_path), tag="jax")
    want = _jax_state(jeng)
    for f, t in zip(eng.opt_state._fields, eng.opt_state):
        np.testing.assert_array_equal(t.numpy(), want[f][0] if f.endswith("_error")
                                      else want[f], err_msg=f)
    x, y = batches[4]
    for e in (eng, jeng):
        loss = e(x[:1], y[:1])
        e.backward(loss)
        e.step()
    eng.save_checkpoint(str(tmp_path), tag="torch")
    jeng2 = _jax_engine(params, 1)
    jeng2.load_checkpoint(str(tmp_path), tag="torch")
    back = _jax_state(jeng2)
    ours = _jax_state(jeng)
    for f in back:
        np.testing.assert_allclose(back[f], ours[f], rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(back["server_error"][0], eng.opt_state.server_error.numpy())


# ------------------------------------------------------------------ elastic remap
def test_error_feedback_remap_2_4_2_equals_jax():
    rng = np.random.default_rng(3)
    n_pad2 = jcc.padded_size(1000, 2)
    n_pad4 = jcc.padded_size(1000, 4)
    we = rng.normal(size=(2, n_pad2)).astype(np.float32)
    se = rng.normal(size=(2, n_pad2 // 2)).astype(np.float32)
    we4, se4 = remap_ef_block(we, se, 2, 1, n_pad2, 4, 1, n_pad4)
    jwe4, jse4 = jremap(we, se, 2, 1, n_pad2, 4, 1, n_pad4)
    np.testing.assert_array_equal(we4, jwe4)
    np.testing.assert_array_equal(se4, jse4)
    we2, se2 = remap_ef_block(we4, se4, 4, 1, n_pad4, 2, 1, n_pad2)
    np.testing.assert_array_equal(we2, jremap(jwe4, jse4, 4, 1, n_pad4, 2, 1, n_pad2)[0])
    # every real element of the server residual survives the round trip
    keep = min(n_pad2, n_pad4)
    np.testing.assert_array_equal(se2.reshape(-1)[:keep], se.reshape(-1)[:keep])
    # and OneBitAdam.elastic_adapt is the JAX one on the flat state
    opt = OneBitAdam(freeze_step=1, dp_size=4)
    jopt = JOneBitAdam(freeze_step=1, dp_size=4,
                       mesh=build_mesh(data=4, model=1, pipe=1, devices=jax.devices()[:4]))
    loaded = {"exp_avg": rng.normal(size=n_pad2).astype(np.float32),
              "exp_avg_sq": rng.random(n_pad2).astype(np.float32),
              "worker_error": we, "server_error": se}
    tmpl = {"exp_avg": np.empty(n_pad4), "exp_avg_sq": np.empty(n_pad4),
            "worker_error": np.empty((4, n_pad4)), "server_error": np.empty((4, n_pad4 // 4))}
    got, want = opt.elastic_adapt(loaded, tmpl), jopt.elastic_adapt(loaded, tmpl)
    for k in tmpl:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
