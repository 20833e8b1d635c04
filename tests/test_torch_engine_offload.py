"""ZeRO-Offload in the port's engine against the JAX engine's, on the CPU.

A 2-layer GPT-2 from the JAX init (``params_from_jax``) trains through the
port's ``initialize`` with ``zero_optimization.cpu_offload`` and through the
JAX ``DeepSpeedEngine`` with the same block on a single-device mesh, on the
same seeded micro-batches: float32 compute (bf16 parameters, as ZeRO needs)
agrees within 1e-5 in the losses over 5 steps for Adam and AdamW, with
clipping folded into the host step's grad scale, and the host masters as
``_assert_masters`` says; bf16 compute within 1e-2; two micro-batches a step
accumulate in float32; two param groups reach the host step. Each run's host
steps, replayed through the JAX package's ``DeepSpeedCPUAdam``, give its
master bit for bit. The fp16 overflow skips the host step.
Two gloo processes (dp = 2) hold the offload engine against the port's
device engine. LAMB, SGD and a client pair under offload raise as in JAX.
JAX is imported inside the tests, so the spawned workers import only torch.
"""

import functools
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import cpu_adam as ca
from deepspeed_tpu_torch.runtime.zero.sharding import unshard

from test_torch_engine import DIMS, _Quadratic, _batches, _config, _port_model, _port_params

STEPS = 5


def _offload_config(opt, gas=1, micro=2, dp=1, **zero):
    cfg = _config(opt, 2, gas=gas, micro=micro, dp=dp)
    cfg["zero_optimization"] = {"stage": 2, "cpu_offload": True, **zero}
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(compute):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=getattr(jnp, compute), loss_chunk=0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _jax_run(cfg, compute="float32", steps=STEPS):
    """(losses, host master by port name) of the JAX engine."""
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.models.gpt2 import params_from_jax
    jm, jp = _jax_model(compute)
    eng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                          config_params=cfg)
    assert eng._offload is not None
    losses = []
    for tokens, labels in _batches(steps * cfg["gradient_accumulation_steps"]):
        loss = eng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    master = {k: v.numpy() for k, v in params_from_jax(eng.master_params, device="cpu").items()}
    return np.asarray(losses), master, eng


def _port_engine(cfg, compute=torch.float32, params=None):
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    params = _port_params() if params is None else params
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=compute, loss_chunk=0), device="cpu")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters={k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        config_params=cfg, device="cpu")
    return eng


def _port_run(cfg, compute=torch.float32, steps=STEPS):
    """(losses, host master by name, engine, replay): ``replay()`` runs the
    engine's host steps again through the JAX package's DeepSpeedCPUAdam."""
    eng = _port_engine(cfg, compute)
    replay = _recorder(eng)
    losses = []
    for tokens, labels in _batches(steps * cfg["gradient_accumulation_steps"]):
        loss = eng(tokens, labels)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
    return (np.asarray(losses), {k: v.numpy().copy() for k, v in eng.master_params.items()},
            eng, replay)


def _recorder(eng):
    """Keep every host step's inputs (the grads as the card holds them, the
    step, the hypers and the folded grad scale); the returned function
    replays them through the JAX package's DeepSpeedCPUAdam from the same
    initial master and returns its master by name."""
    names = list(eng._names)
    master0 = {k: v.numpy().copy() for k, v in eng.master_params.items()}
    adamw = eng._offload.adamw
    calls = []
    inner = eng._offload.step_regions

    def step_regions(handles, step, **kw):
        grads = {names[it.region.leaf]: it.grad.float().numpy().copy() for it in handles}
        calls.append((step, grads, {k: v for k, v in kw.items() if k != "out"}))
        return inner(handles, step, **kw)

    eng._offload.step_regions = step_regions

    def replay():
        from deepspeed_tpu.ops.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
        opt = JaxCPUAdam(master0, adamw=adamw, pipeline=False)
        assert opt._lib is not None
        order = sorted(names)   # jax.tree_util's leaf order
        for step, grads, kw in calls:
            kw = dict(kw)
            lh = kw.pop("leaf_hypers")
            if lh is not None:
                lh = [lh[names.index(n)] for n in order]
            opt.step_regions(opt.begin_grad_fetch({n: grads[n].reshape(master0[n].shape)
                                                   for n in order}),
                             step, leaf_hypers=lh, **kw)
        return opt.params_tree()

    return replay


def _assert_masters(mine, theirs, atol, replay):
    """The host steps replay bit for bit through the JAX package's CPU Adam.
    Against the JAX engine's trajectory: within 10 x ``atol`` everywhere and
    within ``atol`` at 95% of the elements or more. The frameworks sum the
    float32 grads in other orders, so a rare grad rounds to the other bf16
    neighbour, and Adam's normalised update turns that into up to 6e-5 (float32
    compute, 5 steps; the port's device engine against the JAX device engine
    reads 8.5e-5). The key biases (the middle third of ``c_attn_b``) are left
    out: softmax makes their gradient zero, so it is rounding noise whose sign
    Adam turns into a step of either direction (7.6e-3 under L2 Adam, both
    engines alike, offload or not)."""
    replayed = replay()
    for k in mine:
        np.testing.assert_array_equal(mine[k], replayed[k], err_msg=k)
    assert set(mine) == set(theirs)
    e = DIMS["n_embd"]
    diffs = []
    for k in mine:
        d = np.abs(mine[k] - theirs[k])
        if k.endswith("c_attn_b"):
            d = np.concatenate([d[:e], d[2 * e:]])
        diffs.append(d.ravel())
    d = np.concatenate(diffs)
    assert d.max() <= 10 * atol, d.max()
    assert np.mean(d <= atol) >= 0.95, np.mean(d <= atol)


@pytest.mark.parametrize("opt", ["AdamW", "Adam"])
def test_offload_trajectory_matches_jax_engine(opt):
    """float32 compute: the same grads (bf16, ZeRO-2), the same host kernel,
    so only the frameworks' summation order differs."""
    cfg = _offload_config(opt)
    want, want_master, _ = _jax_run(cfg)
    got, got_master, eng, replay = _port_run(cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    _assert_masters(got_master, want_master, 1e-5, replay)
    assert eng.global_steps == STEPS and eng.skipped_steps == 0
    assert eng._grad_dtype == torch.bfloat16 and eng._acc_dtype == torch.bfloat16
    # the master lives in the host buffer: the views alias it
    leaf = eng.master_params["wte"]
    assert leaf.device.type == "cpu"
    assert leaf.untyped_storage().data_ptr() == eng._offload.fp32.untyped_storage().data_ptr()
    m = eng.opt_state.exp_avg[0]
    assert m.untyped_storage().data_ptr() == eng._offload.exp_avg.untyped_storage().data_ptr()
    # the compute params are the bf16 cast of the host master
    for n, p in eng.module.named_parameters():
        assert torch.equal(p.detach(), eng.master_params[n].to(torch.bfloat16)), n


def test_offload_bf16_matches_jax_engine():
    cfg = _offload_config("AdamW")
    want, want_master, _ = _jax_run(cfg, compute="bfloat16")
    got, got_master, _, replay = _port_run(cfg, compute=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)
    _assert_masters(got_master, want_master, 1e-2, replay)


def test_offload_accumulates_in_float32():
    """Two micro-batches a step: the accumulator is float32 (the host kernel
    reads float32 grads), as the JAX engine's (tests/unit/test_cpu_adam.py:416)."""
    cfg = _offload_config("AdamW", gas=2)
    want, want_master, _ = _jax_run(cfg, steps=3)
    got, got_master, eng, replay = _port_run(cfg, steps=3)
    assert eng._acc_dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    _assert_masters(got_master, want_master, 1e-5, replay)
    assert eng.global_steps == 3


def test_offload_param_groups_match_jax_engine():
    """Biases and LayerNorm parameters in a group without weight decay and
    with their own lr (tests/unit/test_param_groups.py:65-72): the host step
    takes per-leaf hypers."""
    cfg = _offload_config("AdamW")
    cfg["optimizer"]["params"] = dict(cfg["optimizer"]["params"], param_groups=[
        {"pattern": "(_b|bias|scale)$", "weight_decay": 0.0, "lr": 5e-3}])
    want, want_master, _ = _jax_run(cfg)
    got, got_master, eng, replay = _port_run(cfg)
    assert len(eng.optimizer.param_groups) == 2 and sum(eng._groups) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    _assert_masters(got_master, want_master, 1e-5, replay)


def test_offload_fp16_overflow_skips_the_host_step():
    """A scale of 2**20 overflows the fp16 backward: the host master stays
    as it was and the scale backs off, until a step goes through
    (tests/unit/test_cpu_adam.py:197)."""
    cfg = {"train_batch_size": 1, "fp16": {"enabled": True, "initial_scale_power": 20,
                                           "hysteresis": 1, "loss_scale_window": 1000},
           "optimizer": {"type": "Adam", "params": {"lr": 0.1}},
           "zero_optimization": {"stage": 2, "cpu_offload": True}}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=_Quadratic(), config_params=cfg,
                                                  device="cpu")
    x = torch.ones(1, 4)
    master0 = eng._offload.fp32.clone()
    s0 = eng.loss_scale()
    eng.backward(eng(x))
    eng.step()
    assert eng.skipped_steps == 1 and eng.loss_scale() == s0 / 2
    assert torch.equal(eng._offload.fp32, master0)
    assert torch.isfinite(eng._offload.fp32).all()
    for _ in range(12):
        eng.backward(eng(x))
        eng.step()
    assert eng.skipped_steps < 13
    assert not torch.equal(eng._offload.fp32, master0)
    assert torch.isfinite(eng._offload.fp32).all()
    assert eng.module.w.dtype == torch.float16
    assert torch.equal(eng.module.w.detach(), eng.master_params["w"].to(torch.float16))


@pytest.mark.parametrize("kind", ["Lamb", "SGD", "client"])
def test_offload_refuses_what_jax_refuses(kind):
    """Only Adam and AdamW run on the host tier; the JAX engine asserts the
    same (deepspeed_tpu/runtime/engine.py:861-865)."""
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.ops import adam as adam_opt
    from deepspeed_tpu.ops import adam as jax_adam
    opt = "AdamW" if kind == "client" else kind
    cfg = _offload_config(opt)
    jm, jp = _jax_model("float32")
    client = (adam_opt.init, adam_opt.apply) if kind == "client" else None
    with pytest.raises(AssertionError, match="ZeRO-Offload"):
        DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                        config_params=cfg,
                        optimizer=(jax_adam.init, jax_adam.apply) if client else None)
    with pytest.raises(AssertionError, match="ZeRO-Offload"):
        deepspeed_tpu_torch.initialize(model=_port_model(_port_params())[0], optimizer=client,
                                       config_params=cfg, device="cpu")


def test_offload_knobs_timing_and_refusals(tmp_path):
    """The offload_optimizer block acts; offload_step_timing reports the
    last step's lanes; a checkpoint saved under the knobs loads back into
    the serial engine (tests/test_torch_checkpointing.py covers the rest)."""
    cfg = _offload_config("AdamW", offload_optimizer={
        "pipeline": True, "pipeline_depth": 3, "max_region_elements": 256})
    eng = _port_engine(cfg)
    assert eng.offload_step_timing() is None
    off = eng._offload
    assert off.pipeline_depth == 3 and off.region_cap() == 256
    tokens, labels = _batches(1)[0]
    eng.backward(eng(tokens, labels))
    eng.step()
    t = eng.offload_step_timing()
    assert t["pipeline_depth"] == 3 and t["region_cap"] == 256
    assert t["n_work_items"] == sum(-(-int(np.prod(m.shape)) // 256)
                                    for m in eng.master_params.values())
    assert len(t["regions"]) == len(eng.master_params)
    serial = _port_engine(_offload_config("AdamW", offload_optimizer={"pipeline": False}))
    assert serial._offload.region_cap() is None
    serial.backward(serial(tokens, labels))
    serial.step()
    assert serial.offload_step_timing()["n_work_items"] == len(serial.master_params)
    for p, q in zip(eng.module.parameters(), serial.module.parameters()):
        assert torch.equal(p, q)
    eng.save_checkpoint(str(tmp_path))
    path, _ = serial.load_checkpoint(str(tmp_path))
    assert path is not None and serial.global_steps == 1
    for name in ("fp32", "exp_avg", "exp_avg_sq"):
        assert torch.equal(getattr(serial._offload, name), getattr(eng._offload, name))


def test_offload_failed_native_build_raises(tmp_path, monkeypatch):
    (tmp_path / "cpu_adam.cpp").write_text("int main( {\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build cpu_adam.cpp"):
        _port_engine(_offload_config("AdamW"))


def test_offload_host_step_runs_the_native_kernel():
    """Each work item of the walk is one launch of the native kernel."""
    eng = _port_engine(_offload_config("AdamW", offload_optimizer={"max_region_elements": 300}))
    before = ca.adam_step_native.launches
    for tokens, labels in _batches(2):
        eng.backward(eng(tokens, labels))
        eng.step()
    assert ca.adam_step_native.launches - before == 2 * eng.offload_step_timing()["n_work_items"]


# ------------------------------------------------------------------ dp = 2
# the same row on both ranks keeps the mean over ranks exact (test_torch_engine's
# "same" mode); the host and device Adam order their float32 operations
# differently, which the bf16 params carry into the losses: the JAX test's
# tolerances (tests/unit/test_cpu_adam.py:262-272)

def _dp_worker(rank, port, params, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        for offload in (True, False):
            cfg = _config("AdamW", 2, micro=1, dp=2)
            cfg["zero_optimization"]["cpu_offload"] = offload
            tm, ps = _port_model(params)
            eng, _, _, _ = deepspeed_tpu_torch.initialize(
                model=tm, model_parameters=ps, device="cpu", dist_init_required=False,
                config_params=cfg)
            losses = []
            for tokens, labels in _batches(3 * cfg["gradient_accumulation_steps"]):
                loss = eng(tokens[:1], labels[:1])
                eng.backward(loss)
                eng.step()
                losses.append(float(loss.detach()))
            full = {n: unshard(m.contiguous(), a, 2).numpy()
                    for (n, m), a in zip(eng.master_params.items(), eng._axes)}
            sizes = np.asarray([m.numel() for m in eng.master_params.values()])
            np.savez(os.path.join(out_dir, f"{int(offload)}_{rank}.npz"),
                     losses=np.asarray(losses), sizes=sizes,
                     **{f"full/{n}": v for n, v in full.items()})
    finally:
        dist.destroy_process_group()


def test_offload_dp2_over_gloo_matches_device_engine():
    params = _port_params()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_dp_worker, args=(port, params, out_dir), nprocs=2,
                           start_method="spawn", join=True)
        res = {(o, r): np.load(os.path.join(out_dir, f"{o}_{r}.npz"))
               for o in (0, 1) for r in (0, 1)}
        for r in (0, 1):
            host, dev = res[1, r], res[0, r]
            np.testing.assert_allclose(host["losses"], dev["losses"], rtol=1e-3, atol=0)
            # each rank's host buffer holds its ZeRO slices: half of every sharded leaf
            np.testing.assert_array_equal(host["sizes"], dev["sizes"])
            assert host["sizes"].sum() < sum(int(np.prod(v.shape)) for v in params.values())
            for k in (f for f in host.files if f.startswith("full/")):
                np.testing.assert_allclose(host[k], dev[k], rtol=1e-2, atol=1e-4, err_msg=k)
                np.testing.assert_array_equal(host[k], res[1, 1 - r][k])
