"""The fused step of the PyTorch port's engine against the JAX engine's, on
the CPU (``tests/unit/test_engine.py:285-374``).

The tiny GPT-2 of ``tests/test_torch_engine.py`` (float32 compute; bf16
parameters at ZeRO 1-2, float32 at ZeRO 0 unless bf16 is asked for) trains
on the same seeded micro-batches:
- the rotation contract: at gas 1 a standard engine with ``fused_step`` and
  an external-master pair with no key run the update in ``forward()``, and
  a second ``forward()`` before ``step()`` raises as the JAX engine does; at
  gas 2 both stay unfused;
- fused against two-step over Adam, AdamW, LAMB and SGD, clipping 0 and 1,
  float32 and bf16, ZeRO 0-2: losses, reported norms and master bit for bit
  within the port (one update body); at ZeRO 0 the losses within 1e-5
  relative of the JAX engine's ``fused_step`` (bf16 parameters) or two-jit
  step (float32, where its fused step cannot run);
- fp16 with an overflow skip: the scale, the skipped steps and the master
  through the skips equal the two-step path's bit for bit and the JAX
  engine's fused step's; the losses within 1e-5 relative of JAX's;
- the fused step under every remat policy against the two-step path bit
  for bit; no grad left on a parameter after ``forward()``;
- eval mode, a user's backward outside the engine, ``zero_grad``
  mid-window, ``save_checkpoint`` between ``forward()`` and ``step()``, a
  resilience save at commit, the ineligibility warnings;
- two gloo processes (dp = 2): ZeRO-2 with LAMB, fused against the
  two-step path bit for bit.
JAX is imported inside the tests, so the spawned workers import only torch.
"""

import functools
import logging
import os
import socket
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act_ckpt
from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer
from deepspeed_tpu_torch.runtime.zero.sharding import unshard
from deepspeed_tpu_torch.utils import logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from test_torch_activation_checkpointing import POLICIES  # noqa: E402
from test_torch_engine import DIMS, _batches, _config, _jax_params, _port_params  # noqa: E402

STEPS = 3
CASES = [(0, False), (0, True), (1, True), (2, True)]   # (ZeRO stage, bf16)


def _cfg(opt, stage=0, bf16=False, clip=0.0, fused=True, gas=1, **extra):
    cfg = _config(opt, stage, gas=gas)
    cfg.update(gradient_clipping=clip, bf16={"enabled": bf16}, fused_step=fused, **extra)
    return cfg


def _model(**over):
    params = _port_params()
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, loss_chunk=0, **over),
                   device="cpu")
    return tm, {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _engine(cfg, model=None, optimizer=None, **over):
    tm, params = model if model is not None else _model(**over)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, model_parameters=params,
                                                  config_params=cfg, optimizer=optimizer,
                                                  device="cpu")
    return eng


def _train(eng, steps=STEPS):
    """(losses, reported norms, loss scales) of ``steps`` steps."""
    losses, norms, scales = [], [], []
    for tokens, labels in _batches(steps * eng.gradient_accumulation_steps()):
        loss = eng(tokens, labels)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss.detach()))
        if eng.is_gradient_accumulation_boundary():
            norms.append(float(eng._last_grad_norm))
            scales.append(eng.loss_scale())
    return losses, norms, scales


def _masters(eng):
    return [m.clone() for m in eng._master]


def _jax_engine(cfg, optimizer=None):
    import copy
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp = _jax_params()
    return DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           optimizer=optimizer, config_params=copy.deepcopy(cfg))


def _jax_train(eng, steps=STEPS):
    import jax
    losses, scales = [], []
    for tokens, labels in _batches(steps):
        loss = eng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
        scales.append(float(eng.loss_scale()))
    return losses, scales, jax.device_get(eng.master_params)


@functools.lru_cache(maxsize=None)
def _jax_losses(opt, clip, bf16):
    """The JAX engine's losses at ZeRO 0: its fused step with bf16
    parameters; with float32 ones its two-jit step, as its fused step
    donates the params' buffer twice there (params and master are one
    float32 array; ROADMAP.md section C)."""
    eng = _jax_engine(_cfg(opt, bf16=bf16, clip=clip, fused=bf16))
    assert (eng._run_fused_step is not None) == bf16
    return _jax_train(eng)[0]


# ------------------------------------------------------------------ rotation
def test_rotation_contract_standard_and_external_master():
    """gas 1: the update at forward(), a second forward() raises ("rotation")
    in both packages; after backward() and step() the next forward() runs."""
    import bench
    tokens, labels = _batches(1)[0]
    cases = [(_cfg("AdamW", bf16=True), None, None),
             (dict(_cfg("AdamW", fused=False), zero_allow_untested_optimizer=True),
              shard_optimizer(32), bench._shard_optimizer(32))]
    for cfg, pair, jax_pair in cases:
        eng = _engine(cfg, optimizer=pair)
        jeng = _jax_engine(cfg, optimizer=jax_pair)
        assert eng._fused and jeng._run_fused_step is not None
        loss = eng(tokens, labels)
        assert not loss.requires_grad
        jeng(tokens.astype(np.int32), labels.astype(np.int32))
        with pytest.raises(RuntimeError, match="rotation"):
            eng(tokens, labels)
        with pytest.raises(RuntimeError, match="rotation"):
            jeng(tokens.astype(np.int32), labels.astype(np.int32))
        eng.backward(loss)
        eng.step()
        assert eng.global_steps == 1
        eng.backward(eng(tokens, labels))
        eng.step()
        assert eng.global_steps == 2


def test_gas2_stays_unfused():
    """test_engine.py:298-311: an external-master pair at gas 2 accumulates
    through the two-step path; so does fused_step at gas 2."""
    import bench
    cfg = dict(_cfg("AdamW", fused=False, gas=2), zero_allow_untested_optimizer=True)
    eng = _engine(cfg, optimizer=shard_optimizer(32))
    jeng = _jax_engine(cfg, optimizer=bench._shard_optimizer(32))
    assert not eng._fused and jeng._run_fused_step is None
    shard0 = eng.opt_state["shard"].clone()
    for tokens, labels in _batches(2):
        eng(tokens, labels)
        eng(tokens, labels)      # no rotation rule on the two-step path
        eng.backward(eng(tokens, labels))
        eng.step()
    assert eng.global_steps == 1 and not torch.equal(eng.opt_state["shard"], shard0)
    assert not _engine(_cfg("AdamW", gas=2))._fused


# --------------------------------------------------- fused against two-step
@pytest.mark.parametrize("stage,bf16", CASES, ids=[f"z{s}-{'bf16' if b else 'f32'}"
                                                   for s, b in CASES])
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["clip0", "clip1"])
@pytest.mark.parametrize("opt", ["Adam", "AdamW", "Lamb", "SGD"])
def test_fused_matches_two_step_and_jax(opt, clip, stage, bf16):
    two = _engine(_cfg(opt, stage, bf16, clip, fused=False))
    fused = _engine(_cfg(opt, stage, bf16, clip))
    assert not two._fused and fused._fused
    want, want_norms, _ = _train(two)
    got, got_norms, _ = _train(fused)
    assert got == want and got_norms == want_norms
    for a, b in zip(_masters(fused), _masters(two)):
        assert torch.equal(a, b)
    assert fused.global_steps == STEPS and fused._fused_pending is None
    if stage == 0:
        np.testing.assert_allclose(got, _jax_losses(opt, clip, bf16), rtol=1e-5, atol=0)


def test_fp16_overflow_skip_matches_two_step_and_jax():
    """fp16 at 2**20: the first steps overflow. Each skip halves the scale
    (hysteresis 1), counts, and leaves the master as it was."""
    cfg = dict(_cfg("AdamW", fp16={"enabled": True, "initial_scale_power": 20,
                                   "hysteresis": 1}), bf16={"enabled": False})
    runs = {}
    for fused in (False, True):
        eng = _engine(dict(cfg, fused_step=fused))
        assert eng._fused == fused
        masters, skips, losses, scales = [_masters(eng)], [], [], []
        for tokens, labels in _batches(6):
            loss = eng(tokens, labels)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss.detach()))
            scales.append(eng.loss_scale())
            skips.append(eng.skipped_steps)
            masters.append(_masters(eng))
        runs[fused] = losses, scales, skips, masters
    assert runs[True][:3] == runs[False][:3]
    for a, b in zip(runs[True][3], runs[False][3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    losses, scales, skips, masters = runs[True]
    assert 0 < skips[-1] < 6 and scales[0] == 2.0 ** 19
    for k in range(6):
        skipped = skips[k] > (skips[k - 1] if k else 0)
        same = all(torch.equal(x, y) for x, y in zip(masters[k], masters[k + 1]))
        assert same == skipped
    jeng = _jax_engine(cfg)
    assert jeng._run_fused_step is not None
    jl, js, _ = _jax_train(jeng, 6)
    assert js == scales and jeng.skipped_steps == skips[-1]
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=0)


# --------------------------------------------------------------------- remat
@pytest.fixture
def act_ckpt_reset():
    """Both packages' activation-checkpointing configs are process-global:
    an engine whose config carries the block configures them."""
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jax_act_ckpt
    act_ckpt.reset()
    jax_act_ckpt.reset()
    yield
    act_ckpt.reset()
    jax_act_ckpt.reset()


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: str(p))
def test_fused_under_remat_policies(policy, act_ckpt_reset):
    """The backward with every policy's recompute runs inside forward(), the
    tied wte (the embedding and the head) updated once: the same bits as
    the two-step path."""
    two = _engine(_cfg("AdamW", 2, True, fused=False), remat=True, remat_policy=policy)
    fused = _engine(_cfg("AdamW", 2, True), remat=True, remat_policy=policy)
    want, want_norms, _ = _train(two)
    got, got_norms, _ = _train(fused)
    assert got == want and got_norms == want_norms
    assert all(torch.equal(a, b) for a, b in zip(_masters(fused), _masters(two)))


def test_fused_forward_leaves_no_grads():
    """forward() consumes the grads: none is left on a parameter, the loss
    holds no graph, and backward() only marks the window."""
    eng = _engine(_cfg("AdamW"))
    tokens, labels = _batches(1)[0]
    loss = eng(tokens, labels)
    assert not loss.requires_grad and loss.grad_fn is None
    assert all(p.grad is None for p in eng._params)
    assert eng._fused_pending is not None and eng.global_steps == 0
    eng.backward(loss)
    assert all(p.grad is None for p in eng._params)
    eng.step()
    assert eng.global_steps == 1 and eng._fused_pending is None


def test_eval_forward_is_unfused():
    """In eval mode forward() runs no update and no rotation rule applies."""
    eng = _engine(_cfg("AdamW"))
    master0 = _masters(eng)
    tokens, labels = _batches(1)[0]
    eng.eval()
    a, b = eng(tokens, labels), eng(tokens, labels)
    assert torch.equal(a, b) and eng._fused_pending is None
    assert all(torch.equal(x, y) for x, y in zip(_masters(eng), master0))
    eng.train()
    eng.backward(eng(tokens, labels))
    eng.step()
    assert eng.global_steps == 1


def test_a_user_backward_does_not_step():
    """A backward outside the engine leaves the grads where autograd put
    them: no update."""
    eng = _engine(_cfg("AdamW"))
    master0, params0 = _masters(eng), [p.detach().clone() for p in eng._params]
    tokens, labels = _batches(1)[0]
    eng.module(torch.from_numpy(tokens), torch.from_numpy(labels)).backward()
    assert all(torch.equal(a, b) for a, b in zip(_masters(eng), master0))
    assert all(torch.equal(p.detach(), q) for p, q in zip(eng._params, params0))
    assert all(p.grad is not None for p in eng._params)
    assert eng.global_steps == 0 and eng._fused_pending is None


# -------------------------------------------------- window and checkpoints
def test_zero_grad_mid_window_matches_jax():
    """The update has run at forward(); zero_grad() drops only the
    bookkeeping: no step counted, no scheduler step, the next forward()
    runs."""
    from deepspeed_tpu.checkpoint.checkpointing import _flatten_with_paths
    for clip in (0.0, 1.0):
        cfg = _cfg("AdamW", bf16=True, clip=clip)
        eng, jeng = _engine(cfg), _jax_engine(cfg)
        master0 = _masters(eng)
        (t0, l0), (t1, l1) = _batches(2)
        eng(t0, l0)
        jeng(t0.astype(np.int32), l0.astype(np.int32))
        eng.zero_grad()
        jeng.zero_grad()
        assert not all(torch.equal(a, b) for a, b in zip(_masters(eng), master0))
        loss = eng(t1, l1)
        jloss = jeng(t1.astype(np.int32), l1.astype(np.int32))
        eng.backward(loss)
        eng.step()
        jeng.backward(jloss)
        jeng.step()
        assert eng.global_steps == jeng.global_steps == 1
        assert eng.get_lr() == [float(x) for x in jeng.get_lr()]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        # both updates applied: a fifth of one step at this lr (1e-3); the
        # bf16 params' grads are rounded by autograd and not by XLA, and
        # Adam turns a near-zero grad's rounding into a visible step
        # (measured 4.2e-5); a missing update is off by about 1e-3
        jm = _flatten_with_paths(jeng.master_params)
        for key, i in eng._ckpt_keys():
            np.testing.assert_allclose(eng._master[i].numpy(), np.asarray(jm[key]),
                                       rtol=0, atol=2e-4, err_msg=key)


def test_save_between_forward_and_step_sees_the_update(tmp_path):
    """A checkpoint between forward() and step() holds the updated state, as
    the JAX engine's does; it resumes to the uninterrupted trajectory."""
    cfg = _cfg("AdamW", 2, True)
    bs = _batches(2 * STEPS)
    eng = _engine(cfg)
    _train(eng, STEPS - 1)
    tokens, labels = bs[STEPS - 1]
    before = _masters(eng)
    loss = eng(tokens, labels)
    eng.save_checkpoint(str(tmp_path), tag="mid")
    eng.backward(loss)
    eng.step()
    after = _masters(eng)
    assert not all(torch.equal(a, b) for a, b in zip(before, after))
    again = _engine(cfg)
    again.load_checkpoint(str(tmp_path), tag="mid")
    assert all(torch.equal(a, b) for a, b in zip(_masters(again), after))
    assert again.global_steps == STEPS - 1


def test_resilience_save_at_commit(tmp_path):
    """The resilience block snapshots at step(), the committed state."""
    cfg = dict(_cfg("AdamW", 2, True), resilience={
        "enabled": True, "save_dir": str(tmp_path), "save_interval": 2,
        "async_save": False})
    eng = _engine(cfg)
    _train(eng, 2)
    want = _masters(eng)
    eng._resilience.wait()
    again = _engine(_cfg("AdamW", 2, True))
    again.load_checkpoint(str(tmp_path), tag="global_step2")
    assert again.global_steps == 2
    assert all(torch.equal(a, b) for a, b in zip(_masters(again), want))


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("why", ["gas2", "offload", "cpu_checkpointing"])
def test_ineligible_fused_step_warns_and_takes_two_steps(why, act_ckpt_reset):
    from deepspeed_tpu.utils import logger as jax_logger
    extra = {"gas2": dict(gas=2),
             "offload": dict(stage=2, bf16=True,
                             zero_optimization={"stage": 2, "cpu_offload": True}),
             "cpu_checkpointing": dict(activation_checkpointing={"cpu_checkpointing": True})}
    cfg = _cfg("AdamW", **extra[why])
    mine, theirs = _Capture(), _Capture()
    logger.addHandler(mine)
    jax_logger.addHandler(theirs)
    try:
        eng = _engine(cfg)
        jeng = _jax_engine(cfg)
    finally:
        logger.removeHandler(mine)
        jax_logger.removeHandler(theirs)
    assert not eng._fused and jeng._run_fused_step is None
    for lines in (mine.lines, theirs.lines):
        assert any("fused_step requested but ineligible" in s for s in lines), lines
    _train(eng, 1)
    assert eng.global_steps == 1


def test_cpu_checkpointing_after_construction_warns_once(act_ckpt_reset):
    eng = _engine(_cfg("AdamW"))
    assert eng._fused
    tokens, labels = _batches(1)[0]
    act_ckpt.configure(checkpoint_in_cpu=True)
    cap = _Capture()
    logger.addHandler(cap)
    try:
        _train(eng, 2)
        loss = eng(tokens, labels)       # the two-step path: a graph, no update yet
        assert loss.requires_grad and eng._fused_pending is None
        eng.backward(loss)
        eng.step()
    finally:
        logger.removeHandler(cap)
    assert sum("fused_step disabled" in s for s in cap.lines) == 1
    assert eng.global_steps == 3
    act_ckpt.reset()
    loss = eng(tokens, labels)
    assert not loss.requires_grad and eng._fused_pending is not None
    eng.backward(loss)
    eng.step()
    assert eng.global_steps == 4


# ------------------------------------------------------------------ dp = 2
def _dp_worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        for fused in (False, True):
            cfg = dict(_cfg("Lamb", 2, True, fused=fused), train_batch_size=2 * 2)
            eng = _engine(cfg)
            assert eng._fused == fused
            losses = []
            for tokens, labels in _batches(STEPS):
                loss = eng(tokens[rank:rank + 1], labels[rank:rank + 1])
                eng.backward(loss)
                eng.step()
                losses.append(float(loss.detach()))
            full = [unshard(m, a, 2).numpy() for m, a in zip(eng._master, eng._axes)]
            np.savez(os.path.join(out_dir, f"{int(fused)}_{rank}.npz"),
                     losses=np.asarray(losses), norm=float(eng._last_grad_norm),
                     **{f"m{i}": m for i, m in enumerate(full)})
    finally:
        dist.destroy_process_group()


def test_dp2_lamb_fused_over_gloo():
    """ZeRO-2's reduce-scatter and LAMB's sumsq all-reduce inside forward():
    the result is the two-step path's."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_dp_worker, args=(port, out_dir), nprocs=2,
                           start_method="spawn", join=True)
        for rank in (0, 1):
            two = np.load(os.path.join(out_dir, f"0_{rank}.npz"))
            fused = np.load(os.path.join(out_dir, f"1_{rank}.npz"))
            np.testing.assert_array_equal(fused["losses"], two["losses"])
            assert float(fused["norm"]) == float(two["norm"])
            for k in two.files:
                if k.startswith("m"):
                    np.testing.assert_array_equal(fused[k], two[k], err_msg=k)
