"""The port's CIFAR ResNet (``deepspeed_tpu_torch/models/resnet.py``) against
the JAX package's on the same weights and inputs: logits and grads in
float32 (tolerance 1e-5), and training through ``initialize`` with the
docs/cifar.md config (Adam, OneCycle) at ZeRO 0 (float32, losses within
1e-4 relative of the JAX engine's over 4 steps) and ZeRO 2 (bf16, losses
falling, within 2e-2 of the JAX engine's). The images are seeded synthetic
CIFAR-shaped batches (NHWC, 10 classes), as ``tests/unit/test_resnet.py``
makes them; the repository holds no CIFAR-10 data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.resnet import ResNet as JResNet, ResNetConfig as JConfig
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.models.resnet import ResNet, ResNetConfig, params_from_jax

SMALL = dict(width=8, stage_sizes=(1, 1), groups=4)


def _data(batch=8, size=32, classes=10, seed=0):
    """Learnable synthetic CIFAR: class k images have channel means biased by k."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, (batch,)).astype(np.int32)
    images = rng.normal(size=(batch, size, size, 3)).astype(np.float32) * 0.3
    images += (labels[:, None, None, None] / classes - 0.5) * 2.0
    return images, labels


def _pair(seed=0, **over):
    kw = dict(SMALL, **over)
    jm = JResNet(JConfig(**kw))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    tm = ResNet(ResNetConfig(**kw), device="cpu")
    tm.load_parameters(params_from_jax(params, device="cpu"))
    return jm, params, tm


def test_logits_and_grads_equal_jax():
    jm, params, tm = _pair()
    images, labels = _data(batch=4)
    jl = np.asarray(jm.logits(params, jnp.asarray(images)))
    tl = tm.logits(torch.from_numpy(images)).detach().numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    jloss, jgrads = jax.value_and_grad(jm.apply)(params, jnp.asarray(images),
                                                 jnp.asarray(labels))
    loss = tm(torch.from_numpy(images), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.device_get(jgrads), device="cpu")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_same_padding_and_shapes():
    """XLA's SAME padding of the stride-2 convolutions (one row and column on
    the high side) and the global pool: (2, 10) logits from 32x32 and 17x17
    images, equal to JAX's on odd sizes too."""
    jm, params, tm = _pair(stage_sizes=(1, 1, 1))
    for size in (32, 17):
        x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
        tl = tm.logits(torch.from_numpy(x)).detach().numpy()
        assert tl.shape == (2, 10)
        np.testing.assert_allclose(tl, np.asarray(jm.logits(params, jnp.asarray(x))),
                                   rtol=0, atol=1e-5)
    assert tm.param_count() == sum(int(np.prod(v.shape))
                                   for v in jax.tree_util.tree_leaves(params))


def _config(stage, bf16):
    return {"train_batch_size": 8, "steps_per_print": 100,
            "bf16": {"enabled": bf16},
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "scheduler": {"type": "OneCycle", "params": {
                "cycle_min_lr": 1e-3, "cycle_max_lr": 3e-3, "cycle_first_step_size": 2}},
            "zero_optimization": {"stage": stage}}


@pytest.mark.parametrize("stage,bf16,tol", [(0, False, 1e-4), (2, True, 2e-2)],
                         ids=["zero0-f32", "zero2-bf16"])
def test_cifar_training_through_initialize(stage, bf16, tol):
    jm, params, tm = _pair()
    images, labels = _data()
    jeng = DeepSpeedEngine(model=jm, model_parameters=params,
                           mesh=build_mesh(data=1, model=1, pipe=1,
                                           devices=jax.devices()[:1]),
                           config_params=_config(stage, bf16))
    eng, _, _, sched = deepspeed_tpu_torch.initialize(model=tm, config_params=_config(stage, bf16),
                                                      device="cpu")
    assert sched is not None
    ours, theirs = [], []
    for _ in range(4):
        loss = eng(images, labels)
        eng.backward(loss)
        eng.step()
        ours.append(float(loss.detach()))
        jl = jeng(images, labels)
        jeng.backward(jl)
        jeng.step()
        theirs.append(float(jax.device_get(jl)))
    assert all(np.isfinite(ours)) and ours[-1] < ours[0], ours
    np.testing.assert_allclose(ours, theirs, rtol=tol, atol=0)
    assert eng.get_lr() == [float(g["lr"]) for g in jeng.optimizer.param_groups]
