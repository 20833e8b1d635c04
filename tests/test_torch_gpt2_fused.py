"""GPT-2 with the fused transformer block in the PyTorch port against the JAX package.

tests/unit/test_fused_block.py's model (vocab 97, T 64, width 32, 4 heads,
2 layers, float32, ``fused_block=True``) is initialized by the JAX package
and carried into the port with ``params_from_jax``. The port's logits
(1e-5), loss (1e-5) and every gradient (1e-3 relative + 1e-5, that file's
bound) equal the JAX fused model's: its Pallas kernel runs in interpret
mode, the port's wrapper on its plain version on the CPU, and both backward
passes differentiate their ``fused_block_reference``. A 3-step ZeRO-2 loss
trajectory through ``initialize`` equals the JAX engine's within 1e-5
relative. The guards raise as the JAX model's assert; a width the CUDA-core
kernels refuse computes on the CPU as the JAX model does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_block as fb
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

V, T, E, NH = 97, 64, 32, 4
DIMS = dict(vocab_size=V, n_positions=T, n_embd=E, n_head=NH)


def _models(n_layer=2, fused=True, **over):
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, n_layer=n_layer, compute_dtype=jnp.float32,
                                    fused_block=fused, **over))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPT2Model(GPT2Config(**DIMS, n_layer=n_layer, compute_dtype=torch.float32,
                              fused_block=fused, **over), device="cpu")
    tm.load_parameters(params_from_jax(jp, device="cpu"))
    return jm, jp, tm


def _batch(B=2, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, size=(B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    return tokens, labels


def test_logits_match_jax_fused_model():
    jm, jp, tm = _models(loss_chunk=0)
    tokens, _ = _batch()
    want = np.asarray(jm.logits(jp, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, T, V)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_loss_and_grads_match_jax_fused_model(loss_chunk):
    jm, jp, tm = _models(loss_chunk=loss_chunk)
    tokens, labels = _batch(seed=2)
    jloss, jgrads = jax.value_and_grad(jm.apply)(jp, jnp.asarray(tokens), jnp.asarray(labels))
    fb.fused_transformer_block.launches = 0
    loss = tm(torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    assert fb.fused_transformer_block.launches == 0    # CPU: the plain version


def test_fused_model_matches_its_unfused_model():
    """The fused forward differs from the unfused one only in where it
    rounds: in float32 the logits agree to summation order."""
    _, jp, fused = _models()
    plain = GPT2Model(GPT2Config(**DIMS, n_layer=2, compute_dtype=torch.float32), device="cpu")
    plain.load_parameters(params_from_jax(jp, device="cpu"))
    tokens = torch.from_numpy(_batch(seed=3)[0])
    torch.testing.assert_close(fused(tokens), plain(tokens), rtol=0, atol=1e-5)


def test_fused_takes_precedence_over_flash():
    _, jp, fused = _models()
    both = GPT2Model(GPT2Config(**DIMS, n_layer=2, compute_dtype=torch.float32,
                                fused_block=True, use_flash_attention=True), device="cpu")
    both.load_parameters(params_from_jax(jp, device="cpu"))
    tokens = torch.from_numpy(_batch(seed=4)[0])
    calls = []
    wrapped = fa._attend
    fa._attend = lambda *a, **k: calls.append(1) or wrapped(*a, **k)
    try:
        out = both(tokens)
    finally:
        fa._attend = wrapped
    assert not calls
    torch.testing.assert_close(out, fused(tokens), rtol=0, atol=0)


def _config():
    return {"train_batch_size": 2, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            # ZeRO needs a low-precision policy: bf16 parameters (the model
            # still computes in float32)
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 2}}


def test_zero2_trajectory_matches_jax_engine():
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp, tm = _models(n_layer=1, loss_chunk=0)
    batches = [_batch(seed=s) for s in range(3)]
    jeng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=_config())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, config_params=_config(),
                                                   device="cpu")
    want, got = [], []
    for tokens, labels in batches:
        loss = jeng(tokens, labels)
        jeng.backward(loss)
        jeng.step()
        want.append(float(loss))
        loss = teng(torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
        teng.backward(loss)
        teng.step()
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] != got[0] and teng.global_steps == 3


def test_guards_raise():
    with pytest.raises(ValueError, match="fused_block has no in-kernel dropout"):
        GPT2Model(GPT2Config(**DIMS, n_layer=1, dropout=0.1, fused_block=True), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        GPT2Model(GPT2Config(**DIMS, n_layer=1, fused_block=True,
                             sparse_attention=FixedSparsityConfig(num_heads=NH, block=16)),
                  device="cpu")
    # a width past the CUDA-core kernels' limit (float32 at E 1024) computes
    # on the CPU, as the JAX fused model does
    wide = dict(vocab_size=V, n_positions=8, n_embd=1024, n_head=16, n_layer=1,
                fused_block=True)
    jm = JaxGPT2Model(JaxGPT2Config(**wide, compute_dtype=jnp.float32))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPT2Model(GPT2Config(**wide, compute_dtype=torch.float32), device="cpu")
    tm.load_parameters(params_from_jax(jp, device="cpu"))
    tokens = np.arange(8, dtype=np.int32)[None] % V
    want = np.asarray(jm.logits(jp, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
