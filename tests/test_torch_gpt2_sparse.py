"""GPT-2 with block-sparse attention in the PyTorch port against the JAX package.

tests/unit/test_gpt2_sparse.py's model (vocab 97, T 64, width 32, 2 heads,
2 layers, a unidirectional Fixed layout at block 16), float32, is
initialized by the JAX package and carried into the port with
``params_from_jax``. The port's loss and every gradient equal the JAX
model's (its Pallas kernel in interpret mode, the port's wrapper on its
plain version on the CPU) within 1e-5, float32 summing in other orders; a
3-step ZeRO-2 loss trajectory through ``initialize`` equals the JAX engine's
within 1e-5 relative. The guards raise as the JAX model's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JaxGPT2Model
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JaxFixed
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model, params_from_jax
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

V, T, E, NH, BLOCK = 97, 64, 32, 2, 16
DIMS = dict(vocab_size=V, n_positions=T, n_embd=E, n_head=NH)
SPARSE = dict(num_heads=NH, block=BLOCK, num_local_blocks=2, num_global_blocks=1,
              attention="unidirectional")


def _models(n_layer=2, **over):
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, n_layer=n_layer, compute_dtype=jnp.float32,
                                    sparse_attention=JaxFixed(**SPARSE), **over))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPT2Model(GPT2Config(**DIMS, n_layer=n_layer, compute_dtype=torch.float32,
                              sparse_attention=FixedSparsityConfig(**SPARSE), **over),
                   device="cpu")
    tm.load_parameters(params_from_jax(jp, device="cpu"))
    return jm, jp, tm


def _batch(B=2, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, size=(B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    return tokens, labels


def test_loss_and_grads_match_jax():
    jm, jp, tm = _models(loss_chunk=16)
    tokens, labels = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.apply))(jp, jnp.asarray(tokens),
                                                         jnp.asarray(labels))
    bsa.block_sparse_fwd.launches = 0
    loss = tm(torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert bsa.block_sparse_fwd.launches == 0     # CPU: the plain version
    assert set(tm._sparse_layouts) == {T}


def test_sparse_takes_precedence_over_flash():
    """As in the JAX model: with both set, the sparse branch runs."""
    _, jp, sparse = _models()
    both = GPT2Model(GPT2Config(**DIMS, n_layer=2, compute_dtype=torch.float32,
                                use_flash_attention=True,
                                sparse_attention=FixedSparsityConfig(**SPARSE)), device="cpu")
    both.load_parameters(params_from_jax(jp, device="cpu"))
    tokens = torch.from_numpy(_batch(seed=2)[0])
    torch.testing.assert_close(both(tokens), sparse(tokens), rtol=0, atol=0)


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
    sparse = FixedSparsityConfig(**SPARSE)
    with pytest.raises(ValueError, match="dropout"):
        GPT2Model(GPT2Config(**DIMS, n_layer=1, dropout=0.1, sparse_attention=sparse),
                  device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        GPT2Model(GPT2Config(**DIMS, n_layer=1, fused_block=True, sparse_attention=sparse),
                  device="cpu")
    with pytest.raises(ValueError, match="fused_block has no in-kernel dropout"):
        GPT2Model(GPT2Config(**DIMS, n_layer=1, dropout=0.1, fused_block=True), device="cpu")
    wrong_heads = GPT2Model(GPT2Config(**DIMS, n_layer=1, compute_dtype=torch.float32,
                                       sparse_attention=FixedSparsityConfig(
                                           **dict(SPARSE, num_heads=NH + 1))), device="cpu")
    with pytest.raises(ValueError, match=f"num_heads={NH}"):
        wrong_heads(torch.zeros(1, T, dtype=torch.long))


def test_serving_refuses_a_sparse_model():
    from deepspeed_tpu_torch.serve.engine import InferenceEngine
    model = GPT2Model(GPT2Config(**DIMS, n_layer=1, compute_dtype=torch.float32,
                                 sparse_attention=FixedSparsityConfig(**SPARSE)), device="cpu")
    with pytest.raises(ValueError, match="dense attention only"):
        InferenceEngine(model, num_slots=2, block_size=16, num_blocks=9, max_model_len=64,
                        prefill_chunk=16)
