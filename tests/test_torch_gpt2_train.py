"""GPT-2 training forward of the PyTorch port against the JAX package.

A tiny GPT-2 (vocab 64, 32 positions, width 32, 2 layers, 2 heads, float32)
is initialized by the JAX package and carried into the port with
``params_from_jax``. The loss and every parameter's gradient of the port's
``forward(tokens, labels)`` are held against ``jax.value_and_grad`` of the
JAX ``apply`` on the same numpy tokens, within 1e-5 (float32; the two
frameworks sum in different orders): dense and flash attention (the JAX
flash kernel runs in interpret mode, the port's wrapper takes its plain
version on the CPU), the unchunked and the chunked cross-entropy, labels
with -100, and the logits path.
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

DIMS = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2, n_head=2)
B, T = 2, 16


def _models(flash, loss_chunk):
    jm = JaxGPT2Model(JaxGPT2Config(**DIMS, compute_dtype=jnp.float32,
                                    use_flash_attention=flash, loss_chunk=loss_chunk))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32,
                              use_flash_attention=flash, loss_chunk=loss_chunk),
                   device="cpu")
    tm.load_parameters(params_from_jax(jp, device="cpu"))
    return jm, jp, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, DIMS["vocab_size"], size=(B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    labels[0, 3] = -100
    return tokens, labels


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("loss_chunk", [0, 4])
def test_loss_and_grads_match_jax(flash, loss_chunk):
    jm, jp, tm = _models(flash, loss_chunk)
    tokens, labels = _batch()
    jloss, jgrads = jax.value_and_grad(jm.apply)(jp, jnp.asarray(tokens), jnp.asarray(labels))
    fa.flash_attention_fwd.launches = 0
    loss = tm(torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert fa.flash_attention_fwd.launches == 0   # CPU: the plain version


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_logits_match_jax(flash):
    jm, jp, tm = _models(flash, 4)
    tokens, _ = _batch(1)
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, DIMS["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_bf16_logits_are_float32_from_bf16_operands():
    """Compute dtype bf16: hidden states in bf16, the tied head in float32."""
    tm = GPT2Model(GPT2Config(**DIMS, use_flash_attention=True), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tokens, labels = _batch(2)
    logits = tm(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    x = tm._backbone(tm.params_tree(), torch.from_numpy(tokens))
    assert x.dtype == torch.bfloat16
    ref = x.float() @ tm.wte.to(torch.bfloat16).float().t()
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)
    loss = tm(torch.from_numpy(tokens), torch.from_numpy(labels))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_dropout_draws_from_the_generator():
    """dropout > 0 with a generator: a different loss than without, the same
    loss again from the same generator seed."""
    tm = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32, dropout=0.3,
                              use_flash_attention=True), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tokens, labels = (torch.from_numpy(a) for a in _batch(3))
    with torch.no_grad():
        plain = float(tm(tokens, labels))
        a = float(tm(tokens, labels, torch.Generator().manual_seed(5)))
        b = float(tm(tokens, labels, torch.Generator().manual_seed(5)))
    assert a == b and a != plain


@pytest.mark.parametrize("field,value", [("remat", True), ("remat_policy", "dots")])
def test_remat_refused_by_training_ignored_by_serving(field, value):
    """Training takes remat (once refused, now used: the same loss and grads
    as without it); the serving programs never read it, as in the JAX
    serving path."""
    over = {field: value, "remat": True} if field == "remat_policy" else {field: value}
    cfg = GPT2Config(**DIMS, compute_dtype=torch.float32, **over)
    tm = GPT2Model(cfg, device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    plain = GPT2Model(GPT2Config(**DIMS, compute_dtype=torch.float32), device="cpu")
    plain.load_parameters(dict(tm.named_parameters()))
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    for m in (tm, plain):
        m(tokens, labels).backward()
    for (name, p), q in zip(tm.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0, msg=name)
    from deepspeed_tpu_torch.serve.scheduler import Request
    eng = deepspeed_tpu_torch.init_inference(
        tm, config_params={"serving": {"max_seqs": 2, "block_size": 4, "num_blocks": 17,
                                       "max_model_len": 32, "prefill_chunk": 8}},
        device="cpu")
    outs, _ = eng.run([Request("r", [1, 2, 3], 4)])
    assert outs[0].status == "finished" and len(outs[0].tokens) == 4


def test_param_count_matches_jax():
    jm, jp, tm = _models(False, 0)
    assert tm.param_count() == jm.param_count(jp)
