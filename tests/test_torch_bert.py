"""BERT of the PyTorch port against the JAX package.

A small BERT (vocab 128, hidden 32, 2 layers, 2 heads, intermediate 64,
64 positions) is initialized by the JAX package and carried into the port
with ``params_from_jax``. The masked-LM and question-answering losses and
every gradient agree within 1e-5 in float32 (the two frameworks sum in other
orders), post- and pre-LN, flash (the JAX Pallas kernel in interpret mode,
the port's wrapper on its plain version on the CPU) and dense, with token
types and a padding mask; in bfloat16 the losses agree within 1e-2. A 3-step
ZeRO-2 loss trajectory through ``initialize`` equals the JAX engine's
within 1e-5 relative. Dropout is off in the parity tests
(``jax.random.bernoulli`` cannot be matched) and checked in the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops import flash_attention as fa

DIMS = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64)
B, T = 4, 32
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(head="MaskedLM", dtype="float32", dropout=0.0, **over):
    kw = dict(DIMS, hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout, **over)
    jm = getattr(jbert, f"BertFor{head}")(jbert.BertConfig(**kw, compute_dtype=_DT[dtype][0]))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for lp in jp["layers"]:     # biases and LayerNorm weights off their 0 / 1 init
        for k in lp:
            if k.endswith("b") or k in ("attn_nw", "norm_w"):
                lp[k] = (lp[k] + 0.1 * rng.randn(*lp[k].shape)).astype(np.float32)
    tm = getattr(tbert, f"BertFor{head}")(tbert.BertConfig(**kw, compute_dtype=_DT[dtype][1]),
                                          device="cpu")
    tm.load_parameters(tbert.params_from_jax(jp, device="cpu"))
    return jm, jp, tm


def _batch(seed=0, b=B):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, DIMS["vocab_size"], size=(b, T)).astype(np.int32)
    labels = np.where(rng.rand(b, T) < 0.3, ids, -100).astype(np.int32)
    types = (np.arange(T)[None, :] >= T // 2).astype(np.int32).repeat(b, 0)
    mask = np.ones((b, T), np.float32)
    mask[0, T - 7:] = 0
    mask[b - 1, T - 2:] = 0
    return ids, labels, types, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_params_from_jax_round_trip():
    jm, jp, tm = _models("QuestionAnswering")
    named = dict(tm.named_parameters())
    assert len(named) == 5 + 12 * DIMS["num_hidden_layers"] + 2
    assert tm.param_count() == jm.param_count(jp)
    np.testing.assert_array_equal(named["layers.1.attn_qkvw"].detach().numpy(),
                                  jp["layers"][1]["attn_qkvw"])
    np.testing.assert_array_equal(named["embeddings.token_type"].detach().numpy(),
                                  jp["embeddings"]["token_type"])
    np.testing.assert_array_equal(named["qa_outputs.w"].detach().numpy(), jp["qa_outputs"]["w"])
    assert tuple(named["layers.0.inter_w"].shape) == (32, 64)          # [in, out]
    with pytest.raises(ValueError, match="parameter names differ"):
        tbert.BertForMaskedLM(tm.config, device="cpu").load_parameters(
            tbert.params_from_jax(jp, device="cpu"))                   # qa_outputs is extra


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_mlm_loss_and_grads_match_jax(pre_ln, flash):
    jm, jp, tm = _models(pre_layer_norm=pre_ln, use_flash_attention=flash)
    ids, labels, types, mask = _batch()
    jloss, jgrads = jax.value_and_grad(jm.apply)(
        jp, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(types), jnp.asarray(mask))
    fa.flash_attention_fwd.launches = 0
    loss = tm(*_t(ids, labels, types, mask))
    loss.backward()
    assert fa.flash_attention_fwd.launches == 0      # CPU: the plain version
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = tbert.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_mlm_logits_and_optional_inputs_match_jax():
    """No token types and no mask; float32 logits of the expected shape."""
    jm, jp, tm = _models()
    ids, labels, _, _ = _batch(1)
    want = np.asarray(jm.logits(jp, jnp.asarray(ids)))
    got = tm.logits(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, DIMS["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tm(*_t(ids, labels)).detach()),
                               float(jm.apply(jp, jnp.asarray(ids), jnp.asarray(labels))),
                               rtol=0, atol=1e-5)
    none = np.full_like(labels, -100)       # no label: 0 / max(0, 1)
    assert float(tm(*_t(ids, none)).detach()) == 0.0


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_qa_loss_and_grads_match_jax(flash):
    jm, jp, tm = _models("QuestionAnswering", use_flash_attention=flash)
    ids, _, types, mask = _batch(2)
    start = np.asarray([1, 5, 9, 0], np.int32)
    end = np.asarray([3, 5, 20, 7], np.int32)
    jloss, jgrads = jax.value_and_grad(jm.apply)(
        jp, jnp.asarray(ids), jnp.asarray(start), jnp.asarray(end), jnp.asarray(types),
        jnp.asarray(mask))
    loss = tm(*_t(ids, start, end, types, mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=1e-5)
    want = tbert.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    js, je = jm.logits(jp, jnp.asarray(ids), jnp.asarray(types), jnp.asarray(mask))
    ts, te = tm.logits(*_t(ids, types, mask))
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (B, T)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), rtol=0, atol=1e-5)


@pytest.mark.parametrize("head", ["MaskedLM", "QuestionAnswering"])
def test_bfloat16_loss_matches_jax(head):
    jm, jp, tm = _models(head, dtype="bfloat16")
    ids, labels, types, mask = _batch(3)
    if head == "MaskedLM":
        jargs, targs = (labels,), (labels,)
    else:
        jargs = targs = (np.asarray([1, 5, 9, 0], np.int32), np.asarray([3, 5, 20, 7], np.int32))
    want = float(jm.apply(jp, jnp.asarray(ids), *map(jnp.asarray, jargs), jnp.asarray(types),
                          jnp.asarray(mask)))
    got = tm(*_t(ids, *targs, types, mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=0, atol=1e-2)
    assert tbert.BertModel.forward(tm, torch.from_numpy(ids)).dtype == torch.bfloat16


def _config():
    return {"train_batch_size": B, "steps_per_print": 1000,
            "optimizer": {"type": "Lamb", "params": {"lr": 1e-2}},
            # ZeRO needs a low-precision policy: bf16 parameters (the model
            # still computes in float32)
            "bf16": {"enabled": True}, "zero_optimization": {"stage": 2}}


def test_zero2_lamb_trajectory_matches_jax_engine():
    """The masked-LM batch with token types left out (None) and the float
    mask goes through both engines as it is."""
    from deepspeed_tpu.parallel.mesh import single_device_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    jm, jp, tm = _models()
    jeng = DeepSpeedEngine(model=jm, model_parameters=jp, mesh=single_device_mesh(),
                           config_params=_config())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=tm, config_params=_config(),
                                                   device="cpu")
    want, got = [], []
    for seed in range(3):
        ids, labels, _, mask = _batch(seed)
        loss = jeng(ids, labels, None, mask)
        jeng.backward(loss)
        jeng.step()
        want.append(float(loss))
        loss = teng(*_t(ids, labels), None, torch.from_numpy(mask))
        teng.backward(loss)
        teng.step()
        got.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] != got[0] and teng.global_steps == 3


def test_init_scheme_and_device_rule():
    cfg = tbert.BertConfig(**DIMS, compute_dtype=torch.float32)
    assert not cfg.pre_layer_norm and cfg.use_flash_attention and cfg.hidden_dropout_prob == 0.1
    m = tbert.BertForQuestionAnswering(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert abs(p["embeddings.word"].std().item() - 0.02) < 2e-3
    assert abs(p["layers.1.output_w"].std().item() - 0.01) < 1e-3      # 0.02 / sqrt(2 * 2)
    assert torch.equal(p["embeddings.ln_scale"], torch.ones(32))
    assert torch.equal(p["qa_outputs.b"], torch.zeros(2))
    q = tbert.BertForQuestionAnswering(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbert.BertModel(cfg)


def test_dropout_draws_from_the_generator():
    _, _, tm = _models(dropout=0.3)
    ids, labels, types, mask = _t(*_batch(4))
    with torch.no_grad():
        plain = float(tm(ids, labels, types, mask))
        a = float(tm(ids, labels, types, mask, torch.Generator().manual_seed(5), False))
        b = float(tm(ids, labels, types, mask, torch.Generator().manual_seed(5), False))
        c = float(tm(ids, labels, types, mask, torch.Generator().manual_seed(6), False))
        d = float(tm(ids, labels, types, mask, torch.Generator().manual_seed(5), True))
    assert a == b and a != c and a != plain and d == plain
