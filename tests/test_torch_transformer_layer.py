"""The transformer (BERT encoder) layer of the PyTorch port against the JAX package.

A small layer (hidden 32, 4 heads, intermediate 64, T 64, float32) takes the
JAX layer's ``init`` parameters and the same numpy hidden states. Forward
outputs and every gradient of sum(out * g) agree within 1e-5 (float32; the
two frameworks sum in other orders), pre- and post-LN, with flash attention
(the JAX Pallas kernel in interpret mode, the port's wrapper on its plain
version on the CPU) and on the dense path, for no mask, a ``[B, T]`` and a
``[B, 1, 1, T]`` additive key mask and a full ``[B, 1, T, T]`` mask. In
bfloat16 the forward agrees within 2e-2 of max |ref|. The memory knobs give
equal numbers, ``initial_weights`` load transposed as in the JAX layer, and
dropout (which cannot match ``jax.random``) is checked in the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import DeepSpeedTransformerConfig as JaxConfig
from deepspeed_tpu.ops.transformer import DeepSpeedTransformerLayer as JaxLayer
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer, TransformerConfig)

B, T, H, HEADS, INTER = 2, 64, 32, 4, 64


def _kw(**over):
    kw = dict(batch_size=B, max_seq_length=T, hidden_size=H, intermediate_size=INTER,
              heads=HEADS, attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              num_hidden_layers=2, initializer_range=0.02, bf16=False)
    kw.update(over)
    return kw


def _layers(**over):
    """(JAX layer, its params with random biases and LayerNorm weights, the
    port's layer holding the same numbers)."""
    jl = JaxLayer(JaxConfig(**_kw(**over)))
    jp = {k: np.asarray(v) for k, v in jl.init(jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(0)
    for k in jp:
        if k.endswith("b") or k in ("attn_nw", "norm_w"):
            jp[k] = (jp[k] + 0.1 * rng.randn(*jp[k].shape)).astype(np.float32)
    tl = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**_kw(**over)), device="cpu")
    with torch.no_grad():
        for k, v in jp.items():
            getattr(tl, k).copy_(torch.from_numpy(np.array(v)))
    return jl, jp, tl


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(B, T, H).astype(np.float32), rng.randn(B, T, H).astype(np.float32)


def _mask(form):
    if form == "none":
        return None
    rng = np.random.RandomState(2)
    if form == "full":
        return np.where(rng.rand(B, 1, T, T) < 0.2, -1e4, 0.0).astype(np.float32)
    key = np.zeros((B, T), np.float32)
    key[0, T - 10:] = -1e9
    key[1, T - 3:] = -1e9
    return key if form == "bt" else key[:, None, None, :]


# a [B, T] mask does not broadcast on the dense path, in either package
PATHS = [(flash, mask) for flash in (False, True) for mask in ("none", "bt", "b11t", "full")
         if flash or mask != "bt"]


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("flash,mask", PATHS,
                         ids=[f"{'flash' if f else 'dense'}-{m}" for f, m in PATHS])
def test_forward_and_backward_match_jax(pre_ln, flash, mask):
    jl, jp, tl = _layers(pre_layer_norm=pre_ln, use_flash_attention=flash)
    x, g = _inputs()
    m = _mask(mask)
    jm = None if m is None else jnp.asarray(m)

    def jloss(params, x):
        out = jl.apply(params, x, attention_mask=jm)
        return jnp.sum(out * g), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    fa.flash_attention_fwd.launches = 0
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt, attention_mask=None if m is None else torch.from_numpy(m))
    (out * torch.from_numpy(g)).sum().backward()
    assert fa.flash_attention_fwd.launches == 0      # CPU: the plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    for name in tl.NAMES:
        np.testing.assert_allclose(getattr(tl, name).grad.numpy(), np.asarray(gp[name]),
                                   rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("form,flash", [("none", True), ("bt", True), ("b11t", True),
                                        ("full", False)])
def test_mask_form_selects_the_attention_path(form, flash):
    """No mask and the two key-mask forms run flash; a full mask runs dense."""
    _, _, tl = _layers(use_flash_attention=True)
    m = _mask(form)
    calls = []
    wrapped = fa._attend
    fa._attend = lambda *a, **k: calls.append(1) or wrapped(*a, **k)
    try:
        tl(torch.from_numpy(_inputs()[0]), None if m is None else torch.from_numpy(m))
    finally:
        fa._attend = wrapped
    assert bool(calls) == flash


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_bfloat16_forward_matches_jax(pre_ln):
    jl, jp, tl = _layers(pre_layer_norm=pre_ln, bf16=True)
    x, _ = _inputs(3)
    m = _mask("b11t")
    want = np.asarray(jl.apply({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
                               attention_mask=jnp.asarray(m)), np.float32)
    out = tl(torch.from_numpy(x), torch.from_numpy(m))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().detach().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("knob", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
def test_memory_knobs_give_equal_numbers(knob, dropout):
    """A recomputed segment gives the same output and gradients, with
    train-mode dropout too: the attention seed is drawn before the segment."""
    rates = dict(attn_dropout_ratio=0.2, hidden_dropout_ratio=0.1) if dropout else {}
    results = []
    for on in (False, True):
        _, _, tl = _layers(pre_layer_norm=True, **rates, **{knob: on})
        xt = torch.from_numpy(_inputs(4)[0]).requires_grad_()
        gen = torch.Generator().manual_seed(7) if dropout else None
        out = tl(xt, torch.from_numpy(_mask("b11t")), generator=gen, deterministic=not dropout)
        out.square().sum().backward()
        results.append([out.detach(), xt.grad] + [getattr(tl, n).grad for n in tl.NAMES])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_initial_weights_and_biases_load_transposed_as_in_jax():
    rng = np.random.RandomState(5)
    shapes = [(H, H)] * 4 + [(H,), (INTER, H), (H, INTER), (H,)]
    weights = [rng.randn(*s).astype(np.float32) for s in shapes]
    biases = [rng.randn(s[0]).astype(np.float32) for s in shapes]
    jl = JaxLayer(JaxConfig(**_kw()), initial_weights=weights, initial_biases=biases)
    want = jl.init(jax.random.PRNGKey(0))
    tl = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**_kw()), initial_weights=weights,
                                   initial_biases=biases, device="cpu")
    got = tl.init(torch.Generator().manual_seed(0))
    assert list(got) == list(tl.NAMES) == list(want)
    assert [tuple(p.shape) for p in got.values()] == tl.param_shapes() == jl.param_shapes()
    for name in tl.NAMES:
        np.testing.assert_array_equal(got[name].detach().numpy(), np.asarray(want[name]),
                                      err_msg=name)


def test_init_scheme_and_config_surface(tmp_path):
    cfg = DeepSpeedTransformerConfig(hidden_size=64, heads=4, num_hidden_layers=8,
                                     initializer_range=0.02)
    assert cfg.intermediate_size == 256 and cfg.pre_layer_norm and cfg.use_flash_attention
    assert cfg.compute_dtype == torch.bfloat16
    assert DeepSpeedTransformerConfig(fp16=True).compute_dtype == torch.float16
    assert DeepSpeedTransformerConfig(bf16=False).compute_dtype == torch.float32
    assert isinstance(cfg, TransformerConfig)
    tl = DeepSpeedTransformerLayer(cfg, device="cpu")
    p = tl.init(torch.Generator().manual_seed(0))
    assert abs(p["attn_qkvw"].std().item() - 0.02) < 2e-3
    assert abs(p["output_w"].std().item() - 0.02 / 4.0) < 5e-4
    assert torch.equal(p["norm_w"], torch.ones(64)) and torch.equal(p["inter_b"], torch.zeros(256))
    path = tmp_path / "layer.json"
    path.write_text('{"hidden_size": 48, "heads": 3, "fp16": true, "pre_layer_norm": false}')
    loaded = DeepSpeedTransformerConfig.from_json_file(str(path))
    assert (loaded.hidden_size, loaded.heads, loaded.pre_layer_norm) == (48, 3, False)
    assert loaded.compute_dtype == torch.float16
    assert DeepSpeedTransformerConfig.from_dict({"heads": 7}).heads == 7


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_dropout_draws_from_the_generator(flash):
    """The same generator seed gives the same output, another seed another;
    rate 0, ``deterministic`` or no generator give the eval output."""
    _, _, tl = _layers(attn_dropout_ratio=0.3, hidden_dropout_ratio=0.2,
                       use_flash_attention=flash)
    x = torch.from_numpy(_inputs(6)[0])
    with torch.no_grad():
        plain = tl(x)
        a = tl(x, generator=torch.Generator().manual_seed(1), deterministic=False)
        b = tl(x, generator=torch.Generator().manual_seed(1), deterministic=False)
        c = tl(x, generator=torch.Generator().manual_seed(2), deterministic=False)
        d = tl(x, generator=torch.Generator().manual_seed(1), deterministic=True)
        e = tl(x, deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
    assert torch.equal(d, plain) and torch.equal(e, plain)
    _, _, off = _layers(attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                        use_flash_attention=flash)
    with torch.no_grad():
        torch.testing.assert_close(
            off(x, generator=torch.Generator().manual_seed(1), deterministic=False), off(x),
            rtol=0, atol=0)


def test_attention_dropout_is_the_kernels_hash_on_both_paths():
    """One generator seed gives the same output through flash and through the
    dense path, whose keep mask is ``dropout_keep_reference`` of the seed the
    layer drew; hidden dropout then sees the same generator state."""
    _, _, tl = _layers(attn_dropout_ratio=0.25, hidden_dropout_ratio=0.1,
                       use_flash_attention=True)
    x = torch.from_numpy(_inputs(7)[0])
    seed = int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(3)))
    keep = fa.dropout_keep_reference(seed, B, HEADS, T, T, 0.25) > 0
    assert 0.7 < keep.float().mean() < 0.8
    with torch.no_grad():
        got = tl(x, generator=torch.Generator().manual_seed(3), deterministic=False)
        tl.config.use_flash_attention = False
        want = tl(x, generator=torch.Generator().manual_seed(3), deterministic=False)
        assert not torch.equal(got, tl(x))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
