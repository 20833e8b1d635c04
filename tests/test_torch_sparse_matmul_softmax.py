"""Block-sparse ``MatMul`` and ``Softmax`` of the PyTorch port against the JAX package.

tests/unit/test_sparse_ops.py's setting (B 2, 4 heads, T 64, block 16, a
bidirectional Fixed layout with one pattern per head): the same numpy
operands go through the JAX ops and the port's, and the results agree
within 1e-5 (float32, absolute plus relative for the products, whose
values reach 30; the frameworks sum in other orders): the three
``MatMul`` modes with every transpose flag, ``Softmax`` with scale, rpe in
its three shapes, key-padding and attention masks in both modes, the two
converters, the composed sdd -> softmax -> dsd attention and its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa

B, H, T, BLOCK = 2, 4, 64, 16


def _layout():
    kw = dict(num_heads=H, block=BLOCK, num_local_blocks=2, num_global_blocks=1,
              attention="bidirectional", different_layout_per_head=True,
              num_different_global_patterns=2)
    layout = tsa.FixedSparsityConfig(**kw).make_layout(T)
    np.testing.assert_array_equal(layout, jsa.FixedSparsityConfig(**kw).make_layout(T))
    assert 0 < layout.sum() < layout.size
    return layout


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_converters_match_jax_and_round_trip():
    layout = _layout()
    dense = _randn(0, B, H, T, T)
    vals = tsa.dense_to_sparse(torch.from_numpy(dense), layout, BLOCK)
    assert tuple(vals.shape) == (B, int(layout.sum()), BLOCK, BLOCK)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.asarray(jsa.dense_to_sparse(jnp.asarray(dense), layout, BLOCK)))
    back = tsa.sparse_to_dense(vals, layout, BLOCK, fill=-7.0)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsa.sparse_to_dense(jnp.asarray(vals.numpy()), layout, BLOCK,
                                                     fill=-7.0)))
    mask = np.kron(layout, np.ones((BLOCK, BLOCK))).astype(bool)[None]
    np.testing.assert_array_equal(back.numpy(), np.where(mask, dense, -7.0))


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("mode", ["sdd", "dsd", "dds"])
def test_matmul_matches_jax(mode, trans_a, trans_b):
    layout = _layout()
    a, b = _randn(1, B, H, T, T), _randn(2, B, H, T, T)
    if mode == "dsd":
        a = np.array(jsa.dense_to_sparse(jnp.asarray(a), layout, BLOCK))
    if mode == "dds":
        b = np.array(jsa.dense_to_sparse(jnp.asarray(b), layout, BLOCK))
    want = jsa.MatMul(layout, BLOCK, mode, trans_a=trans_a, trans_b=trans_b)(
        jnp.asarray(a), jnp.asarray(b))
    op = tsa.MatMul(layout, BLOCK, mode, trans_a=trans_a, trans_b=trans_b)
    got = op(torch.from_numpy(a), torch.from_numpy(b))
    assert op.nnz == int(layout.sum()) and got.dtype == torch.float32
    # sums of 16 to 64 unit-normal products reach |x| ~ 30: 1e-5 relative too
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_matmul_rounds_once_in_bfloat16_and_checks_extents():
    layout = _layout()
    a = torch.from_numpy(_randn(3, B, H, T, T)).bfloat16()
    b = torch.from_numpy(_randn(4, B, H, T, T)).bfloat16()
    got = tsa.MatMul(layout, BLOCK, "sdd")(a, b)
    want = tsa.dense_to_sparse(torch.matmul(a.float(), b.float()), layout, BLOCK).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0.25)  # one bf16 ulp at |x| <= 32
    with pytest.raises(NotImplementedError, match="sdd, dsd, dds"):
        tsa.MatMul(layout, BLOCK, "ddd")
    with pytest.raises(ValueError, match="does not match layout"):
        tsa.MatMul(layout, BLOCK, "sdd")(a[:, :, :T - BLOCK], b)
    with pytest.raises(ValueError, match="nnz"):
        tsa.MatMul(layout, BLOCK, "dsd")(torch.zeros(B, 3, BLOCK, BLOCK), b)


SOFTMAX_CASES = {
    "scale": dict(scale=0.5),
    "rpe_h": dict(rpe=(H, T, T)),
    "rpe_1": dict(scale=0.3, rpe=(1, T, T)),
    "rpe_bh": dict(rpe=(B, H, T, T)),
    "rpe_b1": dict(rpe=(B, 1, T, T)),
    "kp_add": dict(kp="add"),
    "kp_mul": dict(kp="mul"),
    "am_mul": dict(am="mul"),
    "am_add": dict(am="add"),
    "all": dict(scale=0.7, rpe=(H, T, T), kp="add", am="mul"),
}


@pytest.mark.parametrize("case", SOFTMAX_CASES)
def test_softmax_matches_jax(case):
    spec = SOFTMAX_CASES[case]
    layout = _layout()
    rng = np.random.RandomState(5)
    vals = np.array(jsa.dense_to_sparse(jnp.asarray(_randn(6, B, H, T, T)), layout, BLOCK))
    kw = dict(scale=spec.get("scale", 1.0))
    if "rpe" in spec:
        kw["rpe"] = rng.randn(*spec["rpe"]).astype(np.float32)
    if "kp" in spec:
        kp = np.where(rng.rand(B, T) < 0.2, 0.0, 1.0 if spec["kp"] == "mul" else 0.0)
        if spec["kp"] == "add":
            kp = np.where(rng.rand(B, T) < 0.2, -1e4, 0.0)
        kw.update(key_padding_mask=kp.astype(np.float32), key_padding_mask_mode=spec["kp"])
    if "am" in spec:
        am = np.tril(np.ones((T, T))) * 2.5 if spec["am"] == "mul" else rng.randn(T, T)
        kw.update(attn_mask=am.astype(np.float32), attn_mask_mode=spec["am"])
    want = jsa.Softmax(layout, BLOCK)(jnp.asarray(vals), **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    got = tsa.Softmax(layout, BLOCK)(torch.from_numpy(vals), **{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if case == "scale":      # each logical row of the sparse matrix sums to one
        rows = tsa.sparse_to_dense(got, layout, BLOCK).sum(-1)
        torch.testing.assert_close(rows, torch.ones_like(rows), rtol=0, atol=1e-5)


def test_softmax_fully_masked_rows_are_zero():
    layout = _layout()
    vals = tsa.dense_to_sparse(torch.from_numpy(_randn(7, B, H, T, T)), layout, BLOCK)
    am = torch.ones(T, T)
    am[5] = 0
    out = tsa.sparse_to_dense(tsa.Softmax(layout, BLOCK)(vals, attn_mask=am), layout, BLOCK)
    assert torch.isfinite(out).all() and out[:, :, 5].eq(0).all()
    with pytest.raises(ValueError, match="nnz"):
        tsa.Softmax(layout, BLOCK)(vals[:, :-1])


def test_sdd_softmax_dsd_attention_and_gradients_match_jax():
    layout = _layout()
    D = 16
    q, k, v, g = (_randn(s, B, H, T, D) for s in (8, 9, 10, 11))

    def jattn(q, k, v):
        s = jsa.MatMul(layout, BLOCK, "sdd", trans_b=True)(q, k)
        p = jsa.Softmax(layout, BLOCK)(s, scale=D ** -0.5)
        return jsa.MatMul(layout, BLOCK, "dsd")(p, v)

    want, vjp = jax.vjp(jattn, *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    s = tsa.MatMul(layout, BLOCK, "sdd", trans_b=True)(tq, tk)
    p = tsa.Softmax(layout, BLOCK)(s, scale=D ** -0.5)
    out = tsa.MatMul(layout, BLOCK, "dsd")(p, tv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w, name in zip((tq, tk, tv), wgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)
    # and the dense masked attention it stands for
    mask = torch.from_numpy(np.kron(layout, np.ones((BLOCK, BLOCK))).astype(bool))[None]
    scores = torch.matmul(tq, tk.transpose(-1, -2)) * D ** -0.5
    dense = torch.matmul(torch.softmax(scores.masked_fill(~mask, -torch.inf), -1), tv)
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-5)
