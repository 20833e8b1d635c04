"""The fused transformer block of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain version (the kernels'
arithmetic in PyTorch) and the JAX side runs its Pallas kernel in interpret
mode, as tests/unit/test_fused_block.py does; both take the same numpy
operands (that file's shape: B 2, T 64, E 32, 4 heads). Tolerances: float32
1e-5 (the two frameworks sum in other orders); bfloat16 2e-2 of max |ref|
(both round to bf16 at the same points up to the softmax, where a rounding
of a neighbouring bf16 value may differ); gradients 1e-4 (both packages
differentiate their ``fused_block_reference`` at the saved inputs). The
CUDA kernels run only on the card: the ``cuda``-marked tests hold them
against the plain version there and skip elsewhere. JAX is imported only by
the tests that use it, so that on a machine with a card and no JAX
``python -m pytest -m cuda --noconftest tests/test_torch_fused_block.py``
runs the kernel tests.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import fused_block as fb

B, T, E, H = 2, 64, 32, 4
NAMES = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_proj", "b_proj")


def _operands(seed=0, b=B, t=T, e=E):
    rng = np.random.RandomState(seed)

    def mk(shape, scale=0.05):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {"x": mk((b, t, e), 1.0), "ln_scale": 1.0 + mk((e,)), "ln_bias": mk((e,)),
            "w_qkv": mk((e, 3 * e)), "b_qkv": mk((3 * e,)), "w_proj": mk((e, e)),
            "b_proj": mk((e,))}


def _torch_args(ops, dtype=torch.float32, grad=False):
    out = [torch.from_numpy(ops[n].copy()) for n in NAMES]
    out[0] = out[0].to(dtype)
    return [t.requires_grad_() for t in out] if grad else out


def _jax_args(ops, dtype=None):
    import jax.numpy as jnp
    out = [jnp.asarray(ops[n]) for n in NAMES]
    if dtype is not None:
        out[0] = out[0].astype(dtype)
    return out


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_version_matches_jax_kernel_float32(causal):
    from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
    ops = _operands()
    want = np.asarray(jax_fused(*_jax_args(ops), H, causal=causal, block_q=16))
    fb.fused_transformer_block.launches = 0
    got = fb.fused_transformer_block(*_torch_args(ops), H, causal=causal, block_q=16)
    assert fb.fused_transformer_block.launches == 0      # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, E)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_version_matches_jax_kernel_bfloat16(causal):
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
    ops = _operands(1)
    want = np.asarray(jax_fused(*_jax_args(ops, jnp.bfloat16), H, causal=causal, block_q=16),
                      np.float32)
    got = fb.fused_transformer_block(*_torch_args(ops, torch.bfloat16), H, causal=causal)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_reference_matches_jax_reference(dtype, causal):
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.fused_block import fused_block_reference as jax_ref
    ops = _operands(2)
    want = np.asarray(jax_ref(*_jax_args(ops, getattr(jnp, dtype)), H, causal=causal),
                      np.float32)
    got = fb.fused_block_reference(*_torch_args(ops, getattr(torch, dtype)), H, causal=causal)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, err


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gradients_through_the_wrapper_match_jax_grad(causal):
    """All seven gradients of sum(out ** 2) against ``jax.grad`` of the JAX
    wrapper (its custom_vjp backward is its reference's vjp)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
    ops = _operands(3)
    want = jax.grad(lambda *a: jnp.sum(jax_fused(*a, H, causal=causal, block_q=16) ** 2),
                    argnums=tuple(range(7)))(*_jax_args(ops))
    args = _torch_args(ops, grad=True)
    fb.fused_transformer_block(*args, H, causal=causal).square().sum().backward()
    for name, t, w in zip(NAMES, args, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_backward_is_the_reference_gradient_and_honours_needs_input_grad():
    ops = _operands(4)
    args = _torch_args(ops)
    args[0].requires_grad_()
    args[3].requires_grad_()
    g = torch.from_numpy(np.random.RandomState(5).randn(B, T, E).astype(np.float32))
    fb.fused_transformer_block(*args, H).backward(g)
    assert all(t.grad is None for i, t in enumerate(args) if i not in (0, 3))
    ref_args = _torch_args(ops, grad=True)
    fb.fused_block_reference(*ref_args, H).backward(g)
    torch.testing.assert_close(args[0].grad, ref_args[0].grad, rtol=0, atol=0)
    torch.testing.assert_close(args[3].grad, ref_args[3].grad, rtol=0, atol=0)


@pytest.mark.parametrize("t", [64, 50, 7])
def test_any_sequence_length_and_block_q(t):
    """JAX halves ``block_q`` until it divides T; the port takes any T, and
    ``block_q`` / ``interpret`` change nothing."""
    ops = _operands(6, t=t)
    want = fb.fused_block_reference(*_torch_args(ops), H)
    for block_q in (None, 16, 256):
        got = fb.fused_transformer_block(*_torch_args(ops), H, block_q=block_q,
                                         interpret=True)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if t == 64:
        from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_fused(*_jax_args(ops), H)),
                                   rtol=0, atol=1e-5)


def test_plain_version_rounds_where_the_kernel_rounds():
    """bf16: the qkv bias is added in float32 before the one cast, and the
    residual sum is cast once; the reference casts first."""
    ops = _operands(7)
    args = _torch_args(ops, torch.bfloat16)
    x, scale, bias, w_qkv, b_qkv = args[:5]
    ws = fb.fused_block_kv_plain(x, scale, bias, w_qkv, b_qkv)
    assert ws.dtype == torch.bfloat16 and tuple(ws.shape) == (2, B, T, E)
    h = fb._layer_norm_f32(x, scale, bias, 1e-5).to(torch.bfloat16)
    acc = h.float() @ w_qkv[:, E:].to(torch.bfloat16).float() + b_qkv[E:]
    torch.testing.assert_close(torch.cat([ws[0], ws[1]], -1), acc.to(torch.bfloat16),
                               rtol=0, atol=0)
    plain = fb.fused_block_plain(*args, H)
    ref = fb.fused_block_reference(*args, H)
    assert not torch.equal(plain, ref)
    assert float((plain.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())


@pytest.mark.parametrize("case", ["width", "head_dim", "heads", "dtype", "rank", "shape"])
def test_limits_and_operand_checks_raise(case):
    if case == "width":       # E * itemsize > 3072
        x = torch.zeros(1, 4, 800)
        with pytest.raises(ValueError, match="3072"):
            fb.fused_transformer_block(x, *(torch.zeros(s) for s in (
                (800,), (800,), (800, 2400), (2400,), (800, 800), (800,))), 16)
        fb.check_limits(torch.zeros(1, 4, 1536, dtype=torch.bfloat16), 24)
        return
    ops = _operands()
    args = _torch_args(ops)
    if case == "head_dim":
        wide = _torch_args(_operands(e=256))
        with pytest.raises(ValueError, match="head dim <= 64"):
            fb.fused_transformer_block(*wide, 2)
    elif case == "heads":
        with pytest.raises(ValueError, match="must divide"):
            fb.fused_transformer_block(*args, 5)
    elif case == "dtype":
        args[0] = args[0].double()
        with pytest.raises(TypeError, match="float32"):
            fb.fused_transformer_block(*args, H)
    elif case == "rank":
        args[0] = args[0][0]
        with pytest.raises(ValueError, match=r"\[B, T, E\]"):
            fb.fused_transformer_block(*args, H)
    else:
        args[3] = args[3][:, :E]
        with pytest.raises(ValueError, match="w_qkv"):
            fb.fused_transformer_block(*args, H)


def test_launchers_refuse_cpu_tensors():
    """The launch functions never fall back: a CPU tensor raises."""
    args = _torch_args(_operands())
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_kv(*args[:5])
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_q(args[0], torch.zeros(2, B, T, E), *args[1:], n_head=H)


CUDA_CASES = [  # (B, T, E, heads, dtype, causal)
    (2, 64, 32, 4, torch.float32, True),
    (2, 64, 32, 4, torch.float32, False),
    (2, 1000, 768, 12, torch.bfloat16, True),
    (1, 300, 1024, 16, torch.float16, False),
    (1, 100, 96, 3, torch.float32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernels_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, t, e, heads, dtype, causal = case
    args = [a.cuda() for a in _torch_args(_operands(8, b, t, e), dtype)]
    before = (fb.fused_transformer_block.launches, fb.fused_block_kv.launches,
              fb.fused_block_q.launches)
    got = fb.fused_transformer_block(*args, heads, causal=causal)
    torch.cuda.synchronize()
    assert (fb.fused_transformer_block.launches, fb.fused_block_kv.launches,
            fb.fused_block_q.launches) == tuple(n + 1 for n in before)
    cast = [args[0], args[1], args[2], args[3].to(dtype), args[4], args[5].to(dtype), args[6]]
    want = fb.fused_block_plain(*cast, heads, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    assert torch.isfinite(got).all() and err <= tol, err


@pytest.mark.cuda
def test_cuda_gradients_are_the_reference_gradients():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops = _operands(9, 2, 200, 128)
    args = [a.cuda().requires_grad_() for a in _torch_args(ops)]
    ref_args = [a.cuda().requires_grad_() for a in _torch_args(ops)]
    g = torch.randn(2, 200, 128, device="cuda")
    fb.fused_transformer_block(*args, 4).backward(g)
    fb.fused_block_reference(*ref_args, 4).backward(g)
    for name, a, r in zip(NAMES, args, ref_args):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.cuda
def test_cuda_limits_raise_before_any_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = fb.fused_block_kv.launches
    args = [a.cuda() for a in _torch_args(_operands(e=1024))]   # float32 at E = 1024
    with pytest.raises(ValueError, match="3072"):
        fb.fused_transformer_block(*args, 16)
    assert fb.fused_block_kv.launches == before
