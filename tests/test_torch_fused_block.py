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
    """The CUDA-core design's limits hold in ``check_limits`` (the card's
    wrapper applies them where the tensor-core design does not take the
    shape); the CPU wrapper computes every width and head dim the JAX
    function takes. The argument checks raise on every device."""
    if case == "width":       # float32 past E 1688: two [16, E] buffers outgrow 227 KB
        x = torch.zeros(1, 4, 1728)
        with pytest.raises(ValueError, match="227 KB"):
            fb.check_limits(x, 16)
        out = fb.fused_transformer_block(x, *(torch.zeros(s) for s in (
            (1728,), (1728,), (1728, 5184), (5184,), (1728, 1728), (1728,))), 16)
        assert out.shape == (1, 4, 1728) and torch.isfinite(out).all()
        assert fb.check_limits(torch.zeros(1, 4, 1536, dtype=torch.bfloat16), 24).rows == 32
        assert fb.check_limits(torch.zeros(1, 4, 1024), 16).rows == 16
        return
    ops = _operands()
    args = _torch_args(ops)
    if case == "head_dim":    # head dim 256
        wide = _torch_args(_operands(e=512))
        with pytest.raises(ValueError, match="head dim <= 128"):
            fb.check_limits(wide[0], 2)
        out = fb.fused_transformer_block(*wide, 2)
        torch.testing.assert_close(out, fb.fused_block_reference(*wide, 2), rtol=0, atol=1e-5)
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


WIDE_CASES = [  # (E, heads, dtype): shapes the CUDA-core design refused before its plan
    (768, 6, "bfloat16"),      # head dim 128
    (1600, 25, "bfloat16"),    # GPT-2 1.5B's width
    (1024, 16, "float32"),     # float32 at GPT-2 medium's width: 16 rows a CTA
    (1600, 20, "bfloat16"),    # heads of 80, outside the tensor-core plan
]


@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wrapper_matches_jax_where_the_cuda_cores_refuse(case):
    """Fault C3: at these shapes JAX's ``fused_transformer_block`` (Pallas,
    interpret mode) returns an answer, and so must the port on the CPU."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
    e, heads, dtype = case
    ops = _operands(11, 1, 16, e)
    want = np.asarray(jax_fused(*_jax_args(ops, getattr(jnp, dtype)), heads), np.float32)
    got = fb.fused_transformer_block(*_torch_args(ops, getattr(torch, dtype)), heads)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (1, 16, e)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-2, err


def test_wrapper_matches_jax_with_float32_heads_of_128():
    """Fault C3: float32 at E 1024 with 8 heads of 128, which the CUDA-core
    design takes since its plan pads heads to 128. Tolerance 1e-5 of max
    |ref|: the two frameworks sum the 1024-long and 128-long products in
    other orders (about 2e-6 of max |ref| here)."""
    from deepspeed_tpu.ops.pallas.fused_block import fused_transformer_block as jax_fused
    ops = _operands(11, 1, 16, 1024)
    want = np.asarray(jax_fused(*_jax_args(ops), 8), np.float32)
    got = fb.fused_transformer_block(*_torch_args(ops), 8)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 16, 1024)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


RULE_CASES = [  # (dtype, E, heads, tensor-core design?)
    (torch.bfloat16, 768, 12, True),     # GPT-2 124M
    (torch.bfloat16, 1024, 16, True),    # GPT-2 355M
    (torch.float16, 1280, 20, True),     # GPT-2 774M
    (torch.bfloat16, 1600, 25, True),    # GPT-2 1.5B
    (torch.bfloat16, 768, 6, True),      # head dim 128
    (torch.bfloat16, 768, 24, True),     # head dim 32: q in a tile of its own
    (torch.float32, 768, 12, False),     # float32: the CUDA cores
    (torch.bfloat16, 800, 16, False),    # E not a multiple of 64
    (torch.bfloat16, 1600, 20, False),   # head dim 80: a q tile of its own does not fit
    (torch.bfloat16, 1152, 8, False),    # head dim 144
    (torch.bfloat16, 2048, 16, False),   # the [64, E] tile alone takes 256 KB
]


@pytest.mark.parametrize("case", RULE_CASES, ids=lambda c: f"{str(c[0])[6:]}-{c[1]}-{c[2]}")
def test_shape_rule_picks_the_design(case):
    dtype, e, heads, tc = case
    assert fb.tensor_core_design(dtype, e, heads) is tc
    if tc or dtype == torch.float32:
        assert (fb.tensor_core_plan(e, e // heads) is not None) is (e % 64 == 0)


PLAN_CASES = [  # (E, head dim, itemsize, rows, padded head dim) of cuda_core_plan
    (768, 64, 4, 32, 64),        # float32 GPT-2 124M
    (1024, 64, 4, 16, 64),       # float32 E 1024, 16 heads (fault C3)
    (1024, 128, 4, 16, 128),     # float32 E 1024, 8 heads of 128 (fault C3)
    (1600, 80, 2, 32, 128),      # bf16 E 1600, 20 heads of 80 (fault C3)
    (1600, 64, 4, 16, 64),       # float32 GPT-2 1.5B
    (2048, 128, 2, 16, 128),     # bf16 E 2048
    (32, 8, 4, 32, 16),          # the JAX tests' shape
    (2048, 64, 4, None, None),   # float32 E 2048: two [16, E] buffers take 256 KB
    (3456, 64, 2, None, None),   # bf16 past E 3376
    (1152, 144, 2, None, None),  # head dim 144
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c[:3])))
def test_cuda_core_plan_takes_the_widths_jax_computes(case):
    """The CUDA-core design's geometry: 32 rows where the q entry fits 227 KB,
    else 16, else refused; the plan's shared memory fits and 32 rows would
    not where it takes 16. ``check_limits`` names what it refuses."""
    e, d, itemsize, rows, dp = case
    plan = fb.cuda_core_plan(e, d, itemsize)
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    if rows is None:
        assert plan is None
        with pytest.raises(ValueError, match="head dim <= 128" if d > 128 else "227 KB"):
            fb.check_limits(torch.zeros(1, 1, e, dtype=dtype), e // d)
        return
    assert plan == fb.CudaCorePlan(rows, dp)
    assert fb._cuda_core_q_smem(e, itemsize, rows, dp) <= fb._SMEM_MAX
    assert rows == 32 or fb._cuda_core_q_smem(e, itemsize, 32, dp) > fb._SMEM_MAX
    assert fb.check_limits(torch.zeros(1, 1, e, dtype=dtype), e // d) == plan


@pytest.mark.parametrize("e,d", [(768, 64), (1024, 64), (1280, 64), (1600, 64), (1600, 32),
                                 (768, 128), (1536, 128), (192, 96), (64, 8)])
def test_tensor_core_plan_fits_shared_memory(e, d):
    """Each plan's two launches fit a CTA's 227 KB, the projection's stages
    fit the ring the K/V stages leave, and the plan takes the most
    warpgroups and stages that fit (one more stage would not)."""
    plan = fb.tensor_core_plan(e, d)
    tiles = 1 if d <= 64 else 2
    assert plan.nc == (128 if e % 128 == 0 else 64)
    assert fb._qkv_smem(e, plan.nc, plan.qkv_wg, plan.qkv_stages) <= fb._SMEM_MAX
    assert fb._attn_smem(e, d, plan.attn_wg, plan.kv_stages, plan.proj_stages) <= fb._SMEM_MAX
    assert plan.proj_stages * plan.nc // 64 <= plan.kv_stages * 2 * tiles
    for wg, st, smem in ((plan.qkv_wg, plan.qkv_stages,
                          lambda w, s: fb._qkv_smem(e, plan.nc, w, s)),
                         (plan.attn_wg, plan.kv_stages,
                          lambda w, s: fb._attn_smem(e, d, w, s, plan.proj_stages))):
        assert st == 4 or smem(wg, st + 1) > fb._SMEM_MAX
        assert wg == 2 or smem(2, 2) > fb._SMEM_MAX


def test_tensor_core_plans_of_the_gpt2_widths():
    """GPT-2 124M: two warpgroups and 4 stages in both entries; 1.5B: one
    warpgroup, 64-column weight tiles, one K/V stage."""
    assert fb.tensor_core_plan(768, 64) == fb.TensorCorePlan(128, 2, 4, 2, 4, 4)
    assert fb.tensor_core_plan(1600, 64) == fb.TensorCorePlan(64, 1, 3, 1, 1, 2)
    assert fb.tensor_core_plan(1600, 80) is None
    assert fb.tensor_core_plan(800, 50) is None


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tensor_core_plain_versions_follow_their_entries(causal):
    """``fused_block_qkv_plain`` lays q, k and v out head-major as the first
    entry writes them; with ``fused_block_attn_plain`` it gives the CUDA-core
    entries' plain result."""
    ops = _operands(12, 2, 40, 128)
    args = _torch_args(ops, torch.bfloat16)
    x, scale, bias, w_qkv, b_qkv, w_proj, b_proj = args
    ws = fb.fused_block_qkv_plain(x, scale, bias, w_qkv, b_qkv, 2)
    assert ws.dtype == torch.bfloat16 and tuple(ws.shape) == (3, 2, 2, 40, 64)
    kv = fb.fused_block_kv_plain(x, scale, bias, w_qkv, b_qkv)
    torch.testing.assert_close(ws[1].transpose(1, 2).reshape(2, 40, 128).float(), kv[0].float(),
                               rtol=0, atol=2e-2)
    got = fb.fused_block_attn_plain(x, ws, w_proj, b_proj, 2, causal)
    want = fb.fused_block_q_plain(x, kv, *args[1:], 2, causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(fb.fused_block_plain(*args, 2, causal), got, rtol=0, atol=0)


def test_launchers_refuse_cpu_tensors():
    """The launch functions never fall back: a CPU tensor raises, and the
    tensor-core entries refuse what their shape rule does not take."""
    args = _torch_args(_operands())
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_kv(*args[:5])
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_q(args[0], torch.zeros(2, B, T, E), *args[1:], n_head=H)
    wide = _torch_args(_operands(e=128), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_qkv_tc(*wide[:5], n_head=2)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_block_attn_tc(wide[0], torch.zeros(3, B, 2, T, 64), *wide[5:], n_head=2)
    with pytest.raises(ValueError, match="tensor-core"):
        fb.fused_block_qkv_tc(*args[:5], n_head=H)     # float32, E 32


CUDA_CASES = [  # (B, T, E, heads, dtype, causal)
    (2, 64, 32, 4, torch.float32, True),
    (2, 64, 32, 4, torch.float32, False),
    (2, 1000, 768, 12, torch.bfloat16, True),     # ragged T
    (1, 300, 1024, 16, torch.float16, False),
    (1, 100, 96, 3, torch.float32, True),
    (2, 512, 768, 12, torch.float32, True),       # float32 at a GPT-2 width: the CUDA cores
    (2, 256, 768, 12, torch.bfloat16, True),
    (2, 256, 1024, 16, torch.bfloat16, True),
    (1, 256, 1600, 25, torch.bfloat16, True),     # GPT-2 1.5B's width
    (2, 200, 768, 6, torch.bfloat16, True),       # head dim 128
    (2, 200, 768, 24, torch.bfloat16, True),      # head dim 32
    (2, 256, 768, 12, torch.float16, True),
    (3, 37, 768, 12, torch.bfloat16, True),       # T < 64
    (2, 300, 768, 12, torch.bfloat16, False),     # not causal
    (1, 1024, 768, 12, torch.bfloat16, True),     # B 1
    (1, 200, 1024, 16, torch.float32, True),      # fault C3: float32 E 1024, 16 rows
    (2, 130, 1024, 8, torch.float32, False),      # fault C3: float32 heads of 128
    (1, 256, 1600, 20, torch.bfloat16, True),     # fault C3: bf16 heads of 80, CUDA cores
]


def _counts():
    return (fb.fused_transformer_block.launches, fb.fused_transformer_block.tc_launches,
            fb.fused_block_kv.launches, fb.fused_block_q.launches,
            fb.fused_block_qkv_tc.launches, fb.fused_block_attn_tc.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernels_match_plain_version(case):
    """Each case runs the design the shape rule names, once, within 2e-2 of
    max |ref| of the plain version in bf16/fp16 and 1e-4 in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, t, e, heads, dtype, causal = case
    args = [a.cuda() for a in _torch_args(_operands(8, b, t, e), dtype)]
    before = _counts()
    got = fb.fused_transformer_block(*args, heads, causal=causal)
    torch.cuda.synchronize()
    tc = fb.tensor_core_design(dtype, e, heads)
    assert tc is (dtype != torch.float32 and fb.tensor_core_plan(e, e // heads) is not None)
    step = (1, 1, 0, 0, 1, 1) if tc else (1, 0, 1, 1, 0, 0)
    assert _counts() == tuple(n + d for n, d in zip(before, step))
    cast = [args[0], args[1], args[2], args[3].to(dtype), args[4], args[5].to(dtype), args[6]]
    want = fb.fused_block_plain(*cast, heads, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    assert torch.isfinite(got).all() and err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("t", [256, 1000])
def test_cuda_tensor_core_entries_match_their_plain_versions(t):
    """Each entry of the tensor-core design against its plain version on the
    same inputs: the workspace within a bf16 ulp or two, the output within
    2e-2 of max |ref|; two launches are equal bit for bit (one CTA owns its
    rows: no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, scale, bias, w_qkv, b_qkv, w_proj, b_proj = (
        a.cuda() for a in _torch_args(_operands(13, 2, t, 768), torch.bfloat16))
    wq, wp = w_qkv.bfloat16(), w_proj.bfloat16()
    ws = fb.fused_block_qkv_tc(x, scale, bias, wq, b_qkv, n_head=12)
    ws_p = fb.fused_block_qkv_plain(x, scale, bias, wq, b_qkv, 12)
    out = fb.fused_block_attn_tc(x, ws_p, wp, b_proj, n_head=12)
    out_p = fb.fused_block_attn_plain(x, ws_p, wp, b_proj, 12)
    torch.cuda.synchronize()
    assert float((ws.float() - ws_p.float()).abs().max()) <= 2e-2 * float(ws_p.float().abs().max())
    assert float((out.float() - out_p.float()).abs().max()) <= 2e-2 * float(out_p.float().abs().max())
    again = fb.fused_block_attn_tc(x, fb.fused_block_qkv_tc(x, scale, bias, wq, b_qkv, n_head=12),
                                   wp, b_proj, n_head=12)
    first = fb.fused_block_attn_tc(x, ws, wp, b_proj, n_head=12)
    torch.cuda.synchronize()
    assert torch.equal(again, first)


@pytest.mark.cuda
def test_cuda_tensor_core_design_takes_operands_off_16_byte_boundaries():
    """Views that start 4 or 2 bytes into their storage (as slices of a flat
    parameter buffer may): the wrapper copies what TMA reads to an aligned
    start, and the kernels read the rest as they lie."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [a.cuda() for a in _torch_args(_operands(14, 2, 130, 768), torch.bfloat16)]
    shifted = []
    for i, a in enumerate(args):
        a = a.to(torch.bfloat16) if i in (3, 5) else a
        flat = torch.empty(a.numel() + 8, dtype=a.dtype, device="cuda")
        view = flat[1:1 + a.numel()].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16
        shifted.append(view)
    before = fb.fused_transformer_block.tc_launches
    got = fb.fused_transformer_block(*shifted, 12)
    want = fb.fused_block_plain(*args[:3], args[3].bfloat16(), args[4], args[5].bfloat16(),
                                args[6], 12)
    torch.cuda.synchronize()
    assert fb.fused_transformer_block.tc_launches == before + 1
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    assert err <= 2e-2, err


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
    before = _counts()
    args = [a.cuda() for a in _torch_args(_operands(b=1, t=8, e=2048))]   # float32 at E 2048
    with pytest.raises(ValueError, match="227 KB"):
        fb.fused_transformer_block(*args, 16)
    # float32 heads of 256: past the CUDA-core design's widest head
    args = [a.cuda() for a in _torch_args(_operands(e=512))]
    with pytest.raises(ValueError, match="head dim <= 128"):
        fb.fused_transformer_block(*args, 2)
    assert _counts() == before
