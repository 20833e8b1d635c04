"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain version (dense float32
softmax, autograd backward); the JAX side runs its Pallas kernels in
interpret mode, as tests/unit/test_flash_attention.py does. Both take the
same numpy inputs. The CUDA kernels run only on the card: the ``cuda``-marked
test holds them against the plain version there and skips elsewhere. JAX is
imported only by the tests that use it, so that on a machine with a card and
no JAX ``python -m pytest -m cuda --noconftest tests/test_torch_flash_attention.py``
runs the kernel test.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as fa

B, H, T, D = 2, 2, 64, 16


def _inputs(shape=(B, H, T, D), seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    g_lse = rng.randn(*shape[:3]).astype(np.float32)
    bias = np.where(rng.rand(shape[0], shape[2]) < 0.2, -1e4, 0.0).astype(np.float32)
    return q, k, v, g, g_lse, bias


def _jax(q, k, v, g, dtype, g_lse=None, **kw):
    """(out, dq, dk, dv) of the JAX Pallas kernel in interpret mode under the
    cotangent g (and g_lse on the lse output when given)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.flash_attention import (
        flash_attention, flash_attention_with_lse)
    dt = getattr(jnp, dtype)
    qj, kj, vj = (jnp.asarray(a, dt) for a in (q, k, v))
    gj = jnp.asarray(g, jnp.float32)

    def loss(q, k, v):
        if g_lse is None:
            out = flash_attention(q, k, v, interpret=True, **kw)
            return jnp.sum(out.astype(jnp.float32) * gj), out
        out, lse = flash_attention_with_lse(q, k, v, interpret=True, **kw)
        return (jnp.sum(out.astype(jnp.float32) * gj)
                + jnp.sum(lse * jnp.asarray(g_lse)), out)

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(qj, kj, vj)
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port(q, k, v, g, dtype, g_lse=None, fn=fa.flash_attention, **kw):
    dt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v))
    res = fn(qt, kt, vt, **kw)
    if g_lse is None:
        out = res
        loss = (out.float() * torch.from_numpy(g)).sum()
    else:
        out, lse = res
        loss = ((out.float() * torch.from_numpy(g)).sum()
                + (lse * torch.from_numpy(g_lse)).sum())
    loss.backward()
    return [t.detach().float().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


def _close(got, want, atol, rtol=0.0):
    for a, b, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("causal,dtype,atol", [
    (False, "float32", 2e-5), (True, "float32", 2e-5), (True, "bfloat16", 2e-2)])
def test_plain_flash_matches_jax_kernel(causal, dtype, atol):
    q, k, v, g, _, _ = _inputs()
    fa.flash_attention_fwd.launches = 0
    got = _port(q, k, v, g, dtype, causal=causal)
    want = _jax(q, k, v, g, dtype, causal=causal)
    # bf16: both sides round differently (the kernel rounds the scaled q to
    # bf16), so the error is a few bf16 ulps of values of magnitude ~1
    _close(got, want, atol, rtol=atol)
    # CPU tensors take the plain version: no kernel launched
    assert fa.flash_attention_fwd.launches == 0


def test_plain_flash_key_bias_matches_jax_kernel():
    q, k, v, g, _, bias = _inputs(seed=1)
    got = _port(q, k, v, g, "float32", bias=torch.from_numpy(bias[:, None, None, :]))
    want = _jax(q, k, v, g, "float32", bias=bias[:, None, None, :])
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_gradient_folds_into_delta(causal):
    q, k, v, g, g_lse, _ = _inputs(seed=2)
    got = _port(q, k, v, g, "float32", g_lse=g_lse, fn=fa.flash_attention_with_lse,
                causal=causal)
    want = _jax(q, k, v, g, "float32", g_lse=g_lse, causal=causal)
    _close(got, want, 2e-5)


def test_merge_partial_of_key_chunks_is_the_whole():
    """Non-causal attention over square chunk pairs, each query chunk's
    partials merged by their lse (the JAX chunked path's combine), equals
    attention over all keys; JAX's merge gives the same numbers."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.flash_attention import _merge_partial as jax_merge
    q, k, v, _, _, _ = _inputs(seed=6)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    h = T // 2
    outs, lses = [], []
    for i in range(2):
        qi = qt[:, :, i * h:(i + 1) * h]
        (o1, l1), (o2, l2) = (fa.flash_attention_with_lse(
            qi, kt[:, :, c * h:(c + 1) * h], vt[:, :, c * h:(c + 1) * h]) for c in range(2))
        o, lse = fa._merge_partial(o1.float(), l1, o2, l2)
        jo, jl = jax_merge(*(jnp.asarray(t.numpy()) for t in (o1.float(), l1, o2, l2)))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
        outs.append(o)
        lses.append(lse)
    want_o, want_l = fa.flash_attention_with_lse(qt, kt, vt)
    torch.testing.assert_close(torch.cat(outs, 2), want_o, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.cat(lses, 2), want_l, atol=1e-5, rtol=1e-5)


def test_lse_is_logsumexp_of_scaled_scores():
    q, k, v, _, _, _ = _inputs(seed=3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = fa.flash_attention_with_lse(qt, kt, vt, causal=True)
    s = torch.matmul(qt, kt.transpose(-1, -2)) / np.sqrt(D)
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -np.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed,rate", [(4242, 0.15), (-7, 0.5), (2**31 - 1, 0.01)])
def test_dropout_keep_reference_bit_equal_to_jax(seed, rate):
    from deepspeed_tpu.ops.pallas.flash_attention import (
        dropout_keep_reference as jax_keep)
    want = np.asarray(jax_keep(seed, 2, 3, 40, 56, rate))
    got = fa.dropout_keep_reference(seed, 2, 3, 40, 56, rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_matches_jax_kernel(causal):
    """The port's plain dropout path against the JAX kernel's in-kernel
    dropout (test_flash_attention.py:102-128's tolerances)."""
    q, k, v, g, _, _ = _inputs((2, 2, 128, 32), seed=4)
    kw = dict(causal=causal, dropout_rate=0.15, dropout_seed=4242)
    got = _port(q, k, v, g, "float32", **kw)
    want = _jax(q, k, v, g, "float32", block_q=64, block_k=64, **kw)
    _close(got, want, 2e-4, rtol=2e-4)


@pytest.mark.parametrize("causal,rate,offsets", [
    (False, 0.15, (128, 0)),    # offsets move the dropout hash only
    (True, 0.0, (64, 64)),      # equal offsets: the causal mask as at (0, 0)
    (True, 0.15, (64, 64))])
def test_offsets_match_jax_kernel(causal, rate, offsets):
    """``flash_attention_with_lse`` with global offsets against the JAX
    kernel (out, dq, dk, dv under an lse cotangent too), at the dropout
    tolerance of test_dropout_matches_jax_kernel."""
    q, k, v, g, g_lse, _ = _inputs((2, 2, 128, 32), seed=8)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=4242 if rate else None,
              dropout_q_offset=offsets[0], dropout_k_offset=offsets[1])
    got = _port(q, k, v, g, "float32", g_lse=g_lse, fn=fa.flash_attention_with_lse, **kw)
    want = _jax(q, k, v, g, "float32", g_lse=g_lse, block_q=64, block_k=64, **kw)
    _close(got, want, 2e-4, rtol=2e-4)


@pytest.mark.parametrize("rate,offsets", [
    (0.0, (128, 0)), (0.1, (128, 0)), (0.0, (0, 128)), (0.1, (64, 0))])
def test_causal_unequal_offsets_refused(rate, offsets):
    """Fault C1: the JAX kernels give no single answer for a causal call
    with unequal offsets (local coordinates without dropout, global ones only
    inside their diagonal k-block band with it), so the port refuses it."""
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="item 14"):
        fa.flash_attention_with_lse(q, q, q, causal=True, dropout_rate=rate,
                                    dropout_seed=1 if rate else None,
                                    dropout_q_offset=offsets[0], dropout_k_offset=offsets[1])
    # the same offsets without the causal mask are fine
    out, _ = fa.flash_attention_with_lse(q, q, q, dropout_rate=rate,
                                         dropout_seed=1 if rate else None,
                                         dropout_q_offset=offsets[0],
                                         dropout_k_offset=offsets[1])
    assert out.shape == q.shape


def test_long_sequence_takes_the_plain_version_directly():
    """No VMEM ceiling: T > 8192 runs as one call (B = H = 1, tiny D)."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, 1, 8200, 2).astype(np.float32))
    out = fa.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_refusals():
    q = torch.zeros(1, 1, 8, 4)
    # a causal segmented call needs one map on both sides that keeps the
    # local order (the kernels prune causal tiles in local coordinates)
    for seg in (dict(q_segments=(0, 8)), dict(k_segments=(0, 8)),
                dict(q_segments=(0, 8), k_segments=(0, 12)),
                dict(q_segments=(8, 0), k_segments=(8, 0))):
        with pytest.raises(ValueError, match="segments"):
            fa.flash_attention_with_lse(q, q, q, causal=True, **seg)
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention(torch.zeros(1, 1, 8, 3), torch.zeros(1, 1, 8, 3),
                           torch.zeros(1, 1, 8, 3))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), q.double(), q.double())


def test_launchers_validate_before_the_kernel():
    """The launch functions raise on what the kernels do not take, before any
    library is loaded (so this runs without a card)."""
    q = torch.zeros(1, 2, 8, 4)
    lse = torch.zeros(1, 2, 8)
    kw = dict(causal=True, sm_scale=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q, **kw)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, q, torch.zeros(1, 2, 9, 4), **kw)
    with pytest.raises(ValueError, match="even"):
        fa.flash_attention_fwd(*(torch.zeros(1, 2, 8, 3),) * 3, **kw)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd_dq(q, q, q, q.bfloat16(), lse, lse, **kw)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dkv(q, q, q, q, lse.double(), lse, **kw)
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention_fwd(q, q, q, bias=torch.zeros(1, 1, 8), **kw)
    assert fa.flash_attention_fwd.launches == 0


@pytest.mark.parametrize("dtype,D,tensor_cores", [
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True), (torch.float16, 64, True),
    (torch.float16, 128, True), (torch.bfloat16, 40, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 36, False), (torch.bfloat16, 136, False), (torch.bfloat16, 256, False),
    (torch.float16, 256, False)])
def test_tensor_core_path_shape_rule(dtype, D, tensor_cores):
    """16-bit operands with D <= 128 a multiple of 8 take the tensor-core
    kernels; float32, D > 128 and D not a multiple of 8 the CUDA-core ones."""
    assert fa._tensor_core_path(dtype, D) is tensor_cores


def test_cpu_tensors_of_a_tensor_core_shape_take_the_plain_version():
    """bf16 at D = 64 is a tensor-core shape, but CPU tensors run the plain
    version: no kernel of either design is launched, and the result is the
    plain version's."""
    q, k, v, _, _, _ = _inputs((1, 2, 48, 64), seed=7)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)

    def counts():
        return [(f.launches, f.tensor_core_launches) for f in launchers]

    before = counts()
    qs, ks, vs = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out, lse = fa.flash_attention_with_lse(qs, ks, vs, causal=True)
    want_out, want_lse = fa.flash_attention_reference(qt, kt, vt, causal=True)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    (out.float().sum() + lse.sum()).backward()    # the backward: no dq or dk/dv kernel
    assert counts() == before


# --------------------------------------------------------------------- card
CUDA_CASES = [
    # (B, H, T, D, dtype, causal, bias, rate, (q_offset, k_offset))
    (2, 3, 128, 64, torch.bfloat16, True, False, 0.0, (0, 0)),
    (2, 3, 200, 64, torch.bfloat16, True, False, 0.0, (0, 0)),      # ragged tail
    (1, 2, 130, 128, torch.float16, False, True, 0.0, (0, 0)),      # key bias
    (1, 2, 96, 256, torch.float32, True, False, 0.0, (0, 0)),       # D = 256
    (2, 2, 160, 32, torch.float32, False, False, 0.1, (0, 0)),      # dropout
    (1, 2, 77, 40, torch.float32, True, False, 0.0, (0, 0)),        # D not a tile width
    (2, 2, 192, 64, torch.bfloat16, False, True, 0.0, (0, 0)),      # tensor cores: bias
    (1, 2, 320, 128, torch.float16, False, True, 0.0, (0, 0)),      # tensor cores: D 128, bias
    (2, 2, 256, 64, torch.bfloat16, True, False, 0.1, (0, 0)),      # tensor cores: dropout
    (2, 2, 256, 64, torch.bfloat16, True, False, 0.5, (0, 0)),
    (1, 2, 1, 64, torch.bfloat16, True, False, 0.0, (0, 0)),        # tensor cores: T = 1
    (1, 2, 17, 64, torch.bfloat16, True, False, 0.0, (0, 0)),       # T = 17
    (1, 2, 64, 256, torch.bfloat16, True, False, 0.0, (0, 0)),      # bf16 past the rule: CUDA cores
    (2, 2, 192, 32, torch.bfloat16, True, False, 0.0, (0, 0)),      # tensor cores: D = 32
    (1, 3, 150, 32, torch.float16, False, True, 0.0, (0, 0)),       # D = 32, bias
    (2, 2, 256, 64, torch.bfloat16, False, False, 0.1, (128, 0)),   # offsets: dropout hash
    (2, 2, 256, 64, torch.bfloat16, True, False, 0.1, (256, 256)),  # offsets: causal, equal
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES,
                         ids=lambda c: "-".join(map(str, c if any(c[8]) else c[:8])))
def test_cuda_kernels_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Bc, Hc, Tc, Dc, dtype, causal, with_bias, rate, (q_off, k_off) = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((Bc, Hc, Tc, Dc), generator=gen, device="cuda")
                  for _ in range(4))
    g_lse = torch.randn((Bc, Hc, Tc), generator=gen, device="cuda")
    bias = (torch.where(torch.rand((Bc, 1, 1, Tc), generator=gen, device="cuda") < 0.2,
                        -1e4, 0.0) if with_bias else None)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=11 if rate else None)

    def run(kernel):
        qs, ks, vs = (t.to(dtype).requires_grad_() for t in (q, k, v))
        if kernel:
            out, lse = fa._attend(qs, ks, vs, causal, None, bias, rate, kw["dropout_seed"],
                                  q_off, k_off)
        else:
            b = None if bias is None else bias.reshape(Bc, Tc)
            out, lse = fa.flash_attention_reference(qs, ks, vs, bias=b, q_offset=q_off,
                                                    k_offset=k_off, **kw)
        ((out.float() * g).sum() + (lse * g_lse).sum()).backward()
        return [t.detach().float() for t in (out, lse, qs.grad, ks.grad, vs.grad)]

    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(f.launches, f.tensor_core_launches) for f in launchers]
    got, want = run(True), run(False)
    torch.cuda.synchronize()
    # which design ran: the shape rule, counted by the wrappers
    tc = int(fa._tensor_core_path(dtype, Dc))
    assert [(f.launches, f.tensor_core_launches) for f in launchers] == [
        (n + 1, n_tc + tc) for n, n_tc in before]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        scale = float(b.abs().max()) + 1e-6
        err = float((a - b).abs().max()) / scale
        assert err <= tol, f"{name}: max abs err / max |ref| = {err} > {tol}"


SEGMENTED_CUDA_CASES = [
    # (B, H, T, D, dtype, causal, rate, q_segments, k_segments): the zigzag
    # ring's rotation-0 maps of rank 0 and rank 1 of a ring of 2, a half
    # boundary inside a kernel tile (T 96: 48), one side segmented
    (1, 3, 256, 64, torch.bfloat16, True, 0.1, (0, 384), (0, 384)),
    (1, 3, 256, 64, torch.bfloat16, True, 0.1, (128, 256), (128, 256)),
    (1, 3, 96, 64, torch.bfloat16, True, 0.0, (48, 144), (48, 144)),
    (1, 3, 96, 64, torch.float32, True, 0.1, (48, 144), (48, 144)),
    (1, 2, 256, 128, torch.float16, False, 0.1, (64, 512), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGMENTED_CUDA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_segmented_kernels_match_plain_version(case):
    """The three kernels with the segment map (the mask and the hash in
    global coordinates) against the plain version, gradients included, and
    counted as segmented launches of the design the shape rule names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Bc, Hc, Tc, Dc, dtype, causal, rate, q_seg, k_seg = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g = (torch.randn((Bc, Hc, Tc, Dc), generator=gen, device="cuda")
                  for _ in range(4))
    g_lse = torch.randn((Bc, Hc, Tc), generator=gen, device="cuda")
    seed = 7 if rate else None

    def run(kernel):
        qs, ks, vs = (t.to(dtype).requires_grad_() for t in (q, k, v))
        if kernel:
            out, lse = fa._attend(qs, ks, vs, causal, None, None, rate, seed, 0, 0, q_seg, k_seg)
        else:
            out, lse = fa.flash_attention_reference(qs, ks, vs, causal, dropout_rate=rate,
                                                    dropout_seed=seed, q_segments=q_seg,
                                                    k_segments=k_seg)
        ((out.float() * g).sum() + (lse * g_lse).sum()).backward()
        return [t.detach().float() for t in (out, lse, qs.grad, ks.grad, vs.grad)]

    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [(f.launches, f.tensor_core_launches, f.segmented_launches) for f in launchers]
    got, want = run(True), run(False)
    torch.cuda.synchronize()
    tc = int(fa._tensor_core_path(dtype, Dc))
    assert [(f.launches, f.tensor_core_launches, f.segmented_launches) for f in launchers] == [
        (n + 1, n_tc + tc, n_seg + 1) for n, n_tc, n_seg in before]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        err = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-6)
        assert err <= tol, f"{name}: max abs err / max |ref| = {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("policy,forwards", [("dots+attn", 1), ("dots", 2)])
def test_cuda_selective_checkpoint_keeps_or_replays_the_forward(policy, forwards):
    """Under a remat policy that keeps the attention outputs the forward
    kernel runs once (the op's (out, lse) are kept for the backward); under
    "dots" the backward replays it. The gradients equal the run without a
    checkpoint bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 128, 64), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = torch.randn((64, 192), generator=gen, device="cuda", dtype=torch.bfloat16) * 0.1

    def block(x, w):
        q, k, v = (t.reshape(2, 128, 2, 32).transpose(1, 2) for t in (x @ w).split(64, -1))
        return fa.flash_attention(q, k, v, True).transpose(1, 2).reshape(2, 128, 64)

    def grads(fn):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xs, ws).float().square().sum().backward()
        return xs.grad, ws.grad

    want = grads(block)
    launchers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [f.launches for f in launchers]
    got = grads(checkpointing.checkpoint_wrapper(block, policy=policy))
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(launchers, before)] == [forwards, 1, 1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
