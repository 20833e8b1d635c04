"""Block-sparse attention of the PyTorch port against the JAX package.

On the CPU the port's ``block_sparse_attention`` runs its plain version
(``block_sparse_attention_reference``: dense float32 scores under the
layout's mask, autograd for the backward); the JAX side runs its Pallas
kernels in interpret mode, as tests/unit/test_sparse_attention.py does. Both
take the same numpy inputs. Tolerances: float32 1e-5 (summation order);
bf16 1e-2 absolute plus 1e-2 relative on values of magnitude ~1 (the two
sides round the probabilities and dS to bf16 at other points; measured at
most 0.64 of that). The CUDA kernels run only on the card: the
``cuda``-marked test holds them against the plain version there and skips
elsewhere. JAX is imported only by the tests that use it, so that on a
machine with a card and no JAX
``python -m pytest -m cuda --noconftest tests/test_torch_block_sparse_attention.py``
runs the kernel test.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as sa

B, H, T, D, BLOCK = 2, 2, 64, 16, 16


def _layout():
    """BigBird with a random block, one layout per head, then an empty q-row
    (block 1) and an empty k-column (block 2)."""
    layout = sa.BigBirdSparsityConfig(num_heads=H, block=BLOCK, different_layout_per_head=True,
                                      num_random_blocks=1).make_layout(T)
    layout[:, 1, :] = 0
    layout[:, :, 2] = 0
    return layout


def _inputs(shape=(B, H, T, D), seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def _jax(q, k, v, g, layout, block, causal, dtype):
    """(out, dq, dk, dv) of the JAX Pallas kernel in interpret mode."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.block_sparse_attention import block_sparse_attention
    dt = getattr(jnp, dtype)
    gj = jnp.asarray(g)

    def loss(q, k, v):
        out = block_sparse_attention(q, k, v, layout, block, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * gj), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, dt) for a in (q, k, v)))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port(q, k, v, g, layout, block, causal, dtype, fn=bsa.block_sparse_attention):
    qt, kt, vt = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                  for a in (q, k, v))
    out = fn(qt, kt, vt, layout, block, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [t.detach().float().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("causal,dtype,tol", [
    (False, "float32", 1e-5), (True, "float32", 1e-5), (True, "bfloat16", 1e-2)])
def test_plain_version_matches_jax_kernel(causal, dtype, tol):
    q, k, v, g = _inputs()
    layout = _layout()
    bsa.block_sparse_fwd.launches = 0
    got = _port(q, k, v, g, layout, BLOCK, causal, dtype)
    want = _jax(q, k, v, g, layout, BLOCK, causal, dtype)
    for a, b, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)
    # the empty q-row gives zero output, the empty k-column zero dk and dv
    rows, cols = slice(BLOCK, 2 * BLOCK), slice(2 * BLOCK, 3 * BLOCK)
    assert not got[0][:, :, rows].any() and not got[1][:, :, rows].any()
    assert not got[2][:, :, cols].any() and not got[3][:, :, cols].any()
    assert bsa.block_sparse_fwd.launches == 0     # CPU tensors: the plain version


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_dense_oracles(causal):
    """The reference and the port's copy of the dense-masked oracle against
    the JAX oracle, with the reference's lse against a direct logsumexp."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas.block_sparse_attention import (
        dense_blocksparse_attention as jax_dense)
    q, k, v, _ = _inputs(seed=1)
    layout = _layout()
    want = np.asarray(jax_dense(*(jnp.asarray(a) for a in (q, k, v)), layout, BLOCK,
                                causal=causal))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = bsa.block_sparse_attention_reference(qt, kt, vt, layout, BLOCK, causal)
    dense = bsa.dense_blocksparse_attention(qt, kt, vt, layout, BLOCK, causal)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(dense.numpy(), want, atol=1e-6, rtol=0)
    mask = bsa.layout_mask(layout, BLOCK, causal)
    s = torch.matmul(qt, kt.transpose(-1, -2)) / np.sqrt(D)
    direct = torch.logsumexp(s.masked_fill(~mask, -np.inf), -1)
    assert torch.isneginf(lse[:, :, BLOCK:2 * BLOCK]).all()
    torch.testing.assert_close(lse, direct, atol=1e-5, rtol=1e-5)


def test_sparse_self_attention_matches_jax():
    """Without a mask the layer runs block_sparse_attention (the JAX kernel in
    interpret mode on the JAX side); with a key-padding mask ("add" and
    "mul") the dense-masked path on both sides."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JaxFixed
    from deepspeed_tpu.ops.sparse_attention import SparseSelfAttention as JaxSSA
    q, k, v, _ = _inputs(seed=2)
    rng = np.random.RandomState(3)
    pad = np.where(rng.rand(B, T) < 0.25, -1e4, 0.0).astype(np.float32)
    keep = (rng.rand(B, T) > 0.25).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    for mode, mask in ((None, None), ("add", pad), ("mul", keep)):
        kw = {} if mode is None else {"key_padding_mask_mode": mode}
        mine = sa.SparseSelfAttention(sa.FixedSparsityConfig(num_heads=H, block=BLOCK), **kw)
        theirs = JaxSSA(JaxFixed(num_heads=H, block=BLOCK), **kw)
        got = mine(qt, kt, vt, key_padding_mask=None if mask is None else torch.from_numpy(mask))
        want = theirs(qj, kj, vj, key_padding_mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=str(mode))


def test_bert_sparse_self_attention_from_jax_weights():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import BertSparseSelfAttention as JaxBert
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JaxFixed
    hidden = H * D
    theirs = JaxBert(hidden, H, JaxFixed(num_heads=H, block=BLOCK))
    params = jax.tree_util.tree_map(np.asarray, theirs.init(jax.random.PRNGKey(0)))
    mine = sa.BertSparseSelfAttention(hidden, H, sa.FixedSparsityConfig(num_heads=H, block=BLOCK),
                                      device="cpu")
    mine.load_jax(params)
    x = np.random.RandomState(4).randn(B, T, hidden).astype(np.float32)
    mask = np.where(np.random.RandomState(5).rand(B, T) < 0.2, -1e4, 0.0).astype(np.float32)
    for m in (None, mask):
        want = theirs.apply(params, jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = mine(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        assert tuple(got.shape) == (B, T, hidden)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    mine.init(torch.Generator().manual_seed(0))
    assert float(mine.query_w.detach().std()) == pytest.approx(0.02, rel=0.1)
    assert not mine.value_b.any()


def test_bert_layer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sa.BertSparseSelfAttention(H * D, H)


def test_sparse_attention_utils_match_jax():
    import jax.numpy as jnp
    from deepspeed_tpu.ops.sparse_attention import SparseAttentionUtils as JaxUtils
    ids = np.arange(2 * 100, dtype=np.int64).reshape(2, 100) % 50
    mask = np.ones((2, 100), np.int64)
    embeds = np.random.RandomState(6).randn(2, 100, 8).astype(np.float32)
    table = np.random.RandomState(7).randn(50, 8).astype(np.float32)
    got = sa.SparseAttentionUtils.pad_to_block_size(
        64, torch.from_numpy(ids), torch.from_numpy(mask), pad_token_id=9)
    want = JaxUtils.pad_to_block_size(64, jnp.asarray(ids), jnp.asarray(mask), pad_token_id=9)
    assert got[0] == want[0] == 28
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = sa.SparseAttentionUtils.pad_to_block_size(
        64, None, inputs_embeds=torch.from_numpy(embeds), pad_token_id=3,
        model_embeddings=torch.from_numpy(table))
    want = JaxUtils.pad_to_block_size(64, None, inputs_embeds=jnp.asarray(embeds),
                                      pad_token_id=3, model_embeddings=jnp.asarray(table))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    out = sa.SparseAttentionUtils.unpad_sequence_output(28, got[5])
    np.testing.assert_array_equal(out.numpy(), embeds)
    pe = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    for n in (40, 10):
        np.testing.assert_array_equal(
            sa.SparseAttentionUtils.extend_position_embedding(torch.from_numpy(pe), n).numpy(),
            np.asarray(JaxUtils.extend_position_embedding(jnp.asarray(pe), n)))


@pytest.mark.parametrize("name", ["MatMul", "Softmax", "dense_to_sparse", "sparse_to_dense"])
def test_unported_parts_raise(name):
    """The package is whole now: these four come from its matmul.py and
    softmax.py (tests/test_torch_sparse_matmul_softmax.py holds them against
    the JAX package), and a name the JAX package lacks is an AttributeError."""
    import deepspeed_tpu.ops.sparse_attention as jsa
    assert callable(getattr(sa, name)) and callable(getattr(jsa, name))
    assert getattr(sa, name).__module__.startswith("deepspeed_tpu_torch.ops.sparse_attention.")
    with pytest.raises(AttributeError):
        getattr(sa, name + "Later")


def test_refusals():
    q = torch.zeros(1, H, T, D)
    with pytest.raises(ValueError, match="divisible"):
        bsa.block_sparse_attention(q[:, :, :60], q[:, :, :60], q[:, :, :60], _layout(), BLOCK)
    with pytest.raises(ValueError, match="layout shape"):
        bsa.block_sparse_attention(q, q, q, _layout()[:1], BLOCK)
    with pytest.raises(ValueError, match="layout shape"):
        bsa.block_sparse_attention(q, q, q, _layout(), 2 * BLOCK)
    with pytest.raises(TypeError):
        bsa.block_sparse_attention(q.double(), q.double(), q.double(), _layout(), BLOCK)


def test_launchers_validate_before_the_kernel():
    """The launch functions raise on what the kernels do not take, before any
    library is loaded (so this runs without a card)."""
    q = torch.zeros(1, H, T, D)
    lse = torch.zeros(1, H, T)
    luts = bsa.device_luts(_layout(), "cpu")
    kw = dict(block=BLOCK, causal=True, sm_scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        bsa.block_sparse_fwd(q, q, q, luts, **kw)
    with pytest.raises(ValueError, match="shape"):
        bsa.block_sparse_fwd(q, q, torch.zeros(1, H, T + 16, D), luts, **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        bsa.block_sparse_fwd(q, q, q, luts, **dict(kw, block=8))
    with pytest.raises(ValueError, match="256"):
        bsa.block_sparse_fwd(*(torch.zeros(1, H, T, 264),) * 3, luts, **kw)
    with pytest.raises(ValueError, match="LUT"):
        bsa.block_sparse_fwd(q, q, q, bsa.device_luts(_layout()[:1], "cpu"), **kw)
    with pytest.raises(TypeError):
        bsa.block_sparse_bwd_dq(q, q, q, q.bfloat16(), lse, lse, luts, **kw)
    with pytest.raises(ValueError, match="lse"):
        bsa.block_sparse_bwd_dkv(q, q, q, q, lse.double(), lse, luts, **kw)
    assert bsa.block_sparse_fwd.launches == 0


# --------------------------------------------------------------------- card
CUDA_CASES = [
    # (B, H, T, D, dtype, config, block, causal)
    (1, 4, 1024, 64, torch.bfloat16, "variable", 256, True),
    (2, 2, 256, 64, torch.float32, "fixed", 16, True),
    (1, 2, 512, 128, torch.float16, "bigbird", 64, True),
    (2, 2, 256, 40, torch.float32, "empty", 32, False),
    (1, 2, 256, 256, torch.bfloat16, "longformer", 64, False),
]


def _cuda_layout(name, H_, T_, block):
    if name == "variable":
        return sa.VariableSparsityConfig(num_heads=H_, block=block, local_window_blocks=[3],
                                         global_block_indices=[0],
                                         attention="unidirectional").make_layout(T_)
    if name == "fixed":
        return sa.FixedSparsityConfig(num_heads=H_, block=block,
                                      attention="unidirectional").make_layout(T_)
    if name == "bigbird":
        return sa.BigBirdSparsityConfig(num_heads=H_, block=block, num_random_blocks=2,
                                        different_layout_per_head=True).make_layout(T_)
    if name == "longformer":
        return sa.BSLongformerSparsityConfig(num_heads=H_, block=block).make_layout(T_)
    layout = np.ones((H_, T_ // block, T_ // block), np.int64)
    layout[:, 2, :] = 0
    layout[:, :, 5] = 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_kernels_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Bc, Hc, Tc, Dc, dtype, name, block, causal = case
    layout = _cuda_layout(name, Hc, Tc, block)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((Bc, Hc, Tc, Dc), generator=gen, device="cuda")
                  for _ in range(4))

    def run(kernel):
        qs, ks, vs = (t.to(dtype).requires_grad_() for t in (q, k, v))
        if kernel:
            out = bsa.block_sparse_attention(qs, ks, vs, layout, block, causal=causal)
            _, lse = bsa.block_sparse_fwd(qs.detach(), ks.detach(), vs.detach(),
                                          bsa.device_luts(layout, qs.device), block=block,
                                          causal=causal, sm_scale=Dc ** -0.5)
        else:
            out, lse = bsa.block_sparse_attention_reference(qs, ks, vs, layout, block, causal)
        (out.float() * g).sum().backward()
        return [t.detach().float() for t in (out, lse, qs.grad, ks.grad, vs.grad)]

    before = [f.launches for f in (bsa.block_sparse_fwd, bsa.block_sparse_bwd_dq,
                                   bsa.block_sparse_bwd_dkv)]
    got, want = run(True), run(False)
    torch.cuda.synchronize()
    assert [f.launches for f in (bsa.block_sparse_fwd, bsa.block_sparse_bwd_dq,
                                 bsa.block_sparse_bwd_dkv)] == [before[0] + 2, before[1] + 1,
                                                                before[2] + 1]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, out_name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        assert torch.isfinite(a).all() or out_name == "lse", out_name
        err = torch.where(a == b, 0.0, (a - b).abs())
        scale = float(b[torch.isfinite(b)].abs().max()) + 1e-6
        assert float(err.max()) / scale <= tol, f"{out_name}: {float(err.max()) / scale} > {tol}"
