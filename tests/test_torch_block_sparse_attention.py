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


# ------------------------------------------------- the tensor-core design's rule
DESIGN_CASES = [  # (case, dtype, D, block, tensor cores?): chip_smoke.py's _bs_cases
    ("variable-256 (main)", torch.bfloat16, 64, 256, True),
    ("fixed-16", torch.float32, 64, 16, False),
    ("bigbird-64", torch.bfloat16, 64, 64, True),
    ("variable-128-d128", torch.float16, 128, 128, True),
    ("longformer-64-d256", torch.bfloat16, 256, 64, False),
    ("fixed-32-bidirectional", torch.bfloat16, 64, 32, False),
    ("empty-row-col-64-d40", torch.float32, 40, 64, False),
    ("empty-64-bf16", torch.bfloat16, 64, 64, True),
    ("bigbird-bidirectional-causal", torch.bfloat16, 64, 64, True),
    ("variable-128-d80", torch.float16, 80, 128, True),
    ("d-not-multiple-of-8", torch.bfloat16, 36, 64, False),
]


@pytest.mark.parametrize("case", DESIGN_CASES, ids=lambda c: c[0])
def test_shape_rule_picks_the_design(case):
    _, dtype, d, block, tc = case
    assert bsa.tensor_core_path(dtype, d, block) is tc


def test_cta_rows_lie_in_one_layout_line():
    """Two warpgroups only where the block holds 128 rows whole, and for
    dk/dv only at D <= 64."""
    assert bsa.cta_rows(False, 128, 256) == 128 and bsa.cta_rows(True, 64, 256) == 128
    assert bsa.cta_rows(True, 128, 256) == 64
    assert bsa.cta_rows(False, 64, 64) == 64 and bsa.cta_rows(True, 64, 192) == 64


def _work_layouts():
    empty = np.ones((2, 8, 8), np.int64)
    empty[:, 3, :] = 0
    empty[:, :, 5] = 0
    return {
        "variable": (sa.VariableSparsityConfig(num_heads=4, block=256, local_window_blocks=[3],
                                               global_block_indices=[0],
                                               attention="unidirectional").make_layout(8192),
                     256),
        "bigbird": (sa.BigBirdSparsityConfig(num_heads=2, block=64, num_random_blocks=2,
                                             different_layout_per_head=True).make_layout(2048),
                    64),
        "longformer": (sa.BSLongformerSparsityConfig(num_heads=2, block=128).make_layout(4096),
                       128),
        "empty": (empty, 64),
    }


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("transposed", [True, False], ids=["dkv", "dq"])
@pytest.mark.parametrize("name", ["variable", "bigbird", "longformer", "empty"])
def test_work_list_covers_each_pair_once(name, transposed, causal):
    """Every (row block, column block) pair of the LUT, for every CTA tile of
    rows, is walked by exactly one item; no item takes more steps than the
    bound, which is the balanced share over the SMs."""
    layout, block = _work_layouts()[name]
    counts, cols, counts_t, rows_t = bsa.build_luts(layout)
    counts, lut = (counts_t, rows_t) if transposed else (counts, cols)
    nb = layout.shape[1]
    rows = bsa.cta_rows(transposed, 64, block)
    w = bsa.build_work(counts, lut, nb, block, causal, rows, transposed)
    seen = {}
    for line, tile, first, last, group, part, parts, ws in w.items.tolist():
        for slot in range(first, last):
            key = (line, tile, int(lut[line, slot]))
            assert key not in seen, key
            seen[key] = (group, part)
        assert 0 <= part < parts and (group == -1) is (parts == 1)
    want = {(line, t, int(lut[line, s])) for line in range(len(counts))
            for t in range(block // rows) for s in range(counts[line])}
    assert set(seen) == want
    # every (line, tile) has an item, even one with no slot: it writes zeros
    assert {(i[0], i[1]) for i in w.items.tolist()} == {
        (line, t) for line in range(len(counts)) for t in range(block // rows)}
    assert (w.steps <= w.bound).all() and list(w.steps) == sorted(w.steps, reverse=True)
    assert w.bound == max(-(-int(w.steps.sum()) // 132), block // 64)
    assert w.ws_parts == sum(1 for i in w.items if i[4] >= 0)


def test_long_path_global_column_is_split():
    """The slice's layout (Variable, block 256, T 8192, 16 heads, causal):
    column 0 holds 128 tile steps a CTA against a balanced share of 82 over
    132 SMs, so each of its CTAs is cut in two of 64; no other column is."""
    layout = sa.VariableSparsityConfig(num_heads=16, block=256, local_window_blocks=[3],
                                       global_block_indices=[0],
                                       attention="unidirectional").make_layout(8192)
    _, _, counts_t, rows_t = bsa.build_luts(layout)
    w = bsa.build_work(counts_t, rows_t, 32, 256, True, 128, True)
    assert w.bound == 82 and int(w.steps.sum()) == 10752
    split = w.items[w.items[:, 4] >= 0]
    assert sorted(set(split[:, 0] % 32)) == [0] and w.n_groups == 32 and len(split) == 64
    assert (split[:, 6] == 2).all() and int(w.steps.max()) == 64
    # dq is balanced there: at most 4 active blocks a row, 16 tile steps
    counts, cols = bsa.build_luts(layout)[:2]
    wq = bsa.build_work(counts, cols, 32, 256, True, 128, False)
    assert wq.n_groups == 0 and int(wq.steps.max()) == 16


def _tc_walk(layout, block, causal, transposed, B, D, n_sm):
    """The tensor-core kernels' walk: per batch copy and work item of
    ``build_work``, ``(b, h, own0, rows, group, part, parts, steps)``, steps
    being the (other side's tile start o0, warpgroup wg, its first row w0)
    that compute, in the order the producer stages them, after its causal
    skip of tiles wholly masked for the CTA and each warpgroup's for its own
    64 rows."""
    nb = layout.shape[1]
    counts, cols, counts_t, rows_t = bsa.build_luts(layout)
    counts, lut = (counts_t, rows_t) if transposed else (counts, cols)
    rows = bsa.cta_rows(transposed, D, block)
    w = bsa.build_work(counts, lut, nb, block, causal, rows, transposed, B, n_sm)
    for b in range(B):
        for line, tile, first, last, group, part, n_parts, _ in w.items.tolist():
            h, r = divmod(line, nb)
            own0 = r * block + tile * rows
            steps = []
            for slot in range(first, last):
                for j in range(block // 64):
                    o0 = int(lut[line, slot]) * block + 64 * j
                    if causal and (o0 + 63 < own0 if transposed else o0 > own0 + rows - 1):
                        continue        # the producer's skip
                    for wg in range(rows // 64):
                        w0 = own0 + 64 * wg
                        if causal and (o0 + 63 < w0 if transposed else o0 > w0 + 63):
                            continue    # the warpgroup's skip
                        steps.append((o0, wg, w0))
            yield b, h, own0, rows, group, part, n_parts, steps


def _emulate_tc(q, k, v, do, lse, delta, layout, block, causal, transposed, n_sm):
    """The tensor-core backward kernels' walk in float64 numpy: per work
    item, the producer's tile skip, each warpgroup's skip and diagonal test,
    and the split lines' parts summed in part order. Returns dq or (dk,
    dv)."""
    B, H, T, D = q.shape
    scale = D ** -0.5
    outs = [np.zeros_like(q) for _ in range(2 if transposed else 1)]
    parts = {}
    for b, h, own0, rows, group, part, n_parts, steps in _tc_walk(
            layout, block, causal, transposed, B, D, n_sm):
        acc = [np.zeros((rows, D)) for _ in outs]
        for o0, wg, w0 in steps:
            qs = slice(o0, o0 + 64) if transposed else slice(w0, w0 + 64)
            ks = slice(w0, w0 + 64) if transposed else slice(o0, o0 + 64)
            s = q[b, h, qs] @ k[b, h, ks].T
            lrow = lse[b, h, qs][:, None]
            p = np.where(np.isneginf(lrow), 0.0, np.exp(s * scale - lrow))
            if causal and o0 == w0:
                p = np.where(np.arange(64)[:, None] >= np.arange(64)[None, :], p, 0.0)
            ds = p * (do[b, h, qs] @ v[b, h, ks].T - delta[b, h, qs][:, None])
            mine = slice(64 * wg, 64 * wg + 64)
            if transposed:
                acc[0][mine] += ds.T @ q[b, h, qs]
                acc[1][mine] += p.T @ do[b, h, qs]
            else:
                acc[0][mine] += ds @ k[b, h, ks]
        if group >= 0:
            parts.setdefault((b, group), {})[part] = acc
            if len(parts[(b, group)]) < n_parts:
                continue
            got = parts[(b, group)]
            acc = [sum(got[p_][i] for p_ in range(n_parts)) for i in range(len(outs))]
        for out, a, f in zip(outs, acc, (scale, 1.0)):
            out[b, h, own0:own0 + rows] = a * f
    return outs


def _emulate_tc_fwd(q, k, v, layout, block, causal, n_sm, dtype=torch.bfloat16):
    """The tensor-core forward's walk in float64 numpy: per work item, each
    warpgroup's online softmax over its 64-key tiles in the order the
    producer stages them (only the diagonal tile tested element by element;
    a row with no allowed key so far keeps m = -inf and p = 0), p rounded to
    ``dtype`` before p.v, l unrounded; a split row's parts merged in part
    order (M = max m_p, L = sum l_p e^(m_p - M), acc = sum acc_p e^(m_p - M),
    a part at m_p = -inf adding 0). Returns (out rounded to ``dtype``,
    lse)."""
    B, H, T, D = q.shape
    scale = D ** -0.5

    def rnd(a):
        return torch.from_numpy(a).to(dtype).double().numpy()

    def shift(m):     # the max where a row has one, else 0: no -inf - -inf
        return np.where(np.isfinite(m), m, 0.0)

    out, lse = np.zeros_like(q), np.zeros(q.shape[:3])
    parts = {}
    for b, h, own0, rows, group, part, n_parts, steps in _tc_walk(
            layout, block, causal, False, B, D, n_sm):
        m, l, acc = np.full(rows, -np.inf), np.zeros(rows), np.zeros((rows, D))
        for k0, wg, w0 in steps:
            mine = slice(64 * wg, 64 * wg + 64)
            s = q[b, h, w0:w0 + 64] @ k[b, h, k0:k0 + 64].T * scale
            if causal and k0 == w0:
                s = np.where(np.arange(64)[:, None] >= np.arange(64)[None, :], s, -np.inf)
            m_new = np.maximum(m[mine], s.max(-1))
            alive = np.isfinite(m_new)
            alpha = np.where(alive, np.exp(m[mine] - shift(m_new)), 1.0)
            p = np.where(alive[:, None], np.exp(s - shift(m_new)[:, None]), 0.0)
            l[mine] = l[mine] * alpha + p.sum(-1)
            acc[mine] = acc[mine] * alpha[:, None] + rnd(p) @ v[b, h, k0:k0 + 64]
            m[mine] = m_new
        if group >= 0:
            parts.setdefault((b, group), {})[part] = (m, l, acc)
            if len(parts[(b, group)]) < n_parts:
                continue
            got = [parts[(b, group)][p_] for p_ in range(n_parts)]
            m = np.max([g_[0] for g_ in got], axis=0)
            l, acc = np.zeros(rows), np.zeros((rows, D))
            for mp, lp, ap in got:
                f = np.where(np.isfinite(mp), np.exp(shift(mp) - shift(m)), 0.0)
                l, acc = l + lp * f, acc + ap * f[:, None]
        li = np.maximum(l, 1e-30)
        out[b, h, own0:own0 + rows] = rnd(acc / li[:, None])
        lse[b, h, own0:own0 + rows] = m + np.log(li)
    return out, lse


def _walk_layout(name, h, t, block):
    if name == "variable":
        return sa.VariableSparsityConfig(num_heads=h, block=block, local_window_blocks=[1],
                                         global_block_indices=[0],
                                         attention="unidirectional").make_layout(t)
    if name == "bigbird-bidirectional":
        return sa.BigBirdSparsityConfig(num_heads=h, block=block, num_random_blocks=1,
                                        different_layout_per_head=True).make_layout(t)
    if name == "longformer":
        return sa.BSLongformerSparsityConfig(num_heads=h, block=block).make_layout(t)
    layout = np.ones((h, t // block, t // block), np.int64)
    layout[:, 3, :] = 0
    layout[:, :, 5] = 0
    return layout


@pytest.mark.parametrize("case", [
    ("variable", 4, 512, 128, True, 16), ("bigbird-bidirectional", 2, 512, 64, True, 64),
    ("empty", 2, 512, 64, False, 64), ("longformer", 2, 1024, 128, True, 132)],
    ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}")
def test_tensor_core_walk_matches_plain_version(case):
    """The items, skips, diagonal tests and merges of the tensor-core
    kernels, emulated in float64, give the plain version's gradients (few
    SMs, so that heavy lines are split). The plain version computes in
    float32: tolerance 1e-5 on values of magnitude ~0.1-1."""
    name, h, t, block, causal, n_sm = case
    layout = _walk_layout(name, h, t, block)
    shape = (1, h, t, 64)
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(shape, seed=7))
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = bsa.block_sparse_attention_reference(qs, ks, vs, layout, block, causal)
    (out * do).sum().backward()
    delta = (do * out.detach()).sum(-1)
    args = [x.numpy() for x in (q, k, v, do, lse, delta)]
    for transposed, want in ((False, (qs.grad,)), (True, (ks.grad, vs.grad))):
        got = _emulate_tc(*args, layout, block, causal, transposed, n_sm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-5)


def _jax_fwd(q, k, v, layout, block, causal, dtype):
    """(out, lse) of the JAX package's Pallas forward in interpret mode, at
    the row grouping its ``block_sparse_attention`` picks."""
    import jax.numpy as jnp
    from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
    group = jbsa._pick_group(layout.shape[1], block)
    counts, cols, _, _ = jbsa._cached_luts(np.asarray(layout), group)
    dt = getattr(jnp, dtype)
    out, lse = jbsa._bs_fwd(*(jnp.asarray(a, dt) for a in (q, k, v)), jnp.asarray(counts),
                            jnp.asarray(cols), group, q.shape[-1] ** -0.5, causal, block, True)
    return np.asarray(jnp.asarray(out, jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("case", [
    ("variable", 2, 1024, 128, True, 132), ("bigbird-bidirectional", 2, 512, 64, True, 132),
    ("longformer", 2, 1024, 128, False, 16), ("empty", 2, 512, 64, False, 132)],
    ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}-{'causal' if c[4] else 'full'}")
def test_tensor_core_forward_walk_matches_plain_version_and_jax(case):
    """The tensor-core forward's items, skips, diagonal test, online softmax
    and part-order merge, emulated in float64 on bf16 inputs with p rounded
    to bf16 before p.v, against the plain version and the JAX kernel (in
    interpret mode) on the same bf16 inputs. The three round p (and out) to
    bf16 at other shifts: out within 1e-2 absolute plus 1e-2 relative, as
    the bf16 parity above (measured at most 0.26 of it); lse is never
    rounded: 1e-5 on values of 0.07-7.7 (float32 sums on the other two
    sides; measured at most 6e-7). At these sizes the balanced
    share over the SMs is a few tiles, so rows split in every case (at 16
    SMs, Longformer's global rows without the causal mask); a row with no
    allowed key gives out 0 and lse -inf on all three."""
    name, h, t, block, causal, n_sm = case
    layout = _walk_layout(name, h, t, block)
    q, k, v, _ = (torch.from_numpy(a).bfloat16() for a in _inputs((1, h, t, 64), seed=8))
    counts, cols = bsa.build_luts(layout)[:2]
    work = bsa.build_work(counts, cols, t // block, block, causal, bsa.cta_rows(False, 64, block),
                          False, 1, n_sm)
    assert work.n_groups > 0    # small problems: the balanced share is a few tiles
    got = _emulate_tc_fwd(*(x.double().numpy() for x in (q, k, v)), layout, block, causal, n_sm)
    plain = [x.float().numpy() for x in
             bsa.block_sparse_attention_reference(q, k, v, layout, block, causal)]
    jax_out = _jax_fwd(*(x.float().numpy() for x in (q, k, v)), layout, block, causal,
                       "bfloat16")
    empty = ~np.repeat(layout.any(-1), block, 1)[None]     # [1, H, T]: rows with no block
    assert empty.any() == (name == "empty")
    for want, side in ((plain, "plain"), (jax_out, "jax")):
        np.testing.assert_allclose(got[0], want[0], atol=1e-2, rtol=1e-2, err_msg=f"out {side}")
        # the JAX kernel's lse of a row with no allowed key is finite (its
        # masked lanes score a finite value; ROADMAP section C): not compared
        np.testing.assert_allclose(got[1][~empty], want[1][~empty], atol=1e-5, rtol=0,
                                   err_msg=f"lse {side}")
    assert not got[0][empty].any() and np.isneginf(got[1][empty]).all()
    assert np.isneginf(plain[1][empty]).all()


def test_forward_and_dq_share_one_work_list():
    """The forward and dq walk the layout rows with one work list, built
    once and cached with the LUTs; dk/dv walks the columns with its own. A
    part of a split row holds rows * (DP + 2) floats in the forward (acc and
    each row's m and l), rows * DP in dq, 2 * rows * DP in dk/dv."""
    layout, block = _work_layouts()["longformer"]
    host = tuple(np.ascontiguousarray(a, np.int32) for a in bsa.build_luts(layout))
    luts = bsa.DeviceLuts(*(torch.from_numpy(a) for a in host), host, {})
    q = torch.zeros((1, 2, 4096, 64), dtype=torch.bfloat16)
    kw = dict(block=block, causal=False)
    fwd = bsa.tc_plan("bs_fwd_tc", luts, q, **kw)
    dq = bsa.tc_plan("bs_dq_tc", luts, q, **kw)
    dkv = bsa.tc_plan("bs_dkv_tc", luts, q, **kw)
    assert fwd.work is dq.work and fwd.lut is dq.lut is luts.cols and dkv.lut is luts.rows_t
    assert len(luts.work) == 2 and bsa.tc_plan("bs_fwd_tc", luts, q, **kw).work is fwd.work
    assert fwd.work.n_groups > 0 and fwd.work.rows == 128      # the global rows split
    assert (fwd.part_floats, dq.part_floats, dkv.part_floats) == (128 * 66, 128 * 64, 128 * 128)
    q80 = torch.zeros((1, 2, 4096, 80), dtype=torch.float16)
    assert bsa.tc_plan("bs_fwd_tc", luts, q80, **kw).part_floats == 128 * 130


# --------------------------------------------------------------------- card
CUDA_CASES = [
    # (B, H, T, D, dtype, config, block, causal)
    (1, 4, 1024, 64, torch.bfloat16, "variable", 256, True),
    (2, 2, 256, 64, torch.float32, "fixed", 16, True),
    (1, 2, 512, 128, torch.float16, "bigbird", 64, True),
    (2, 2, 256, 40, torch.float32, "empty", 32, False),
    (1, 2, 256, 256, torch.bfloat16, "longformer", 64, False),
    # the tensor-core design: rows with no allowed key (lse -inf) in bf16
    (2, 2, 512, 64, torch.bfloat16, "empty", 64, False),
    (1, 4, 1024, 64, torch.bfloat16, "bigbird", 64, True),   # blocks above the diagonal
    (1, 2, 1024, 80, torch.float16, "variable", 128, True),  # D 80, padded to 128
    (2, 4, 2048, 64, torch.bfloat16, "longformer", 128, False),  # global rows: fwd, dq split
    # two warpgroups a CTA, a row with no allowed key under the causal mask
    (1, 2, 1024, 64, torch.bfloat16, "empty", 128, True),
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

    def counters():
        return [bsa.block_sparse_fwd.launches, bsa.block_sparse_bwd_dq.launches,
                bsa.block_sparse_bwd_dkv.launches, bsa.block_sparse_fwd.tensor_core_launches,
                bsa.block_sparse_bwd_dq.tensor_core_launches,
                bsa.block_sparse_bwd_dkv.tensor_core_launches]

    before = counters()
    got, want = run(True), run(False)
    torch.cuda.synchronize()
    tc = int(bsa.tensor_core_path(dtype, Dc, block))
    assert counters() == [before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 2 * tc,
                          before[4] + tc, before[5] + tc]
    if name == "empty":     # the empty row gives 0 (lse -inf), the empty column 0
        rows, cols = slice(2 * block, 3 * block), slice(5 * block, 6 * block)
        assert not got[0][:, :, rows].any() and not got[2][:, :, rows].any()
        assert torch.isneginf(got[1][:, :, rows]).all()
        assert not got[3][:, :, cols].any() and not got[4][:, :, cols].any()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, out_name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        assert torch.isfinite(a).all() or out_name == "lse", out_name
        err = torch.where(a == b, 0.0, (a - b).abs())
        scale = float(b[torch.isfinite(b)].abs().max()) + 1e-6
        assert float(err.max()) / scale <= tol, f"{out_name}: {float(err.max()) / scale} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("name,causal", [("variable", True), ("longformer", False)])
def test_cuda_tensor_core_dkv_launches_are_bit_identical(name, causal):
    """Split lines merge their parts in part order, whichever CTA arrives
    last: two dk/dv launches (and two dq launches) agree bit for bit. At this
    size both kernels split lines of both layouts: the Variable layout's
    global column, the unmasked Longformer layout's global rows and
    columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    block = 256 if name == "variable" else 128
    layout = _cuda_layout(name, 4, 2048, block)
    luts = bsa.device_luts(layout, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((1, 4, 2048, 64), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kw = dict(block=block, causal=causal, sm_scale=0.125)
    out, lse = bsa.block_sparse_fwd(q, k, v, luts, **kw)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    splits = [bsa.device_work(luts, "cuda", T=2048, block=block, causal=causal, transposed=t,
                              batch=1, D=64).n_groups for t in (True, False)]
    assert min(splits) > 0
    first = bsa.block_sparse_bwd_dkv(q, k, v, do, lse, delta, luts, **kw)
    dq = bsa.block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw)
    for _ in range(3):
        again = bsa.block_sparse_bwd_dkv(q, k, v, do, lse, delta, luts, **kw)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
        assert torch.equal(bsa.block_sparse_bwd_dq(q, k, v, do, lse, delta, luts, **kw), dq)


@pytest.mark.cuda
@pytest.mark.parametrize("name,causal", [("variable", True), ("longformer", False)])
def test_cuda_tensor_core_forward_launches_are_bit_identical(name, causal):
    """The forward's split rows merge their parts in part order, whichever
    CTA arrives last: repeated launches agree bit for bit, and with the
    CUDA-core forward on the same inputs within the bf16 tolerance (lse
    -inf nowhere: every row has a key). At this size both layouts split
    rows: the Variable layout's heaviest (the balanced share over the SMs is
    9 tile steps), the unmasked Longformer layout's global rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    block = 256 if name == "variable" else 128
    layout = _cuda_layout(name, 4, 2048, block)
    luts = bsa.device_luts(layout, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 4, 2048, 64), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    kw = dict(block=block, causal=causal, sm_scale=0.125)
    work = bsa.device_work(luts, "cuda", T=2048, block=block, causal=causal, transposed=False,
                           batch=2, D=64)
    assert work.n_groups > 0
    before = bsa.block_sparse_fwd.tensor_core_launches
    out, lse = bsa.block_sparse_fwd(q, k, v, luts, **kw)
    for _ in range(3):
        again = bsa.block_sparse_fwd(q, k, v, luts, **kw)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert bsa.block_sparse_fwd.tensor_core_launches == before + 4
    fma_out, fma_lse = torch.empty_like(q), torch.empty_like(lse)
    err = bsa._lib().bs_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), fma_out.data_ptr(),
                            fma_lse.data_ptr(), luts.counts.data_ptr(), luts.cols.data_ptr(),
                            luts.cols.shape[1], *bsa._tail(q, block, 0.125, causal))
    assert err == 0
    torch.cuda.synchronize()
    assert torch.isfinite(lse).all()
    for a, b in ((out, fma_out), (lse, fma_lse)):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_tensor_core_design_takes_operands_off_16_byte_boundaries():
    """Contiguous views that start 2 bytes into their storage: the wrapper
    copies them to an aligned start for the tensor-core kernels' TMA, the
    forward's and the backward's; the launcher itself raises on them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    layout = _cuda_layout("bigbird", 2, 512, 64)
    gen = torch.Generator(device="cuda").manual_seed(4)
    base = [torch.randn((1, 2, 512, 64), generator=gen, device="cuda").bfloat16()
            for _ in range(3)]
    views = []
    for t in base:
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device="cuda")
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        views.append(view.requires_grad_())
    before = (bsa.block_sparse_fwd.tensor_core_launches,
              bsa.block_sparse_bwd_dkv.tensor_core_launches)
    out = bsa.block_sparse_attention(*views, layout, 64, causal=True)
    out.float().sum().backward()
    leaves = [t.clone().requires_grad_() for t in base]
    ref, _ = bsa.block_sparse_attention_reference(*leaves, layout, 64, True)
    ref.float().sum().backward()
    torch.cuda.synchronize()
    assert (bsa.block_sparse_fwd.tensor_core_launches,
            bsa.block_sparse_bwd_dkv.tensor_core_launches) == (before[0] + 1, before[1] + 1)
    err = float((out.detach().float() - ref.detach().float()).abs().max())
    assert err <= 2e-2 * float(ref.detach().float().abs().max()), err
    with pytest.raises(ValueError, match="16-byte"):       # the launcher takes no such view
        bsa.block_sparse_fwd(*(t.detach() for t in views), bsa.device_luts(layout, "cuda"),
                             block=64, causal=True, sm_scale=0.125)
    for a, b in zip(views, leaves):
        err = float((a.grad.float() - b.grad.float()).abs().max())
        assert err <= 2e-2 * float(b.grad.float().abs().max()), err
