"""Paged decode attention of the PyTorch port against the JAX package.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against the dense gather formula of tests/unit/test_paged_attention.py,
computed in JAX, on the same numpy inputs. The JAX Pallas kernel is not the
oracle: it does not run on this tree's jax (see ROADMAP.md, section C).

The CUDA kernels run only on the card: the ``cuda``-marked tests hold them
against the plain version there (each asserting the design the shape rule
``cluster_design`` names) and skip elsewhere; the rule and the cluster
design's geometry (``cluster_plan``) are checked here on the CPU. JAX is
imported only by the tests that use it, so that on a machine with a card and
no JAX ``python -m pytest -m cuda --noconftest tests/test_torch_paged_attention.py``
runs the kernel tests.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.paged_attention import (
    cluster_design, cluster_plan, paged_decode_attention, paged_decode_reference)

S, BS, MB = 4, 4, 8
ML = MB * BS
NB = 33
NL, NH, HD = 2, 2, 8
LENGTHS = [1, 5, ML, 17]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    kp = rng.randn(NL, NB, BS, NH, HD).astype(np.float32)
    vp = rng.randn(NL, NB, BS, NH, HD).astype(np.float32)
    q = rng.randn(S, NH, 1, HD).astype(np.float32)
    tables = rng.randint(1, NB, size=(S, MB)).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    return q, kp, vp, tables, lengths


def _jax_dense(q, kp, vp, li, tables, lengths, dtype):
    """tests/unit/test_paged_attention.py's dense gather formula, in JAX."""
    import jax
    import jax.numpy as jnp
    dtype = getattr(jnp, dtype)
    q, kp, vp = (jnp.asarray(a, dtype) for a in (q, kp, vp))
    tables, lengths = jnp.asarray(tables), jnp.asarray(lengths)
    g = kp[li][tables].reshape(S, ML, NH, HD).transpose(0, 2, 1, 3)
    gv = vp[li][tables].reshape(S, ML, NH, HD).transpose(0, 2, 1, 3)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, g,
                   preferred_element_type=jnp.float32) / math.sqrt(HD)
    mask = (jnp.arange(ML)[None, :] < lengths[:, None])[:, None, None, :]
    s = jnp.where(mask, s, jnp.float32(-1e9))
    p = jax.nn.softmax(s, axis=-1)
    ref = jnp.einsum("bhqk,bhkd->bhqd", p, gv.astype(jnp.float32),
                     preferred_element_type=jnp.float32)
    return np.asarray(ref.astype(dtype).astype(jnp.float32))


def _torch(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# float16: both sides sum in float32 and round once to the pool type, so they
# differ by at most about one float16 ulp (2^-11 relative) at values of O(1);
# 1e-2 is the kernels' 16-bit tolerance on the card.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2),
                                        ("float16", 1e-2)])
@pytest.mark.parametrize("li", [0, 1])
def test_plain_paged_decode_matches_jax_dense_gather(dtype, atol, li):
    q, kp, vp, tables, lengths = _inputs()
    tdt = getattr(torch, dtype)
    paged_decode_attention.launches = 0
    y = paged_decode_attention(_torch(q, tdt), _torch(kp, tdt), _torch(vp, tdt),
                               li, _torch(tables), _torch(lengths), block_size=BS)
    assert y.dtype == tdt and tuple(y.shape) == (S, NH, 1, HD)
    ref = _jax_dense(q, kp, vp, li, tables, lengths, dtype)
    np.testing.assert_allclose(y.float().numpy(), ref, atol=atol, rtol=0)
    # CPU tensors take the plain version: the kernel's count stays 0
    assert paged_decode_attention.launches == 0


def test_masked_positions_do_not_count():
    """Garbage past ``lengths`` (here: huge values) leaves the result as it
    was — the TPU kernel's -1e30 mask contributes exact zeros."""
    q, kp, vp, _, lengths = _inputs(1)
    # every page once, so a page belongs to one slot only
    tables = (np.random.RandomState(1).permutation(S * MB) + 1).reshape(S, MB)
    tables = tables.astype(np.int32)
    base = paged_decode_attention(_torch(q), _torch(kp), _torch(vp), 0,
                                  _torch(tables), _torch(lengths), block_size=BS)
    kp2, vp2 = kp.copy(), vp.copy()
    s = 1                                   # length 5: page 1 holds token 4 only
    kp2[0, tables[s, 1], 1:] = 1e4
    vp2[0, tables[s, 1], 1:] = 1e4
    kp2[0, tables[s, 2:]] = 1e4             # and pages past the length
    vp2[0, tables[s, 2:]] = 1e4
    got = paged_decode_attention(_torch(q), _torch(kp2), _torch(vp2), 0,
                                 _torch(tables), _torch(lengths), block_size=BS)
    np.testing.assert_array_equal(got[s].numpy(), base[s].numpy())
    vp2[0, tables[s, 1], 0] = 1e4           # token 4 itself does count
    got = paged_decode_attention(_torch(q), _torch(kp2), _torch(vp2), 0,
                                 _torch(tables), _torch(lengths), block_size=BS)
    assert not np.array_equal(got[s].numpy(), base[s].numpy())


def test_kernel_is_a_dispatcher_op_and_the_cpu_path_is_unchanged():
    """Both CUDA designs sit behind ``deepspeed_tpu_torch::paged_decode``,
    whose fake kernel gives the output's shape; CPU tensors take the plain
    version without the op (no op dispatched, no launch counted), bit for
    bit the plain function."""
    import torch
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.utils import op_record
    op = torch.ops.deepspeed_tpu_torch.paged_decode
    q, kp, vp, tables, lengths = (_torch(a) for a in _inputs())
    meta = [t.to("meta") for t in (q, kp, vp, tables, lengths)]
    out = op(meta[0], meta[1], meta[2], 0, meta[3], meta[4], BS)
    assert out.shape == q.shape and out.dtype == q.dtype
    counts = (pa.paged_decode_attention.launches, pa.paged_decode_attention.cluster_launches)
    prog = op_record.record(lambda: paged_decode_attention(q, kp, vp, 0, tables, lengths,
                                                            block_size=BS))
    assert op_record.kernel_counts(prog) == {}
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.cluster_launches) == counts
    ref = pa.paged_decode_reference(q, kp, vp, 0, tables, lengths, block_size=BS)
    assert torch.equal(prog.result, ref)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "tables", "device"])
def test_wrapper_refuses_bad_inputs(bad):
    q, kp, vp, tables, lengths = (_torch(a) for a in _inputs())
    if bad == "head_dim":
        q = q[..., :HD - 2]
        err = ValueError
    elif bad == "dtype":
        q = q.double()
        err = TypeError
    elif bad == "tables":
        tables = tables[:2]
        err = ValueError
    else:
        q, kp, vp, tables, lengths = (t.to("meta") for t in (q, kp, vp, tables, lengths))
        err = ValueError
    with pytest.raises(err):
        paged_decode_attention(q, kp, vp, 0, tables, lengths, block_size=BS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", ["small", "gpt2_1.5b"])
def test_cuda_kernel_matches_plain_version(dtype, shape):
    """The CUDA kernel against the plain version on the same card tensors.
    Both accumulate in float32; the result is rounded once to the pool type,
    so bf16 may differ by about one bf16 ulp (2^-8 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged-decode kernel has no CPU mode")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if shape == "small":
        nl, nb, bs, nh, hd, mb = NL, NB, BS, NH, HD, MB
        lengths = LENGTHS
    else:
        nl, nb, bs, nh, hd, mb = 4, 513, 16, 25, 64, 64
        lengths = [1, 17, 300, 1024, 16, 33, 512, 1000]
    s = len(lengths)
    kp = torch.randn(nl, nb, bs, nh, hd, generator=gen, device="cuda").to(tdt)
    vp = torch.randn(nl, nb, bs, nh, hd, generator=gen, device="cuda").to(tdt)
    q = torch.randn(s, nh, 1, hd, generator=gen, device="cuda").to(tdt)
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[:s * mb] + 1
              if s * mb <= nb - 1 else
              torch.randint(1, nb, (s * mb,), generator=gen, device="cuda"))
    tables = tables.reshape(s, mb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = paged_decode_attention.launches
    for li in range(nl):
        y = paged_decode_attention(q, kp, vp, li, tables, lens, block_size=bs)
        ref = paged_decode_reference(q, kp, vp, li, tables, lens, block_size=bs)
        torch.cuda.synchronize()
        if tdt == torch.float32:
            torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(y.float(), ref.float(), atol=1e-2, rtol=1e-2)
    assert paged_decode_attention.launches == before + nl


# ------------------------------------------------------------ the shape rule
@pytest.mark.parametrize("dtype,head_dim,cluster", [
    (torch.bfloat16, 64, True), (torch.float16, 64, True), (torch.float32, 64, True),
    (torch.bfloat16, 8, True), (torch.float32, 4, True), (torch.bfloat16, 256, True),
    (torch.float32, 256, True), (torch.bfloat16, 2, False), (torch.float16, 6, False),
    (torch.float32, 2, False), (torch.bfloat16, 20, False), (torch.bfloat16, 96, False),
    (torch.float32, 24, False)])
def test_shape_rule_names_the_cluster_design_where_rows_split_in_16_bytes(dtype, head_dim,
                                                                        cluster):
    """The cluster design takes a head_dim whose row is 16 bytes times a
    power of two (a TMA box row, split over the lanes of a warp); every other
    even head_dim takes the first design."""
    assert cluster_design(dtype, head_dim) is cluster


def test_cluster_plan_at_the_serving_widths():
    """GPT-2 1.5B (25 heads of 64, pages of 16, 64 pages a slot): groups of 5
    heads, one warp each beside the producer warp, 8 splits of at most 8
    pages; a stage is a whole
    page of the group in bf16 and fp16 (20 KB of K + V) and half a page in
    float32; 4 lanes share a token's row of 64 values."""
    for dtype, tb, boxes, lanes in ((torch.bfloat16, 16, 1, 4), (torch.float16, 16, 1, 4),
                                    (torch.float32, 8, 2, 4)):
        plan = cluster_plan(25, 64, 16, 64, dtype)
        assert (plan.heads_per_group, plan.tokens_per_box, plan.boxes_per_page) == (5, tb, boxes)
        assert (plan.splits, plan.lanes) == (8, lanes)
        assert 2 * tb * 5 * 64 * dtype.itemsize == 20480          # K + V of one stage


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cluster_plan_fits_the_kernel(dtype):
    """What paged_decode_cluster checks and assumes, for every plan over a
    sweep of shapes: groups of at most 8 heads divide the heads, boxes cover
    a page within TMA's 256 rows and 4 passes of the warp, a stage stays
    within 20 KB, lanes x loads of at most 16 values tile a row, at most 8
    splits."""
    es = dtype.itemsize
    for n_head in (1, 2, 7, 12, 16, 25, 40):
        for head_dim in (8, 16, 32, 64, 128, 256):
            for block_size, max_blocks in ((1, 5), (4, 8), (16, 64), (512, 3)):
                assert cluster_design(dtype, head_dim)
                p = cluster_plan(n_head, head_dim, block_size, max_blocks, dtype)
                g, loads = p.heads_per_group, head_dim * es // 16
                assert n_head % g == 0 and g <= 8 and g * head_dim * es <= 2048
                assert 1 <= p.tokens_per_box <= min(256, block_size, 4 * (32 // p.lanes))
                assert p.tokens_per_box * p.boxes_per_page >= block_size
                assert (p.boxes_per_page - 1) * p.tokens_per_box < block_size  # no empty box
                assert 2 * p.tokens_per_box * g * head_dim * es <= 20480   # a stage
                per_lane = min(loads, es)     # 16 values: 2 loads in 16 bits, 4 in float32
                assert p.lanes * per_lane == loads and p.lanes <= 16
                assert p.splits == min(8, max_blocks)


# ------------------------------------------------------- kernels on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged-decode kernels have no CPU mode")


def _card_inputs(nl, nb, bs, nh, hd, mb, lengths, dtype, seed=0, tables=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn(nl, nb, bs, nh, hd, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nl, nb, bs, nh, hd, generator=gen, device="cuda").to(dtype)
    q = torch.randn(len(lengths), nh, 1, hd, generator=gen, device="cuda").to(dtype)
    if tables is None:
        tables = torch.randperm(nb - 1, generator=gen, device="cuda")[:len(lengths) * mb] + 1
    tables = torch.as_tensor(tables, device="cuda").reshape(len(lengths), mb)
    return (q, kp, vp, tables.to(torch.int32).contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _check_on_card(q, kp, vp, tables, lengths, bs, layers=(0,)):
    """Kernel vs plain version at each layer, and the design the rule names."""
    cluster = cluster_design(q.dtype, q.shape[3])
    launches = paged_decode_attention.launches
    clustered = paged_decode_attention.cluster_launches
    for li in layers:
        y = paged_decode_attention(q, kp, vp, li, tables, lengths, block_size=bs)
        ref = paged_decode_reference(q, kp, vp, li, tables, lengths, block_size=bs)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        tol = 1e-5 if q.dtype == torch.float32 else 1e-2
        torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)
    assert paged_decode_attention.launches == launches + len(layers)
    assert paged_decode_attention.cluster_launches == clustered + cluster * len(layers)


# nl, nb, bs, nh, hd, mb, lengths: 8 splits at 64 pages of 16, so split r
# owns pages r, r + 8, ...: lengths at a page's edge, at one page for every
# split (8 x 16) and one token past it, and at the table's end
EDGES = (2, 520, 16, 4, 64, 64, [1, 16, 17, 128, 129, 1024, 1023, 261])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", ["edges", "all_full", "all_one", "gpt2_1.5b"])
def test_cuda_cluster_design_lengths(dtype, case):
    """Lengths at page and split edges, every slot full, every slot at one
    token, and the serving widths (25 heads of 64: float16 and float32 take
    boxes of a whole and of half a page)."""
    _card()
    nl, nb, bs, nh, hd, mb, lengths = EDGES
    if case == "all_full":
        lengths = [mb * bs] * 8
    elif case == "all_one":
        lengths = [1] * 8
    elif case == "gpt2_1.5b":
        nh = 25
        lengths = [1, 17, 300, 1024, 64, 511, 777, 1000]
    tdt = getattr(torch, dtype)
    _check_on_card(*_card_inputs(nl, nb, bs, nh, hd, mb, lengths, tdt), bs, layers=(1,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("nh,hd", [(8, 32), (4, 128), (2, 256), (1, 64)])
def test_cuda_cluster_design_head_dims(dtype, nh, hd):
    """head_dim 32, 128 and 256 (groups of 8, 4 and 2 heads), and one head."""
    _card()
    lengths = [5, 300, 64, 1]
    _check_on_card(*_card_inputs(2, 140, 16, nh, hd, 32, lengths, getattr(torch, dtype)), 16,
                   layers=(0, 1))


@pytest.mark.cuda
def test_cuda_cluster_design_repeated_pages_and_page_edges():
    """A table that repeats page ids (shared prefix pages, beam forks), with
    pages of 512 tokens: boxes of part of a page, the last one past its end."""
    _card()
    rng = np.random.RandomState(0)
    tables = rng.randint(1, 6, size=(3, 4))
    tables[1] = tables[0]
    q, kp, vp, tb, ln = _card_inputs(3, 8, 512, 2, 128, 4, [700, 2048, 1], torch.float32,
                                     tables=tables)
    _check_on_card(q, kp, vp, tb, ln, 512, layers=(2,))


@pytest.mark.cuda
def test_cuda_cluster_design_is_deterministic():
    """Two launches on the same inputs give the same bits: the splits merge
    in rank order inside the cluster, with no atomics."""
    _card()
    nl, nb, bs, nh, hd, mb, lengths = EDGES
    q, kp, vp, tb, ln = _card_inputs(nl, nb, bs, 25, hd, mb, [1, 17, 300, 1024, 64, 511, 777,
                                                              1000], torch.bfloat16)
    a = paged_decode_attention(q, kp, vp, 1, tb, ln, block_size=bs)
    b = paged_decode_attention(q, kp, vp, 1, tb, ln, block_size=bs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("bfloat16", 2), ("float16", 6), ("float32", 2),
                                      ("bfloat16", 96)])
def test_cuda_first_design_takes_the_other_shapes(dtype, hd):
    """Rows under 16 bytes, or not 16 bytes times a power of two, run the
    first design."""
    _card()
    _check_on_card(*_card_inputs(2, 70, 16, 3, hd, 8, [1, 17, 128, 100],
                                 getattr(torch, dtype)), 16, layers=(0, 1))
