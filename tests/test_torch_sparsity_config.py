"""Sparsity layouts and LUTs of the PyTorch port against the JAX package.

Every ``SparsityConfig`` class of the port builds the JAX package's layout
element for element (exact: both are numpy, and the random blocks of
BigBird and Variable come from the same ``random.Random(layout_seed)``), with
one layout or one per head; invalid configurations raise the JAX exception;
and ``build_luts`` / ``build_grouped_luts`` give the JAX LUTs exactly.
"""

import numpy as np
import pytest

from deepspeed_tpu.ops.pallas import block_sparse_attention as jax_bsa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

H = 4

CONFIGS = [
    ("DenseSparsityConfig", dict(block=16), 256),
    ("FixedSparsityConfig", dict(block=16), 256),
    ("FixedSparsityConfig", dict(block=32, num_local_blocks=4, num_global_blocks=2,
                                 attention="unidirectional"), 512),
    ("FixedSparsityConfig", dict(block=16, different_layout_per_head=True,
                                 num_local_blocks=4, num_different_global_patterns=4,
                                 horizontal_global_attention=True), 272),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2), 512),
    ("VariableSparsityConfig", dict(block=16, different_layout_per_head=True,
                                    num_random_blocks=1, local_window_blocks=[2, 3, 5],
                                    global_block_indices=[1, 6],
                                    global_block_end_indices=[3, 8],
                                    horizontal_global_attention=True, layout_seed=3), 400),
    ("VariableSparsityConfig", dict(block=256, local_window_blocks=[3],
                                    global_block_indices=[0],
                                    attention="unidirectional"), 8192),
    ("BigBirdSparsityConfig", dict(block=16), 256),
    ("BigBirdSparsityConfig", dict(block=64, different_layout_per_head=True,
                                   num_random_blocks=3, num_sliding_window_blocks=5,
                                   num_global_blocks=2, layout_seed=11), 2048),
    ("BSLongformerSparsityConfig", dict(block=16), 256),
    ("BSLongformerSparsityConfig", dict(block=16, different_layout_per_head=True,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0, 9],
                                        global_block_end_indices=[2, 11]), 320),
]


@pytest.mark.parametrize("name,kw,T", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CONFIGS)])
def test_layout_equals_jax(name, kw, T):
    got = getattr(sc, name)(num_heads=H, **kw).make_layout(T)
    want = getattr(jax_sc, name)(num_heads=H, **kw).make_layout(T)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


INVALID = [
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=3), None),
    ("FixedSparsityConfig", dict(attention="sideways"), None),
    ("FixedSparsityConfig", dict(attention="unidirectional",
                                 horizontal_global_attention=True), None),
    ("FixedSparsityConfig", dict(num_different_global_patterns=2), None),
    ("FixedSparsityConfig", dict(different_layout_per_head=True, num_local_blocks=4,
                                 num_different_global_patterns=5), None),
    ("FixedSparsityConfig", dict(block=16), 100),                   # T % block
    ("VariableSparsityConfig", dict(global_block_indices=[0, 4],
                                    global_block_end_indices=[2]), None),
    ("VariableSparsityConfig", dict(global_block_indices=[3],
                                    global_block_end_indices=[3]), None),
    ("VariableSparsityConfig", dict(attention="sideways"), None),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=9), 128),
    ("BigBirdSparsityConfig", dict(block=16, num_sliding_window_blocks=9), 128),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=0,
                                   num_global_blocks=9), 128),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[2],
                                        global_block_end_indices=[1]), None),
    ("BSLongformerSparsityConfig", dict(block=16, num_sliding_window_blocks=9), 128),
]


@pytest.mark.parametrize("name,kw,T", INVALID, ids=[f"{n}-{i}" for i, (n, _, _) in
                                                      enumerate(INVALID)])
def test_invalid_config_raises_as_jax(name, kw, T):
    def build(module):
        cfg = getattr(module, name)(num_heads=H, **kw)
        if T is not None:
            cfg.make_layout(T)

    with pytest.raises((ValueError, NotImplementedError)) as want:
        build(jax_sc)
    with pytest.raises(want.type, match=str(want.value)[:20]):
        build(sc)


def _luts_layouts():
    big = sc.BigBirdSparsityConfig(num_heads=H, block=16, different_layout_per_head=True,
                                   num_random_blocks=2).make_layout(512)
    empty = big.copy()
    empty[:, 5, :] = 0
    empty[:, :, 9] = 0
    var = sc.VariableSparsityConfig(num_heads=16, block=256, local_window_blocks=[3],
                                    global_block_indices=[0],
                                    attention="unidirectional").make_layout(8192)
    return {"bigbird": big, "empty-row-col": empty, "variable-8192": var}


@pytest.mark.parametrize("which", ["bigbird", "empty-row-col", "variable-8192"])
def test_luts_equal_jax(which):
    layout = _luts_layouts()[which]
    for got, want in zip(bsa.build_luts(layout), jax_bsa.build_luts(layout)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for group in (1, 2, 4):
        for got, want in zip(bsa.build_grouped_luts(layout, group),
                             jax_bsa.build_grouped_luts(layout, group)):
            np.testing.assert_array_equal(got, want)


def test_main_layout_density():
    """The slice's layout at T = 8192: 92 of 528 causal blocks a head, at
    most 4 active k-blocks a q-row; k-block 0 (the global column) active for
    all 32 q-rows and every other column for at most 3."""
    layout = _luts_layouts()["variable-8192"]
    counts, _, counts_t, _ = bsa.build_luts(layout)
    assert (layout.sum(axis=(1, 2)) == 92).all()
    assert counts.max() == 4
    col = counts_t.reshape(16, 32)
    assert (col[:, 0] == 32).all() and col[:, 1:].max() == 3


def test_device_luts_are_cached_per_layout_and_device():
    layout = _luts_layouts()["bigbird"]
    a = bsa.device_luts(layout, "cpu")
    assert bsa.device_luts(layout.copy(), "cpu") is a
    for got, want in zip(a, bsa.build_luts(layout)):
        assert got.dtype.is_floating_point is False and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert bsa.device_luts(_luts_layouts()["empty-row-col"], "cpu") is not a
