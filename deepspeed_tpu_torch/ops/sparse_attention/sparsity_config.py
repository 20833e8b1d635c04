"""Block-sparse attention layout configurations.

Same semantic surface as ``deepspeed/ops/sparse_attention/sparsity_config.py`` (663 LoC):
Dense / Fixed / Variable / BigBird / BSLongformer patterns produce boolean layouts of
shape [num_heads, seq_blocks, seq_blocks] at ``block`` granularity. Layouts here are
numpy integer arrays (host-side, static per seq_len) — they drive both the CUDA
block-sparse kernels' LUTs (ops/block_sparse_attention.py) and the dense-masked
path. A copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(numpy and ``random`` only), so that both give the same layouts element for
element, the seeded random blocks included.

Pattern definitions (local windows, global representative blocks, sliding windows,
random blocks, uni/bidirectional) follow the cited papers exactly as the reference does:
Sparse Transformers (Fixed), BigBird, Longformer.
"""

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: holds head count, block size, per-head-layout flag.

    Layout construction is DETERMINISTIC: patterns with random blocks
    (BigBird, Variable) draw from ``random.Random(layout_seed)``, so every
    process — multi-host data-parallel ranks, or a later eval run reloading a
    checkpoint — realizes the identical layout. (The reference sampled the
    unseeded global RNG; per-process layouts would bake different LUT
    constants into each host's compiled program and silently diverge.)"""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 layout_seed=709):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1
        self.layout_seed = layout_seed

    def layout_rng(self) -> "random.Random":
        """Fresh seeded RNG per make_layout call, so repeated builds (and
        different sequence lengths) are themselves reproducible."""
        return random.Random(self.layout_seed)

    def set_random_layout(self, h, layout, rng=None):
        """Per-row random blocks for patterns with ``num_random_blocks``
        (Variable, BigBird); shared here so the sampling logic has one home."""
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(f"sparse layout: num_random_blocks={self.num_random_blocks} "
                             f"exceeds the {num_blocks} blocks per row")
        rng = rng or self.layout_rng()
        for row in range(num_blocks):
            rnd_cols = rng.sample(range(num_blocks), self.num_random_blocks)
            layout[h, row, rnd_cols] = 1
        return layout

    def setup_layout(self, seq_len) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"sparse layout: seq_len={seq_len} is not a multiple of block={self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active (dense attention expressed in the block-sparse machinery)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head=False)

    def make_layout(self, seq_len) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed' pattern: local windows + fixed global representative
    blocks per window, uni- or bidirectional."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_local_blocks=4,
                 num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(f"sparse layout: num_local_blocks={num_local_blocks} is not a "
                             f"multiple of num_global_blocks={num_global_blocks}")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"sparse layout: unknown attention mode {attention!r} "
                                      "(expected 'unidirectional' or 'bidirectional')")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("sparse layout: horizontal_global_attention requires "
                             "attention='bidirectional'")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("sparse layout: num_different_global_patterns > 1 requires "
                             "different_layout_per_head=True")
        if num_different_global_patterns > (num_local_blocks // num_global_blocks):
            raise ValueError(f"sparse layout: num_different_global_patterns="
                             f"{num_different_global_patterns} exceeds the "
                             f"{num_local_blocks // num_global_blocks} distinct patterns available")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        for win_start in range(0, num_blocks, self.num_local_blocks):
            end = min(win_start + self.num_local_blocks, num_blocks)
            for row in range(win_start, end):
                last_col = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, win_start:last_col] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        first_global = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns) * self.num_global_blocks

        end = num_blocks - (num_blocks % self.num_local_blocks)
        for i in range(first_global, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < num_blocks:
            start = min(end + first_global, num_blocks - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable-size local windows + explicit global block (ranges) + random blocks."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 layout_seed=709):
        super().__init__(num_heads, block, different_layout_per_head,
                         layout_seed=layout_seed)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("sparse layout: global_block_indices and "
                                 "global_block_end_indices differ in length")
            for start_idx, end_idx in zip(self.global_block_indices, global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(f"sparse layout: global block range [{start_idx}, {end_idx}) is empty")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(f"sparse layout: unknown attention mode {attention!r} "
                                      "(expected 'unidirectional' or 'bidirectional')")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("sparse layout: horizontal_global_attention requires "
                             "attention='bidirectional'")
        self.horizontal_global_attention = horizontal_global_attention

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        start = 0
        end = 0
        block_size = self.local_window_blocks[-1]
        for block_size in self.local_window_blocks:
            end = min(end + block_size, num_blocks)
            for row in range(start, end):
                last_col = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, start:last_col] = 1
            start += block_size
        for i in range(start, num_blocks, block_size):
            end = min(i + block_size, num_blocks)
            for row in range(i, end):
                last_col = row + 1 if self.attention == "unidirectional" else end
                layout[h, row, i:last_col] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < num_blocks:
                    if self.horizontal_global_attention:
                        layout[h, idx, :] = 1
                    first_row = 0 if self.attention == "bidirectional" else idx
                    layout[h, first_row:, idx] = 1
        else:
            for start_idx, end_idx in zip(self.global_block_indices, self.global_block_end_indices):
                if start_idx < num_blocks:
                    end_idx = min(end_idx, num_blocks)
                    if self.horizontal_global_attention:
                        layout[h, start_idx:end_idx, :] = 1
                    first_row = 0 if self.attention == "bidirectional" else start_idx
                    layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        rng = self.layout_rng()  # one seeded stream; heads draw sequentially
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout, rng)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC: random + sliding window + leading global blocks."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=1,
                 num_sliding_window_blocks=3,
                 num_global_blocks=1,
                 layout_seed=709):
        super().__init__(num_heads, block, different_layout_per_head,
                         layout_seed=layout_seed)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(f"sparse layout: num_sliding_window_blocks={self.num_sliding_window_blocks} "
                             f"exceeds the {num_blocks} blocks per row")
        w = self.num_sliding_window_blocks // 2
        for row in range(num_blocks):
            layout[h, row, max(0, row - w):min(row + w + 1, num_blocks)] = 1
        return layout

    def set_global_layout_itc(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_global_blocks:
            raise ValueError(f"sparse layout: num_global_blocks={self.num_global_blocks} "
                             f"exceeds the {num_blocks} blocks per row")
        layout[h, 0:self.num_global_blocks, :] = 1
        layout[h, :, 0:self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        rng = self.layout_rng()  # one seeded stream; heads draw sequentially
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout, rng)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + symmetric global block (ranges)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("sparse layout: global_block_indices and "
                                 "global_block_end_indices differ in length")
            for start_idx, end_idx in zip(self.global_block_indices, global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(f"sparse layout: global block range [{start_idx}, {end_idx}) is empty")
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(f"sparse layout: num_sliding_window_blocks={self.num_sliding_window_blocks} "
                             f"exceeds the {num_blocks} blocks per row")
        w = self.num_sliding_window_blocks // 2
        for row in range(num_blocks):
            layout[h, row, max(0, row - w):min(row + w + 1, num_blocks)] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < num_blocks:
                    layout[h, idx, :] = 1
                    layout[h, :, idx] = 1
        else:
            for start_idx, end_idx in zip(self.global_block_indices, self.global_block_end_indices):
                if start_idx < num_blocks:
                    end_idx = min(end_idx, num_blocks)
                    layout[h, start_idx:end_idx, :] = 1
                    layout[h, :, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
