"""Sparse self-attention layers over SparsityConfig layouts.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
softmax(QK^T * scale + masks) V under a block-sparse layout. Without rpe and
masks it runs ``block_sparse_attention`` (the CUDA kernels for card tensors,
their plain version for CPU tensors); rpe, key-padding and attention masks
take the dense-masked path in torch, as in the JAX package (they densify the
score matrix anyway).
"""

import math

import numpy as np
import torch
from torch import nn

from ...device import resolve_device
from ..block_sparse_attention import (DEFAULT_MASK_VALUE, block_sparse_attention,
                                      layout_mask)
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class SparseSelfAttention(nn.Module):
    """q/k/v: [B, H, T, D] (already projected and split into heads)."""

    def __init__(self,
                 sparsity_config: SparsityConfig = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError(f'only "add" or "mul" key_padding_mask_modes are supported, '
                             f'got {key_padding_mask_mode!r}')
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError(f'only "add" or "mul" attn_mask_modes are supported, '
                             f'got {attn_mask_mode!r}')
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layout_cache = {}

    def get_layout(self, L: int) -> np.ndarray:
        if L not in self._layout_cache:
            self._layout_cache[L] = self.sparsity_config.make_layout(L)
        return self._layout_cache[L]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None, attn_mask=None):
        if not query.dtype == key.dtype == value.dtype:
            raise TypeError("only same-dtype q/k/v are supported")
        T = query.shape[2]
        if T % self.sparsity_config.block:
            raise ValueError(f"sequence length {T} must be divisible by block size "
                             f"{self.sparsity_config.block}")
        layout = self.get_layout(T)
        causal = getattr(self.sparsity_config, "attention", "bidirectional") == "unidirectional"
        if rpe is None and key_padding_mask is None and attn_mask is None:
            return block_sparse_attention(query, key, value, layout,
                                          self.sparsity_config.block, causal=causal)
        return self._masked_dense(query, key, value, layout, causal, rpe, key_padding_mask,
                                  attn_mask)

    def _masked_dense(self, q, k, v, layout, causal, rpe, key_padding_mask, attn_mask):
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
        masked = torch.full((), DEFAULT_MASK_VALUE, device=q.device)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
        if rpe is not None:
            scores = scores + rpe.float()
        if key_padding_mask is not None:
            m = key_padding_mask.float()[:, None, None, :]
            if self.key_padding_mask_mode == "add":
                scores = scores + m
            else:
                scores = torch.where(m != 0, scores, masked)
        if attn_mask is not None:
            m = attn_mask.float()
            while m.dim() < 4:
                m = m[None]
            if self.attn_mask_mode == "add":
                scores = scores + m
            else:
                scores = torch.where(m != 0, scores, masked)
        mask = layout_mask(layout, self.sparsity_config.block, causal, q.device)
        scores = torch.where(mask, scores, masked)
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


class BertSparseSelfAttention(nn.Module):
    """BERT-style projected sparse attention: owns the query, key and value
    projections (``{name}_w [hidden, hidden]`` used as ``x @ w``, and
    ``{name}_b``) on ``device`` (the card unless the caller asks for
    ``"cpu"``). ``init(generator)`` fills them as the JAX package does;
    ``load_jax`` takes the JAX ``{query,key,value}: {w, b}`` dict.
    ``forward(hidden_states, attention_mask)`` -> context ``[B, T, hidden]``."""

    NAMES = ("query", "key", "value")

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 sparsity_config: SparsityConfig = None, device=None):
        super().__init__()
        if hidden_size % num_attention_heads != 0:
            raise ValueError(f"The hidden size ({hidden_size}) is not a multiple of "
                             f"the number of attention heads ({num_attention_heads})")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.head_dim = hidden_size // num_attention_heads
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(num_heads=num_attention_heads))
        dev = resolve_device(device)
        for name in self.NAMES:
            setattr(self, f"{name}_w",
                    nn.Parameter(torch.empty(hidden_size, hidden_size, device=dev)))
            setattr(self, f"{name}_b", nn.Parameter(torch.zeros(hidden_size, device=dev)))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """normal(0.02) weights and zero biases, the JAX package's scheme (its
        numbers differ from ``jax.random``'s: tests carry the JAX ones over
        with ``load_jax``)."""
        for name in self.NAMES:
            getattr(self, f"{name}_w").normal_(0.0, 0.02, generator=generator)
            getattr(self, f"{name}_b").zero_()

    @torch.no_grad()
    def load_jax(self, params):
        """Copy the JAX layer's ``{query,key,value}: {w, b}`` parameters
        (numpy arrays or anything ``np.asarray`` takes) into this module."""
        for name in self.NAMES:
            for leaf in ("w", "b"):
                own = getattr(self, f"{name}_{leaf}")
                src = torch.from_numpy(np.array(params[name][leaf], np.float32))
                if tuple(src.shape) != tuple(own.shape):
                    raise ValueError(f"{name}.{leaf}: shape {tuple(src.shape)} != "
                                     f"{tuple(own.shape)}")
                own.copy_(src)

    def _split_heads(self, x):
        B, T, _ = x.shape
        return x.reshape(B, T, self.num_attention_heads, self.head_dim).transpose(1, 2)

    def forward(self, hidden_states, attention_mask=None):
        dt = hidden_states.dtype
        q, k, v = (self._split_heads(
            torch.matmul(hidden_states, getattr(self, f"{name}_w").to(dt))
            + getattr(self, f"{name}_b").to(dt)) for name in self.NAMES)
        ctx = self.sparse_self_attention(q, k, v, key_padding_mask=attention_mask)
        B, H, T, D = ctx.shape
        return ctx.transpose(1, 2).reshape(B, T, H * D)
