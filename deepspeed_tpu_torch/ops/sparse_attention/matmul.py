"""Block-sparse matrix products (SDD / DSD / DDS modes).

Counterpart of ``deepspeed_tpu/ops/sparse_attention/matmul.py``: gather the
layout-active blocks, one batched product over them accumulating in float32,
scatter-add. Torch ops on tensors of any device (the JAX ones are XLA code
outside any kernel); hot attention paths go through the fused
``block_sparse_attention`` kernels instead.

Sparse operands and results use the flat block format ``[batch, nnz, block,
block]``, ``nnz`` enumerating ``layout.nonzero()`` in row-major ``(head,
row_block, col_block)`` order. Dense operands are ``[batch, heads, rows,
cols]``. Modes:
- ``sdd``: dense @ dense -> sparse (only layout-active output blocks)
- ``dsd``: sparse @ dense -> dense
- ``dds``: dense @ sparse -> dense
``trans_a`` / ``trans_b`` transpose the corresponding operand logically (for
a sparse operand this swaps its row/col LUTs and transposes each block).
"""

import numpy as np
import torch

__all__ = ["MatMul", "dense_to_sparse", "sparse_to_dense"]


def _lut(layout):
    """Row-major nonzero list of a [heads, Mb, Nb] layout -> (h, i, j) int64 arrays."""
    layout = np.asarray(layout)
    if layout.ndim != 3:
        raise ValueError(f"layout must be [heads, blocks, blocks], got {layout.shape}")
    h, i, j = layout.nonzero()
    return h.astype(np.int64), i.astype(np.int64), j.astype(np.int64)


def _idx(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _product(eq, a, b, dtype):
    """einsum accumulating in float32, rounded once to ``dtype``."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def dense_to_sparse(dense, layout, block: int):
    """[B, H, M, N] dense -> [B, nnz, block, block] values of the layout-active blocks."""
    B, H, M, N = dense.shape
    hh, ii, jj = (_idx(a, dense.device) for a in _lut(layout))
    blocked = dense.reshape(B, H, M // block, block, N // block, block)
    blocked = blocked.permute(0, 1, 2, 4, 3, 5)  # [B, H, Mb, Nb, block, block]
    return blocked[:, hh, ii, jj]


def sparse_to_dense(vals, layout, block: int, fill: float = 0.0):
    """[B, nnz, block, block] values -> [B, H, M, N] dense with `fill` in inactive blocks."""
    layout = np.asarray(layout)
    H, Mb, Nb = layout.shape
    B = vals.shape[0]
    hh, ii, jj = (_idx(a, vals.device) for a in _lut(layout))
    out = torch.full((B, H, Mb, Nb, block, block), fill, dtype=vals.dtype, device=vals.device)
    out[:, hh, ii, jj] = vals
    return out.permute(0, 1, 2, 4, 3, 5).reshape(B, H, Mb * block, Nb * block)


class MatMul:
    """Block-sparse matmul with a fixed layout."""

    def __init__(self, layout, block: int, mode: str, trans_a: bool = False,
                 trans_b: bool = False):
        if mode not in ("sdd", "dsd", "dds"):
            raise NotImplementedError(f"Supported modes are: sdd, dsd, dds — got {mode!r}")
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b
        self.lut_h, self.lut_i, self.lut_j = _lut(self.layout)
        self.nnz = len(self.lut_h)

    # ---------------------------------------------------------------- helpers
    def _sparse_luts(self, transposed: bool):
        """(row, col) LUTs of the sparse operand, honoring a logical transpose."""
        if transposed:
            return self.lut_j, self.lut_i
        return self.lut_i, self.lut_j

    def _check_blocks(self, name, nblocks, axis_len):
        if axis_len != nblocks * self.block:
            raise ValueError(
                f"{name} extent {axis_len} does not match layout: expected "
                f"{nblocks} blocks x block={self.block} = {nblocks * self.block}")

    def __call__(self, a, b):
        H, Mb, Nb = self.layout.shape
        if self.mode == "sdd":
            self._check_blocks("a rows", Nb if self.trans_a else Mb,
                               a.shape[-1] if self.trans_a else a.shape[-2])
            self._check_blocks("b cols", Mb if self.trans_b else Nb,
                               b.shape[-2] if self.trans_b else b.shape[-1])
        elif self.mode == "dsd":
            if a.shape[1] != self.nnz:
                raise ValueError(f"sparse operand nnz={a.shape[1]} != layout nnz={self.nnz}")
            self._check_blocks("b rows", Mb if self.trans_a else Nb,
                               b.shape[-1] if self.trans_b else b.shape[-2])
        else:  # dds
            if b.shape[1] != self.nnz:
                raise ValueError(f"sparse operand nnz={b.shape[1]} != layout nnz={self.nnz}")
            self._check_blocks("a cols", Nb if self.trans_b else Mb,
                               a.shape[-2] if self.trans_a else a.shape[-1])
        return getattr(self, f"_{self.mode}")(a, b)

    # ---------------------------------------------------------------- modes
    def _sdd(self, a, b):
        """dense [B,H,M,K] @ dense [B,H,K,N] -> sparse [B,nnz,block,block]."""
        blk = self.block
        if self.trans_a:
            a = a.transpose(-1, -2)
        if not self.trans_b:
            b = b.transpose(-1, -2)          # -> [B, H, N, K] (row-gatherable)
        B, H, M, K = a.shape
        hh, ii, jj = (_idx(x, a.device) for x in (self.lut_h, self.lut_i, self.lut_j))
        a_blocks = a.reshape(B, H, M // blk, blk, K)[:, hh, ii]
        b_blocks = b.reshape(B, H, b.shape[2] // blk, blk, K)[:, hh, jj]
        return _product("bnik,bnjk->bnij", a_blocks, b_blocks, a.dtype)

    def _dsd(self, a, b):
        """sparse [B,nnz,blk,blk] @ dense [B,H,K,N] -> dense [B,H,M,N]."""
        blk = self.block
        rows, cols = self._sparse_luts(self.trans_a)
        vals = a.transpose(-1, -2) if self.trans_a else a
        if self.trans_b:
            b = b.transpose(-1, -2)
        B, H, K, N = b.shape
        Mb = self.layout.shape[2] if self.trans_a else self.layout.shape[1]
        hh = _idx(self.lut_h, b.device)
        b_blocks = b.reshape(B, H, K // blk, blk, N)[:, hh, _idx(cols, b.device)]
        prod = _product("bnij,bnjk->bnik", vals, b_blocks, b.dtype)
        out = torch.zeros((B, H * Mb, blk, N), dtype=prod.dtype, device=prod.device)
        out.index_add_(1, hh * Mb + _idx(rows, b.device), prod)
        return out.reshape(B, H, Mb * blk, N)

    def _dds(self, a, b):
        """dense [B,H,M,K] @ sparse [B,nnz,blk,blk] -> dense [B,H,M,N]."""
        blk = self.block
        rows, cols = self._sparse_luts(self.trans_b)
        vals = b.transpose(-1, -2) if self.trans_b else b
        if self.trans_a:
            a = a.transpose(-1, -2)
        B, H, M, K = a.shape
        Nb = self.layout.shape[1] if self.trans_b else self.layout.shape[2]
        hh = _idx(self.lut_h, a.device)
        # gather a's K-blocks (the sparse operand's row dim): [B,H,Kb,M,blk]
        a_blocks = a.reshape(B, H, M, K // blk, blk).permute(0, 1, 3, 2, 4)
        a_strips = a_blocks[:, hh, _idx(rows, a.device)]             # [B, nnz, M, blk]
        prod = _product("bnmi,bnij->bnmj", a_strips, vals, a.dtype)
        out = torch.zeros((B, H * Nb, M, blk), dtype=prod.dtype, device=prod.device)
        out.index_add_(1, hh * Nb + _idx(cols, a.device), prod)
        return out.reshape(B, H, Nb, M, blk).permute(0, 1, 3, 2, 4).reshape(B, H, M, Nb * blk)
