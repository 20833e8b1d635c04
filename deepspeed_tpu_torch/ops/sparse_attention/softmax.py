"""Block-sparse softmax over layout-active blocks.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/softmax.py``: a
numerically stable softmax across each logical row of a block-sparse score
matrix, with optional scale, relative position embedding, key-padding mask
and attention mask. A row is spread over several blocks, so its max and sum
are scatter reductions over a row-segment LUT. Torch ops on tensors of any
device. The sparse format is ``matmul.MatMul``'s: ``[batch, nnz, block,
block]`` in row-major ``(head, row_block, col_block)`` layout order.
"""

import numpy as np
import torch

from .matmul import _idx, _lut

__all__ = ["Softmax"]


class Softmax:
    """softmax(scale*x + rpe + masks) across logical rows of the sparse matrix."""

    def __init__(self, layout, block: int):
        self.layout = np.asarray(layout)
        self.block = int(block)
        self.lut_h, self.lut_i, self.lut_j = _lut(self.layout)
        H, Mb, Nb = self.layout.shape
        # segment id of each nonzero block = its logical (head, row-block) pair
        self.row_seg = self.lut_h * Mb + self.lut_i
        self.num_segs = H * Mb

    def __call__(self, x, scale: float = 1.0, rpe=None, key_padding_mask=None,
                 attn_mask=None, key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        blk = self.block
        B, nnz, _, _ = x.shape
        if nnz != len(self.lut_h):
            raise ValueError(f"values nnz={nnz} does not match layout nnz={len(self.lut_h)}")
        dtype, dev = x.dtype, x.device
        hh, ii, jj = (_idx(a, dev) for a in (self.lut_h, self.lut_i, self.lut_j))
        x = x.float() * scale
        neg_inf = torch.full((), -torch.inf, device=dev)

        if rpe is not None:
            # [H, T, T] / [1, T, T] relative position bias, or [B, H, T, T] for a
            # per-batch bias, gathered blockwise either way
            rpe = torch.as_tensor(rpe, device=dev).float()
            H = self.layout.shape[0]
            T = rpe.shape[-1]
            if rpe.dim() == 4:
                rpe = rpe.expand(rpe.shape[0], H, T, T)
                rpe_blocks = (rpe.reshape(rpe.shape[0], H, T // blk, blk, T // blk, blk)
                              .permute(0, 1, 2, 4, 3, 5))
                x = x + rpe_blocks[:, hh, ii, jj]
            else:
                rpe = rpe.expand(H, T, T)
                rpe_blocks = rpe.reshape(H, T // blk, blk, T // blk, blk).permute(0, 1, 3, 2, 4)
                x = x + rpe_blocks[hh, ii, jj][None]

        if attn_mask is not None:
            # [T, T] mask over (query, key) positions. "mul": zero mask lanes
            # become -inf before the row reduction; nonzero lanes leave the
            # score unchanged (the mask value never scales it).
            attn_mask = torch.as_tensor(attn_mask, device=dev).float()
            T = attn_mask.shape[-1]
            am_blocks = attn_mask.reshape(T // blk, blk, T // blk, blk).permute(0, 2, 1, 3)
            am = am_blocks[ii, jj][None]
            x = torch.where(am == 0.0, neg_inf, x) if attn_mask_mode == "mul" else x + am

        if key_padding_mask is not None:
            # [B, T] mask over key positions (broadcast down each block row)
            key_padding_mask = torch.as_tensor(key_padding_mask, device=dev).float()
            kp = key_padding_mask.reshape(B, -1, blk)[:, jj][:, :, None, :]   # [B, nnz, 1, blk]
            x = (torch.where(kp == 0.0, neg_inf, x) if key_padding_mask_mode == "mul"
                 else x + kp)

        # --- segmented stable softmax across each logical row ---
        seg = _idx(self.row_seg, dev)
        seg_b = seg[None, :, None].expand(B, nnz, blk)
        rowmax = torch.full((B, self.num_segs, blk), -torch.inf, device=dev)
        rowmax = rowmax.scatter_reduce(1, seg_b, x.detach().amax(dim=-1), "amax")
        shifted = x - rowmax[:, seg][..., None]
        # fully-masked rows: exp(-inf - -inf) = nan -> force 0
        ex = torch.where(torch.isnan(shifted), torch.zeros((), device=dev), torch.exp(shifted))
        rowsum = torch.zeros((B, self.num_segs, blk), device=dev)
        rowsum = rowsum.index_add(1, seg, ex.sum(dim=-1))
        denom = rowsum[:, seg][..., None]
        ok = denom > 0
        out = torch.where(ok, ex / torch.where(ok, denom, torch.ones((), device=dev)),
                          torch.zeros((), device=dev))
        return out.to(dtype)
