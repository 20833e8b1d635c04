"""Row-sparse gradients for embedding tables.

Counterpart of ``deepspeed_tpu/runtime/sparse_tensor.py`` (the reference's
``deepspeed/runtime/csr_tensor.py`` and its CSR allreduce,
``deepspeed/runtime/engine.py:1091-1147``): an embedding gradient is
row-sparse (a token's backward touches one table row), so the data-parallel
reduction ships (indices, values) instead of the dense [vocab, width] array.

``SparseTensor`` carries a **fixed capacity** k of rows, as the JAX one:
``from_dense`` keeps up to k nonzero rows (k = the local token count bounds
the nonzero rows of an embedding gradient, so nothing is dropped), and every
rank then contributes exactly k rows to the all-gathers, with no size
exchange. Empty slots point at row 0 with zero values, so the scatter-add of
``to_dense`` ignores them. The scatter-add is ``index_put_`` with
``accumulate=True``; duplicate rows from several ranks accumulate, in an
order the device may choose (float atomics on CUDA).
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class SparseTensor:
    """Fixed-capacity row-sparse tensor (reference csr_tensor.py:11-59).

    ``indices``: int64 [k] row ids (unused slots 0), ``values``: [k, cols]
    (unused slots 0), ``dense_shape``: (rows, cols)."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 dense_shape: Tuple[int, int]):
        self.indices = indices
        self.values = values
        self.dense_shape = tuple(dense_shape)

    @staticmethod
    def type() -> str:
        return "deepspeed_tpu_torch.SparseTensor"

    @classmethod
    def from_dense(cls, dense: torch.Tensor, capacity: Optional[int] = None) -> "SparseTensor":
        """Up to ``capacity`` rows with any nonzero entry (abs-sum test), in
        ascending row order; rows beyond the capacity are dropped (pass one
        that bounds the nonzero rows, the token count for an embedding)."""
        rows = dense.shape[0]
        k = rows if capacity is None else min(capacity, rows)
        row_mass = torch.sum(torch.abs(dense), dim=1)
        nz = row_mass > 0
        # the k first nonzero rows without a host sync: a stable sort puts
        # the nonzero rows first, in row order
        order = torch.argsort((~nz).to(torch.int8), stable=True)[:k]
        valid = nz[order]
        idx = torch.where(valid, order, torch.zeros_like(order))
        values = dense[idx] * valid[:, None].to(dense.dtype)
        return cls(idx, values, tuple(dense.shape))

    def to_dense(self) -> torch.Tensor:
        """Scatter-add the rows back (reference csr_tensor.py:29-35);
        duplicate indices accumulate."""
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_((self.indices,), self.values, accumulate=True)

    def sparse_size(self) -> Tuple[int, int]:
        index_size = self.indices.shape[0]
        value_size = self.values.shape[0] * self.values.shape[1]
        dense_size = self.dense_shape[0] * self.dense_shape[1]
        return index_size + value_size, dense_size

    def add(self, other: "SparseTensor") -> "SparseTensor":
        """Concatenate entries (reference csr_tensor.py:45-48); duplicates
        resolve at ``to_dense``."""
        assert self.dense_shape == other.dense_shape
        return SparseTensor(torch.cat([self.indices, other.indices]),
                            torch.cat([self.values, other.values]), self.dense_shape)

    def __repr__(self):
        sparse_size, dense_size = self.sparse_size()
        return (f"SparseTensor(k={self.indices.shape[0]}, dense_shape={self.dense_shape}, "
                f"reduction_factor={dense_size / max(sparse_size, 1):.1f})")


def row_sparse_allreduce(dense_local: torch.Tensor, capacity: int, group=None,
                         mean: bool = True) -> torch.Tensor:
    """The mean (or sum) over the ranks of a row-sparse gradient, by
    all-gathering (indices, values) instead of all-reducing the dense table
    (reference engine.py:1105-1127). Ships world * k * (cols + 1) elements
    against rows * cols."""
    st = SparseTensor.from_dense(dense_local, capacity)
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world > 1:
        idx = [torch.empty_like(st.indices) for _ in range(world)]
        val = [torch.empty_like(st.values) for _ in range(world)]
        dist.all_gather(idx, st.indices, group=group)
        dist.all_gather(val, st.values.contiguous(), group=group)
        st = SparseTensor(torch.cat(idx), torch.cat(val), st.dense_shape)
    dense = st.to_dense()
    if mean:
        dense = dense / world
    return dense.to(dense_local.dtype)


def match_sparse_paths(path_str: str, patterns: Sequence[str]) -> bool:
    """Leaf-path matcher for the engine's sparse-grad selection: a leaf whose
    JAX-style path ("wte", "blocks/0/...") contains one of ``patterns``."""
    return any(p in path_str for p in patterns)


# the reference's name (deepspeed/runtime/csr_tensor.py exports CSRTensor)
CSRTensor = SparseTensor
