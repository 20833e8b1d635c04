from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
                              VariableSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, BertSparseSelfAttention
from .sparse_attention_utils import SparseAttentionUtils

# matmul.py and softmax.py of the JAX package (block-sparse products and
# softmax as XLA code, off the kernel path) come with a later slice
_LATER = ("MatMul", "Softmax", "dense_to_sparse", "sparse_to_dense")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"sparse_attention.{name} is not in the PyTorch port yet: ROADMAP.md item 13 "
            "(sparse_attention matmul.py / softmax.py)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
