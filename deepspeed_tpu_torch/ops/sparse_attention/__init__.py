from .sparsity_config import (SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
                              VariableSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, BertSparseSelfAttention
from .sparse_attention_utils import SparseAttentionUtils

from .matmul import MatMul, dense_to_sparse, sparse_to_dense
from .softmax import Softmax
