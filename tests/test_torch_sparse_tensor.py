"""Row-sparse gradients (``runtime/sparse_tensor.py`` and the engine's
``sparse_gradients``) against the JAX package's ``SparseTensor`` and against
the dense mean:

- ``from_dense`` / ``to_dense`` / ``add`` / ``sparse_size`` equal JAX's on the
  same tables, a genuinely nonzero row 0 kept apart from the empty slots;
- over two gloo processes, ``row_sparse_allreduce`` equals the dense mean
  (the gathered rows scatter-added in rank order: bit for bit at dp = 2);
- the engine with ``sparse_gradients`` (an untied embedding named by
  ``sparse_grad_paths``) trains bit for bit as the dense reduction at ZeRO 0
  and ZeRO 2, the table reduced by the gather; the ``sparse_grad_tokens``
  hint sizes the capacity when the token ids are not batch arg 0.
"""

import os
import socket
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.sparse_tensor import SparseTensor as JSparse
from deepspeed_tpu_torch.runtime import sparse_tensor as st

VOCAB, WIDTH = 512, 16


class UntiedEmbed(nn.Module):
    """A classifier over an untied embedding table: its grad is row-sparse."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(torch.randn(VOCAB, WIDTH, generator=g) * 0.02)
        self.head = nn.Module()
        self.head.w = nn.Parameter(torch.randn(WIDTH, 4, generator=g) * 0.02)

    def sparse_grad_paths(self):
        return ("embed/table",)

    def forward(self, tokens, labels):
        x = self.embed.table[tokens.long()].mean(dim=1)
        logits = (x @ self.head.w.to(x.dtype)).float()
        return -torch.log_softmax(logits, -1).gather(-1, labels.long()[:, None]).mean()


class LabelsFirst(UntiedEmbed):
    """Token ids second: the capacity comes from the ``sparse_grad_tokens``
    hint, not from batch arg 0 (the labels)."""

    def sparse_grad_tokens(self, labels, tokens):
        return int(tokens.numel())

    def forward(self, labels, tokens):
        return super().forward(tokens, labels)


def _table(seed=0, rows=64, nnz=10):
    rng = np.random.default_rng(seed)
    dense = np.zeros((rows, 8), np.float32)
    idx = rng.choice(rows, nnz, replace=False)
    dense[idx] = rng.normal(size=(nnz, 8)).astype(np.float32)
    dense[0] = rng.normal(size=8).astype(np.float32)        # a real row 0
    return dense


@pytest.mark.parametrize("capacity", [None, 11, 20])
def test_sparse_tensor_equals_jax(capacity):
    dense = _table()
    ours = st.SparseTensor.from_dense(torch.from_numpy(dense), capacity)
    theirs = JSparse.from_dense(jnp.asarray(dense), capacity)
    np.testing.assert_array_equal(ours.indices.numpy(), np.asarray(theirs.indices))
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(theirs.values))
    np.testing.assert_array_equal(ours.to_dense().numpy(), np.asarray(theirs.to_dense()))
    np.testing.assert_array_equal(ours.to_dense().numpy(), dense)
    both = ours.add(ours)
    np.testing.assert_array_equal(both.to_dense().numpy(),
                                  np.asarray(theirs.add(theirs).to_dense()))
    assert ours.sparse_size() == theirs.sparse_size()
    assert st.match_sparse_paths("embed/table", ("embed/table",))
    assert not st.match_sparse_paths("head/w", ("embed/table",))


def _config(sparse, stage):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
            "steps_per_print": 1000, "sparse_gradients": sparse,
            "bf16": {"enabled": stage > 0},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": stage}}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (8, 12)).astype(np.int64),
            rng.integers(0, 4, (8,)).astype(np.int64))


def _worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    res = {}
    try:
        dense = torch.from_numpy(_table(seed=rank))
        got = st.row_sparse_allreduce(dense, capacity=11)
        want = dense.clone()
        dist.all_reduce(want)
        res["allreduce_equal"] = np.asarray(torch.equal(got, want / 2))
        tokens, labels = _batch()
        rows = slice(4 * rank, 4 * rank + 4)
        for stage in (0, 2):
            for labels_first in (False, True):
                for sparse in (False, True):
                    eng, _, _, _ = deepspeed_tpu_torch.initialize(
                        model=LabelsFirst() if labels_first else UntiedEmbed(),
                        config_params=_config(sparse, stage), device="cpu",
                        dist_init_required=False)
                    if sparse:
                        assert eng._exchange_kind == "sparse"
                        assert eng._sparse_flags == [True, False]
                    calls = []
                    real = st.row_sparse_allreduce
                    st.row_sparse_allreduce = lambda *a, **k: calls.append(1) or real(*a, **k)
                    try:
                        for _ in range(3):
                            batch = ((labels[rows], tokens[rows]) if labels_first
                                     else (tokens[rows], labels[rows]))
                            loss = eng(*batch)
                            eng.backward(loss)
                            eng.step()
                    finally:
                        st.row_sparse_allreduce = real
                    key = f"{stage}/{labels_first}/{sparse}"
                    res[f"{key}/gathers"] = np.asarray(len(calls))
                    for k, v in eng.master_params.items():
                        res[f"{key}/{k}"] = v.numpy()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"r{rank}.npz"), **res)


@pytest.fixture(scope="module")
def run2():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="sparse_dp2_")
    mp.start_processes(_worker, args=(port, out_dir), nprocs=2, start_method="spawn",
                       join=True)
    return [dict(np.load(os.path.join(out_dir, f"r{r}.npz"))) for r in (0, 1)]


def test_row_sparse_allreduce_equals_dense_mean(run2):
    assert all(bool(r["allreduce_equal"]) for r in run2)


@pytest.mark.parametrize("stage", [0, 2])
@pytest.mark.parametrize("labels_first", [False, True], ids=["tokens-first", "hint"])
def test_engine_sparse_gradients_equal_dense(run2, stage, labels_first):
    for res in run2:
        key = f"{stage}/{labels_first}"
        # the table went through the gather once a step (48 tokens < 512 rows)
        assert int(res[f"{key}/True/gathers"]) == 3
        assert int(res[f"{key}/False/gathers"]) == 0
        for name in ("embed.table", "head.w"):
            np.testing.assert_array_equal(res[f"{key}/True/{name}"],
                                          res[f"{key}/False/{name}"], err_msg=name)
