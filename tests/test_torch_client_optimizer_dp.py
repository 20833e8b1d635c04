"""A client ``(init, apply)`` optimizer under ZeRO at dp > 1 (PyTorch port), on
the CPU.

The JAX engine hands a client pair global trees
(deepspeed_tpu/runtime/engine.py:917-945): the grads, the master and every
state field that mirrors the param tree are whole; the engine holds each
mirroring field in the master's layout and keeps the others replicated. The
port's engine holds per-rank slices, so it all-gathers them for ``apply``
and keeps its slices of the result. A pair whose ``apply`` couples the
elements of a leaf (each leaf's step normalised by its momentum's norm)
tells the two apart: on slices its update would differ.

Two gloo processes (dp = 2), one spawn for every case, each rank on the same
row of each seeded micro-batch, against one rank on that row alone, at ZeRO
stages 1, 2 and 3, one thread each: each rank's grads are the one rank's
bit for bit and their mean over two ranks is exact, so the losses, the
gathered masters and the whole client state are equal, and the grad norms
agree to the order of their sums (over slices, then over the ranks); the
mirroring
field is held as this rank's slices and the other field whole; the
external-master pair (``runtime/client_optimizers.py``, a state that does not
mirror the param tree) keeps its state replicated, equal to one rank's. In
torch's fake process group of 8 ranks the pair's programs keep their
collective manifests at stages 2 and 3, two-step and fused. The tiny GPT-2
is tests/test_torch_zero3.py's, from the JAX init.
"""

import collections
import functools
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.client_optimizers import shard_optimizer
from deepspeed_tpu_torch.runtime.zero.sharding import unshard, zero_spec

from test_torch_zero3 import _batches, _gpt2, _port_params, _train

STAGES = (1, 2, 3)
ROW = [0]
STEPS = 3

NormState = collections.namedtuple("NormState", ["mom", "count"])


def normalized_momentum(lr=1e-2, beta=0.9):
    """Momentum whose step is ``lr * mom / ||mom||`` per leaf: an ``apply``
    that reads the whole leaf. Its state: ``mom`` mirrors the param tree,
    ``count`` (the steps taken) does not."""

    def init(master):
        leaves = pytree.tree_leaves(master)
        return NormState(mom=pytree.tree_map(torch.zeros_like, master),
                         count=torch.zeros((), device=leaves[0].device))

    def apply(grads, state, master, step, hyper):
        mom = pytree.tree_map(lambda m, g: beta * m + g.float(), state.mom, grads)
        new = pytree.tree_map(lambda p, m: p - lr * m / (torch.linalg.vector_norm(m) + 1e-6),
                              master, mom)
        return new, NormState(mom=mom, count=state.count + 1)

    return init, apply


def _config(stage, dp, micro):
    return {"train_batch_size": micro * dp, "train_micro_batch_size_per_gpu": micro,
            "steps_per_print": 1000, "bf16": {"enabled": True},
            "zero_optimization": {"stage": stage}, "zero_allow_untested_optimizer": True}


PAIRS = {"normalized": normalized_momentum, "external": lambda: shard_optimizer(2)}


def _run(pair, stage, dp, rows, dist_init=None):
    tm, params = _gpt2(_port_params())
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params, optimizer=PAIRS[pair](),
        config_params=_config(stage, dp, 1), device="cpu",
        dist_init_required=dist_init)
    losses, norms = _train(eng, _batches(STEPS, 2), rows)
    out = {"losses": losses, "norms": norms}
    if not eng._external_master:
        out.update({f"master/{n}": unshard(m, a, eng.dp_size).numpy()
                    for (n, m), a in zip(eng.master_params.items(), eng._axes)})
    out.update({f"opt/{k}": np.array(v) for k, v in eng._ckpt_export("opt").items()})
    out["local"] = np.asarray([t.numel() for t in pytree.tree_leaves(eng.opt_state)])
    out["axes"] = np.asarray([-1 if a is None else a for a in eng._client_state_axes])
    return out


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        res = {}
        for pair in PAIRS:
            for stage in STAGES:
                for k, v in _run(pair, stage, 2, ROW, False).items():
                    res[f"{pair}{stage}/{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _gloo_run():
    out_dir = tempfile.mkdtemp(prefix="client_dp_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_worker, args=(port, out_dir), nprocs=2, start_method="spawn",
                       join=True)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in (0, 1)]


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


@functools.lru_cache(maxsize=None)
def _one_rank(pair, stage):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' kernels, in the ranks' order
    try:
        return _run(pair, stage, 1, ROW)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pair_at_dp2_gives_the_dp1_result(pair, stage):
    want = _one_rank(pair, stage)
    for res in _gloo_run():
        got = _sub(res, f"{pair}{stage}")
        np.testing.assert_array_equal(got["losses"], want["losses"])
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6, atol=0)
        for k in want:
            if k.startswith("master/") or k.startswith("opt/"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert sorted(k for k in got if k.startswith("opt/")) == \
            sorted(k for k in want if k.startswith("opt/"))


@pytest.mark.parametrize("stage", STAGES)
def test_mirroring_state_is_sliced_and_the_rest_replicated(stage):
    """``mom`` takes the master's layout (half of each shardable leaf on
    each rank), ``count`` stays whole; at one rank nothing is sliced."""
    tm, params = _gpt2(_port_params())
    shapes = [tuple(p.shape) for p in params.values()]
    n_leaves = len(shapes)
    one = _one_rank("normalized", stage)
    assert list(one["axes"]) == [-1] * (n_leaves + 1)
    for res in _gloo_run():
        got = _sub(res, f"normalized{stage}")
        # NormState leaves: mom in the layout's (sorted-key) order, then count
        axes, local = got["axes"], got["local"]
        assert axes[-1] == -1 and local[-1] == 1
        assert (axes[:-1] >= 0).sum() == sum(zero_spec(s, 2) is not None for s in shapes)
        for a, n_full, held in zip(axes[:-1], one["local"][:-1], local[:-1]):
            assert held == (n_full // 2 if a >= 0 else n_full)
        ext = _sub(res, f"external{stage}")
        assert list(ext["axes"]) == [-1, -1, -1]
        assert list(ext["local"]) == list(_one_rank("external", stage)["local"])


@pytest.mark.parametrize("fused", [False, True], ids=["two_step", "fused"])
@pytest.mark.parametrize("stage", [2, 3])
def test_pair_programs_keep_their_manifests_at_8_ranks(stage, fused):
    """In torch's fake process group of 8 ranks the pair's update
    all-gathers the whole trees (and at stage 3 the forward gathers the
    parameters): each program keeps the collectives its manifest declares.
    (This pair returns new state, which the donation pass names as
    tests/test_torch_lint_programs.py's functional pair shows.)"""
    from deepspeed_tpu_torch.lint.program_passes import ProgramArtifact, run_program_passes
    from deepspeed_tpu_torch.utils.op_record import collective_counts, fake_world
    cfg = dict(_config(stage, 8, 1), fused_step=fused)
    with fake_world(8):
        tm, params = _gpt2(_port_params(), compute=torch.bfloat16)
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=tm, model_parameters=params, optimizer=normalized_momentum(),
            config_params=cfg, device="cpu", dist_init_required=False)
        arts = [ProgramArtifact.capture(n, fn, args, man)
                for n, fn, args, man in eng.lint_programs(_batches(1, 1)[0])]
    assert [a.name for a in arts] == (["fused_step"] if fused
                                      else ["loss_and_grad", "apply_update"])
    assert [v for v in run_program_passes(arts) if v.pass_id == "program-collectives"] == []
    assert collective_counts(arts[-1].program).get("all-gather", 0) >= 1
