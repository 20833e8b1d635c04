"""The (pipe, data, model) grid of a torch world's ranks (PyTorch port).

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh`` of devices with named axes, and its collectives run over
an axis by name. The port's ``Mesh`` is the same grid over the ranks of a
``torch.distributed`` world: a ``PipeModelDataParallelTopology`` (axis order
pipe, data, model: model innermost, so the ranks of a tensor-parallel group
are adjacent), this rank's coordinate in it, and this rank's process group
along each axis (``group(axis)``; None for an axis of one rank, the world
group for an axis that spans the world). ``build_mesh`` keeps the JAX
package's refusal to strand ranks: a grid that covers only some of the world
must name them (``ranks=``).

Megatron's two collectives of tensor parallelism are here as autograd
functions over a group, so that their backward is right:

- ``copy_to_group`` ("f"): identity forward, all-reduce (sum) backward, at the
  input of a column-parallel product;
- ``reduce_from_group`` ("g"): all-reduce (sum) forward, identity backward,
  at the output of a row-parallel product;
- ``gather_from_group``: the pieces of every rank concatenated along a dim
  forward, this rank's piece of the gradient backward.

``fold_tp_seed`` folds a model-axis rank into a dropout seed, as the JAX
model does for its flash kernels (the model's attention and
``model_parallel_seed`` of activation checkpointing both take it).
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .topology import PipeModelDataParallelTopology, axis_process_groups

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (PIPE_AXIS, DATA_AXIS, MODEL_AXIS)


class Mesh:
    """A grid of ranks: ``topology`` (a ``ProcessTopology``), ``rank`` (this
    process's rank in it) and ``groups`` ({axis: torch process group or None}).
    ``shape`` maps each of the three axes to its size (1 for an axis the
    topology lacks)."""

    def __init__(self, topology, rank: int, groups=None):
        self.topology = topology
        self.rank = int(rank)
        self._groups = dict(groups or {})
        self.shape = {a: max(topology.get_dim(a), 1) for a in AXES}

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: one rank, or no
        live world)."""
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an axis the topology
        lacks)."""
        if axis not in self.topology.get_axis_names():
            return 0
        return int(getattr(self.topology.get_coord(self.rank), axis))

    def __repr__(self):
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def build_mesh(data: Optional[int] = None, model: int = 1, pipe: int = 1,
               ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (pipe, data, model) mesh over the world's ranks (or over ``ranks``).

    ``data=None`` means "use all remaining ranks" after model/pipe are placed.
    Without a live ``torch.distributed`` world the world is this one process.
    A mesh that covers fewer ranks than the world raises unless ``ranks``
    names them (the JAX package's ``devices=``)."""
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    me = dist.get_rank() if live else 0
    explicit = ranks is not None
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    if data is None:
        assert n % (model * pipe) == 0, f"{n} ranks not divisible by model*pipe={model * pipe}"
        data = n // (model * pipe)
    total = data * model * pipe
    assert total <= n, f"mesh needs {total} ranks, only {n} available"
    if not explicit and total != n:
        # never strand ranks: a submesh must be an explicit choice
        raise ValueError(f"mesh shape (pipe={pipe}, data={data}, model={model}) covers {total} "
                         f"of {n} ranks; pass ranks=... explicitly to build a submesh")
    ranks = ranks[:total]
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh's ranks {ranks}")
    topo = PipeModelDataParallelTopology(num_pp=pipe, num_mp=model, num_dp=data)
    rank = ranks.index(me)
    groups = axis_process_groups(topo, rank, ranks) if live and total > 1 else {}
    return Mesh(topo, rank, groups)


def mesh_from_mpu(mpu) -> Mesh:
    """The mesh of an mpu/grid object: a ``PipelineParallelGrid``'s own
    (``grid.mesh``, its groups built once), else one built from its (pipe,
    data, model) sizes."""
    mesh = getattr(mpu, "mesh", None)
    if isinstance(mesh, Mesh):
        return mesh
    return build_mesh(data=mpu.get_data_parallel_world_size(),
                      model=mpu.get_slice_parallel_world_size(),
                      pipe=mpu.get_pipe_parallel_world_size())


# the fold of the tp rank into the flash dropout seed (deepspeed_tpu/models/gpt2.py:364-369)
_SEED_FOLD = -1640531527        # 2654435761 as int32


def fold_tp_seed(seed: int, rank: int) -> int:
    """``seed + (rank + 1) * -1640531527`` wrapped to int32, as the JAX model
    folds the tp rank into the kernel's seed (the kernels hash the local head
    index, which repeats across the model-axis ranks)."""
    v = (int(seed) + (int(rank) + 1) * _SEED_FOLD) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


# ---------------------------------------------------------------------------
# Megatron's collectives as autograd functions
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (no grad)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n = x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` forward; the gradient summed over ``group`` backward."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group`` forward; the gradient as it is
    backward."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` forward; this rank's piece
    of the gradient backward."""
    return x if group is None else _GatherFromGroup.apply(x, dim, group)
