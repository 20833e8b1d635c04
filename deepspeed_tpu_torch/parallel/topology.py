"""N-dimensional process topology (PyTorch port).

Copy of ``deepspeed_tpu/parallel/topology.py`` (the JAX package's host-only
module, itself the reference's ``deepspeed/runtime/pipe/topology.py``): the
cartesian rank math is the same, line for line. What the port adds is the
torch process groups. ``PipelineParallelGrid`` builds, when a
``torch.distributed`` world of more than one rank is up, this rank's group
along each of its axes (``axis_process_groups``: ``dist.new_group`` over
``get_axis_comm_lists``, every rank making every group; an axis of one rank
has no group, an axis that spans the world is the world group) and holds
them as a ``parallel.mesh.Mesh`` (``grid.mesh``, ``grid.mesh.group(axis)``).
The ``get_*_group`` methods keep returning rank lists, as in the JAX
package.
"""

from collections import namedtuple
from itertools import product
from typing import Dict, List, Optional

import torch.distributed as dist


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates to linear global ranks.

    The ordering of axes is from outer to inner: the last axis varies fastest
    (row-major, matching the reference).
    """

    def __init__(self, axes: List[str], dims: List[int]):
        self.axes = list(axes)
        self.dims = list(dims)
        assert len(self.axes) == len(self.dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict["ProcessTopology.ProcessCoord", int] = {}
        self._rank_to_coord: List["ProcessTopology.ProcessCoord"] = []
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(self.axes, coord))
            named = self.ProcessCoord(**key)
            self.mapping[named] = global_rank
            self._rank_to_coord.append(named)

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError("get_rank() does not support slices, use filter_match())")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"coord {key} not found in topology."
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank: int, omit_axes=("data", "pipe"), inner_sep="_", outer_sep="-") -> str:
        """Checkpoint-name representation of a rank, omitting data/pipe axes by default."""
        omit_axes = frozenset(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        if 0 <= rank < len(self._rank_to_coord):
            return self._rank_to_coord[rank]
        raise ValueError(f"rank {rank} not found in topology.")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """All communication groups along ``axis``: lists of ranks differing only in
        ``axis``. Computed by bucketing the precomputed rank table on the remaining
        coordinates — one pass, no cartesian re-enumeration. Because ranks enumerate
        coordinates row-major, bucket insertion order reproduces the conventional
        (outer-axes row-major) group ordering and each bucket is ordered by axis index."""
        if axis not in self.axes:
            return []
        ai = self.axes.index(axis)
        buckets: Dict[tuple, List[int]] = {}
        for rank, coord in enumerate(self._rank_to_coord):
            buckets.setdefault(coord[:ai] + coord[ai + 1:], []).append(rank)
        return list(buckets.values())

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match all of the given axis=value filters, ascending
        (rank-table scan order is already ascending)."""
        return [rank for rank, coord in enumerate(self._rank_to_coord)
                if all(getattr(coord, ax) == val for ax, val in filter_kwargs.items())]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    def world_size(self) -> int:
        size = 1
        for d in self.dims:
            size *= d
        return size

    def __str__(self):
        return str(self.mapping)


def _prime_factors(N: int) -> List[int]:
    """Prime factorization in increasing order."""
    if N <= 0:
        raise ValueError("Values must be strictly positive")
    primes = []
    while N != 1:
        for candidate in range(2, N + 1):
            if N % candidate == 0:
                primes.append(candidate)
                N //= candidate
                break
    return primes


class PipeDataParallelTopology(ProcessTopology):
    """Hybrid pipeline + data parallelism: adjacent pipe stages land on the same
    host's devices so activations ride ICI (reference topology.py:235-244)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3-D topology for DP x PP x TP ("model"/slice) parallelism."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Axis bookkeeping for a 2-D/3-D grid, serving as the rebuild's ``mpu``.

    The ``get_*_group`` methods return *rank lists*, as in the JAX package; the
    torch process groups (the reference's, topology.py:299-364) are built when a
    ``torch.distributed`` world of ``world_size`` ranks is up: ``mesh`` (a
    ``parallel.mesh.Mesh``; ``mesh.group(axis)``). ``global_rank`` defaults to this
    process's rank in that world (0 without one). The rank math (stage_id,
    data_parallel_id, p2p neighbors) is preserved so schedules and checkpoint layouts
    match.
    """

    def __init__(self, topology: Optional[ProcessTopology] = None, world_size: Optional[int] = None,
                 global_rank: Optional[int] = None):
        if world_size is None:
            world_size = topology.world_size() if topology is not None else 1
        if global_rank is None:
            global_rank = dist.get_rank() if dist.is_initialized() else 0
        self.global_rank = global_rank
        self.world_size = world_size
        if topology is not None:
            self._topo = topology
        else:
            # Default: split world into pipe x data using prime factors (reference l.279-287).
            num_pp = 1
            num_dp = 1
            for idx, prime in enumerate(_prime_factors(world_size)):
                if idx % 2 == 0:
                    num_pp *= prime
                else:
                    num_dp *= prime
            self._topo = PipeDataParallelTopology(num_pp=num_pp, num_dp=num_dp)
        self.data_parallel_size = max(self._topo.get_dim("data"), 1)
        self.pipe_parallel_size = max(self._topo.get_dim("pipe"), 1)
        self.model_parallel_size = max(self._topo.get_dim("model"), 1)
        assert self._is_grid_valid(), "Invalid Grid"

        self.stage_id = self.get_stage_id()
        self.data_parallel_id = self.get_data_parallel_id()

        # Rank lists per axis (the reference's process groups).
        self.ds_model_proc_group = None
        self.ds_model_rank = -1
        for dp in range(self.data_parallel_size):
            # "model" group in DeepSpeed-speak = all non-data ranks (pipe x slice).
            ranks = sorted(self._topo.filter_match(data=dp))
            if self.global_rank in ranks:
                self.ds_model_proc_group = ranks
                self.ds_model_world_size = len(ranks)
                self.ds_model_rank = ranks.index(self.global_rank)
        assert self.ds_model_rank > -1
        assert self.ds_model_proc_group is not None

        self.dp_group = []
        self.dp_groups = self._topo.get_axis_comm_lists("data")
        for g in self.dp_groups:
            if self.global_rank in g:
                self.dp_group = g

        self.is_first_stage = self.stage_id == 0
        self.is_last_stage = self.stage_id == (self.pipe_parallel_size - 1)

        self.p2p_groups = self._build_p2p_groups()

        self.pp_group = []
        self.pipe_groups = self._topo.get_axis_comm_lists("pipe")
        for g in self.pipe_groups:
            if self.global_rank in g:
                self.pp_group = g

        self.slice_group = []
        self.slice_proc_group = None
        if "model" in self._topo.get_axis_names():
            self.mp_group = []
            self.model_groups = self._topo.get_axis_comm_lists("model")
            for g in self.model_groups:
                if self.global_rank in g:
                    self.slice_group = g
                    self.slice_proc_group = g
        else:
            self.slice_group = [self.global_rank]
            self.slice_proc_group = [self.global_rank]

        # the torch process groups, in a live world of this grid's size
        from .mesh import Mesh
        live = dist.is_initialized() and dist.get_world_size() == self.world_size > 1
        self.mesh = Mesh(self._topo, self.global_rank,
                         axis_process_groups(self._topo, self.global_rank) if live else {})

    def get_stage_id(self) -> int:
        return self._topo.get_coord(rank=self.global_rank).pipe

    def get_data_parallel_id(self) -> int:
        return self._topo.get_coord(rank=self.global_rank).data

    def _build_p2p_groups(self) -> List[List[int]]:
        """Adjacent-stage rank pairs, incl. wrap-around (reference topology.py:372-387)."""
        comm_lists = self._topo.get_axis_comm_lists("pipe")
        p2p_lists = []
        for rank in range(self.world_size):
            for l in comm_lists:
                assert len(l) == self.pipe_parallel_size
                if rank in l:
                    idx = l.index(rank)
                    buddy_rank = l[(idx + 1) % self.pipe_parallel_size]
                    p2p_lists.append([rank, buddy_rank])
                    break
        assert len(p2p_lists) == self.world_size
        return p2p_lists

    def _is_grid_valid(self) -> bool:
        ranks = 1
        for ax in self._topo.get_axis_names():
            ranks *= self._topo.get_dim(ax)
        return ranks == self.world_size

    def stage_to_global(self, stage_id: int, **kwargs) -> int:
        me = self._topo.get_coord(self.global_rank)
        transform = me._replace(pipe=stage_id, **kwargs)._asdict()
        return self._topo.get_rank(**transform)

    def topology(self) -> ProcessTopology:
        return self._topo

    # -- mpu interface (reference topology.py:405-455) --
    def get_global_rank(self) -> int:
        return self.global_rank

    def get_pipe_parallel_rank(self) -> int:
        return self.stage_id

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self) -> List[int]:
        return self.pp_group

    def get_data_parallel_rank(self) -> int:
        return self.data_parallel_id

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_data_parallel_group(self) -> List[int]:
        return self.dp_group

    def get_model_parallel_rank(self) -> int:
        return self.ds_model_rank

    def get_model_parallel_world_size(self) -> int:
        return self.ds_model_world_size

    def get_model_parallel_group(self) -> List[int]:
        return self.ds_model_proc_group

    def get_slice_parallel_rank(self) -> int:
        if "model" in self._topo.get_axis_names():
            return self._topo.get_coord(rank=self.global_rank).model
        return 0

    def get_slice_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def get_slice_parallel_group(self) -> List[int]:
        return self.slice_group


def axis_process_groups(topo: ProcessTopology, rank: int, ranks: Optional[List[int]] = None):
    """{axis: ``rank``'s torch process group along it} for every axis of ``topo``.
    An axis of one rank has no group (None); an axis spanning every rank of the
    world is the world group; the others are made here with ``dist.new_group``
    over ``get_axis_comm_lists`` (collective: every rank makes every group, in
    the same order). ``ranks`` maps topology ranks to world ranks (default:
    the identity)."""
    world = dist.get_world_size()
    out = {}
    for axis in topo.get_axis_names():
        size = topo.get_dim(axis)
        if size <= 1:
            out[axis] = None
        elif size == world:
            out[axis] = dist.group.WORLD
        else:
            for members in topo.get_axis_comm_lists(axis):
                g = dist.new_group([ranks[m] if ranks is not None else m for m in members])
                if rank in members:
                    out[axis] = g
    return out
