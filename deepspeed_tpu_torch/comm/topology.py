"""Slice topology: factorize the data-parallel ranks into two levels.

Counterpart of ``deepspeed_tpu/comm/topology.py`` (copied: the port imports
nothing of the JAX package). A cluster is two networks, not one: within a
node (a TPU slice there, an NVLink domain here) every rank sees the fast
fabric; across nodes traffic rides the slower network. The ``dp`` ranks are
split into ``num_slices`` contiguous blocks of ``slice_size`` ranks, and the
two-level collectives of ``comm/hierarchical.py`` run over the process
groups ``CommGroups`` builds from this factorization: an intra-slice group
per slice (the JAX package's ICI level) and a cross-slice group per local
position (its DCN level). The level names stay ``ici`` and ``dcn`` so that
reports and manifests read as the JAX package's.

Derivation rule (``derive_num_slices``): an explicit ``dcn_slices`` from the
config wins; otherwise each host is one slice (``LOCAL_WORLD_SIZE`` ranks a
host, as ``launcher/launch.py`` sets it: the JAX rule's one slice per
process, since a JAX process holds a host's devices); otherwise a world of 8
ranks on one host factorizes virtually as 2 slices x 4 ranks, the JAX tier-1
mesh's test factorization; anything else stays at one slice.
"""

import os
from typing import List, Optional

import torch.distributed as dist

__all__ = ["CommTopology", "CommGroups", "derive_num_slices", "derive_topology",
           "host_count"]


class CommTopology:
    """Geometric factorization of ``dp`` data-parallel ranks into contiguous
    slices: rank ``d`` sits in slice ``d // slice_size`` at local position
    ``d % slice_size``."""

    def __init__(self, dp: int, num_slices: int):
        dp, num_slices = int(dp), int(num_slices)
        if num_slices < 1:
            raise ValueError(f"num_slices must be >= 1, got {num_slices}")
        if dp % num_slices != 0:
            raise ValueError(
                f"data-parallel size {dp} is not divisible by {num_slices} slices")
        self.dp = dp
        self.num_slices = num_slices
        self.slice_size = dp // num_slices

    @property
    def ici_groups(self) -> List[List[int]]:
        """Intra-slice groups: one a slice, members in local-position order."""
        L = self.slice_size
        return [[s * L + i for i in range(L)] for s in range(self.num_slices)]

    @property
    def dcn_groups(self) -> List[List[int]]:
        """Cross-slice groups: one a local position, members in slice order
        (rank d's position in its group is its slice d // slice_size)."""
        L = self.slice_size
        return [[s * L + i for s in range(self.num_slices)] for i in range(L)]

    @property
    def slice_rows(self) -> List[List[int]]:
        """Data ranks grouped by slice (the desync audit's and the checkpoint
        remapper's view of the same factorization)."""
        return self.ici_groups

    def slice_of(self, rank: int) -> int:
        return int(rank) // self.slice_size

    @property
    def is_hierarchical(self) -> bool:
        return self.num_slices > 1

    def slice_rank_sets(self) -> List[frozenset]:
        """Per-slice sets of ranks: the collective classifier's ground truth
        (the JAX ``slice_device_sets``, with ranks for device ids)."""
        return [frozenset(g) for g in self.ici_groups]

    def __repr__(self):
        return (f"CommTopology(dp={self.dp}, num_slices={self.num_slices}, "
                f"slice_size={self.slice_size})")

    def __eq__(self, other):
        return (isinstance(other, CommTopology) and other.dp == self.dp
                and other.num_slices == self.num_slices)


class CommGroups:
    """The torch process groups of a topology, for this rank: ``ici`` (its
    slice), ``dcn`` (its local position across the slices) and ``world``
    (every data rank), with this rank's position in each. A group of one
    rank is None (the collectives over it are the identity); a level that
    spans every rank is the world group; the others are made here, every
    rank making every group (``dist.new_group`` is collective)."""

    def __init__(self, topo: CommTopology, rank: Optional[int] = None):
        self.topo = topo
        self.rank = (dist.get_rank() if dist.is_initialized() else 0) if rank is None else rank
        S, L = topo.num_slices, topo.slice_size
        self.ici_rank, self.dcn_rank = self.rank % L, self.rank // L
        self.world = dist.group.WORLD if topo.dp > 1 else None
        self.ici = None if L == 1 else self.world if S == 1 else self._mine(topo.ici_groups)
        self.dcn = None if S == 1 else self.world if L == 1 else self._mine(topo.dcn_groups)

    def _mine(self, groups):
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine


def host_count(dp: int) -> int:
    """Hosts the ``dp`` ranks span: ``WORLD_SIZE // LOCAL_WORLD_SIZE`` when
    the launcher named both, else 1."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local and int(local) > 0 and dp % int(local) == 0:
        return dp // int(local)
    return 1


def derive_num_slices(dp: int, requested: int = 0,
                      process_count: Optional[int] = None) -> int:
    """Resolve the slice count for ``dp`` data-parallel ranks.

    ``requested`` (the config's ``comm.dcn_slices``) wins when positive;
    ``0`` means auto: one slice a host when the ranks span several (and the
    hosts tile the ranks evenly), else the virtual 2-slice factorization of 8
    ranks, else 1. ``process_count`` is the number of hosts (``host_count``
    when None)."""
    dp = int(dp)
    requested = int(requested)
    if requested > 0:
        if dp % requested != 0:
            raise ValueError(
                f"comm.dcn_slices={requested} does not divide the data-parallel "
                f"size {dp}")
        return requested
    if process_count is None:
        process_count = host_count(dp)
    if process_count > 1 and dp % process_count == 0:
        return int(process_count)
    if dp == 8:
        return 2  # virtual 2 x 4: the JAX tier-1 mesh's test factorization
    return 1


def derive_topology(dp: int, requested: int = 0,
                    process_count: Optional[int] = None) -> CommTopology:
    """``CommTopology`` from the ``derive_num_slices`` rule."""
    return CommTopology(dp, derive_num_slices(dp, requested, process_count))
