"""Topology-aware communication (PyTorch port of ``deepspeed_tpu/comm``).

- ``topology``: the two-level factorization of the data-parallel ranks and
  its torch process groups.
- ``hierarchical``: the two-level (reduce-scatter / compressed or plain
  cross-slice exchange / all-gather) schedules and their bucketed forms.
- ``sim``: ``ds-tpu-torch comm-sim``, the per-level collective manifest of
  the three exchanges recorded at 8 ranks (imported on use).
"""

from .topology import CommGroups, CommTopology, derive_num_slices, derive_topology
from .hierarchical import error_state_shapes, two_level_compressed, two_level_sum

__all__ = ["CommGroups", "CommTopology", "derive_num_slices", "derive_topology",
           "two_level_sum", "two_level_compressed", "error_state_shapes"]
