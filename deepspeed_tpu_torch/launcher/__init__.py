"""Cluster launch front-end (the port's ``deepspeed_tpu/launcher/``).

``runner`` is the user-facing CLI (hostfile -> fan-out), ``launch`` the
per-node process spawner, ``multinode_runner`` the pdsh/mpirun backends.
"""

from . import constants  # noqa: F401
