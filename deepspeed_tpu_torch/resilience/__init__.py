"""Resilience layer (PyTorch port of ``deepspeed_tpu/resilience``): async
checkpointing, auto-resume and the serving warm restart.

- ``async_ckpt``:  two-phase save — device→host snapshot on the step thread,
  commit-protocol file writes on a background writer thread.
- ``auto_resume``: pick the newest committed checkpoint *before* the flight
  recorder's first bad step; restore the journaled loss scale.
- ``serve_restart``: snapshot and warm restore of a serving replica.
- ``elastic``: restore (and remap across world sizes) of the compressed
  exchange's error feedback.
- ``crash_sim``: ``ds-tpu-torch crash-sim``, kill/restart scenarios over
  all of the above (imported on use: it builds engines and servers).
"""

from .async_ckpt import AsyncCheckpointer
from .auto_resume import auto_resume, find_resume_point
from .elastic import restore_comm_ef

__all__ = ["AsyncCheckpointer", "auto_resume", "find_resume_point", "restore_comm_ef"]
