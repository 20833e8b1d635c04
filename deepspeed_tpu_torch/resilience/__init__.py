"""Resilience layer (PyTorch port of ``deepspeed_tpu/resilience``): async
checkpointing, auto-resume and the serving warm restart.

- ``async_ckpt``:  two-phase save — device→host snapshot on the step thread,
  commit-protocol file writes on a background writer thread.
- ``auto_resume``: pick the newest committed checkpoint *before* the flight
  recorder's first bad step; restore the journaled loss scale.
- ``serve_restart``: snapshot and warm restore of a serving replica.

The JAX package's ``elastic`` (the 1-bit error-feedback buffers) and
``crash_sim`` are ROADMAP.md items 18 and 20.
"""

from .async_ckpt import AsyncCheckpointer
from .auto_resume import auto_resume, find_resume_point

__all__ = ["AsyncCheckpointer", "auto_resume", "find_resume_point"]
