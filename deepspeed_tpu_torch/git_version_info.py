"""Version and provenance of the port (``deepspeed_tpu/git_version_info.py``).

The fields are computed from git (``unknown`` outside a checkout) and
``version.txt``. Every field is lazy (PEP 562): importing the package runs
no subprocess, and git is asked only when a field is first read.

``installed_ops`` says which of the port's builds this host can serve, each
built at first use:
- ``cpu_adam``: the host-tier Adam (``csrc/cpu_adam.cpp``), which needs g++;
- ``paged_attention``, ``flash_attention``, ``block_sparse_attention`` and
  ``fused_block``: the CUDA kernels of ``csrc/*.cu``, which need ``nvcc``
  and a card of compute capability 9.0 (they are built for ``sm_90a``).
"""

import os
import shutil
import subprocess

_FIELDS = ("version", "git_hash", "git_branch", "installed_ops")
_CUDA_OPS = ("paged_attention", "flash_attention", "block_sparse_attention", "fused_block")
_cache = None


def _cuda_buildable() -> bool:
    import torch

    from .ops._build import nvcc
    try:
        nvcc()
    except RuntimeError:
        return False
    return torch.cuda.is_available() and torch.cuda.get_device_capability(0) == (9, 0)


def _live():
    here = os.path.dirname(os.path.abspath(__file__))

    def git(cmd):
        try:
            out = subprocess.check_output(["git", *cmd], stderr=subprocess.DEVNULL, cwd=here)
            return out.decode().strip()
        except (OSError, subprocess.CalledProcessError):
            return "unknown"

    try:
        with open(os.path.join(here, "..", "version.txt")) as fd:
            base = fd.read().strip()
    except OSError:
        base = "0.0.0"
    git_hash = git(["rev-parse", "--short", "HEAD"])
    cuda = _cuda_buildable()
    return {
        "version": f"{base}+{git_hash}",
        "git_hash": git_hash,
        "git_branch": git(["rev-parse", "--abbrev-ref", "HEAD"]),
        "installed_ops": {"cpu_adam": shutil.which("g++") is not None,
                          **{op: cuda for op in _CUDA_OPS}},
    }


def _info():
    global _cache
    if _cache is None:
        _cache = _live()
    return _cache


def __getattr__(name):
    if name in _FIELDS:
        return _info()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
