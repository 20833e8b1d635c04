"""Rank-aware logging.

Counterpart of ``deepspeed_tpu/utils/logging.py`` (the reference's
``deepspeed/utils/logging.py``: LoggerFactory, ``log_dist``): a single named
logger plus a rank-filtered helper. The rank is the ``torch.distributed`` rank
when a process group is initialized, else 0.
"""

import logging
import os
import sys
from typing import Iterable, Optional

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


class LoggerFactory:

    @staticmethod
    def create_logger(name: str = "DeepSpeedTorch", level: int = logging.INFO) -> logging.Logger:
        if name is None:
            raise ValueError("name for logger cannot be None")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            handler = logging.StreamHandler(stream=sys.stdout)
            handler.setFormatter(logging.Formatter(_FORMAT))
            handler.setLevel(level)
            logger_.addHandler(handler)
        return logger_


logger = LoggerFactory.create_logger(
    level=getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(), logging.INFO))


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (None or [-1] = all ranks)."""
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else []
    should_log = not ranks or (-1 in ranks) or (my_rank in ranks)
    if should_log:
        logger.log(level, f"[Rank {my_rank}] {message}")


def log_to_stderr() -> None:
    """Move the logger's stdout handler to stderr: a command whose stdout is
    its report (``--json > out.json``) keeps engine-build lines out of it."""
    for h in logger.handlers:
        if isinstance(h, logging.StreamHandler) and h.stream is sys.stdout:
            h.stream = sys.stderr
