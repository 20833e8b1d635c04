"""Where the port's entry points run.

Everything runs on the card unless the caller names the CPU: ``None`` means
``"cuda"``, and a CUDA device that is not there is an error, never a quiet
run on the CPU. ``"meta"`` builds a model with no storage, for a caller that
materializes it later (``Module.to_empty``) in the dtype it chooses.
"""

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or 'meta'")
    return dev
