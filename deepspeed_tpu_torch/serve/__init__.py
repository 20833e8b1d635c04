"""Serving engine of the PyTorch port: block-paged KV cache + continuous
batching (counterpart of ``deepspeed_tpu/serve``).

- :mod:`block_allocator`, :mod:`prefix_cache`, :mod:`scheduler` — the host
  side, copied from the JAX package (no device code);
- :mod:`paged` — the fixed-shape paged decode/prefill/verify programs in
  PyTorch, with the paged-decode CUDA kernel behind
  ``serving.use_pallas_decode``, and their CUDA graphs (``GraphedProgram``);
- :mod:`speculative` — the draft side of speculative decoding;
- :mod:`oracle` — the dense-cache mirror (``mirror=True``);
- :mod:`request_trace` — the request ledger (``serving.request_trace``),
  copied from the JAX package (standard library only);
- :mod:`engine` — ``InferenceEngine``, built by
  ``deepspeed_tpu_torch.init_inference``.
"""

from .block_allocator import AllocationError, BlockAllocator  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .scheduler import Request, RequestOutput, Scheduler  # noqa: F401
