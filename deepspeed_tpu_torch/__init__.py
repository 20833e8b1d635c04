"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

A package of its own beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and never ``deepspeed_tpu``. Four slices
are ported: serving, ``init_inference`` -> ``serve.InferenceEngine`` over the
paged KV pool and ``models.gpt2``, with the paged-decode kernel in CUDA
(``csrc/paged_decode.cu``); training, ``initialize`` ->
``runtime.engine.DeepSpeedEngine`` (ZeRO 0-2 over ``torch.distributed``)
with the flash-attention kernels in CUDA (``csrc/flash_attention.cu``); and
long-sequence training with block-sparse attention over a ``SparsityConfig``
layout (``ops.sparse_attention``), its kernels in CUDA
(``csrc/block_sparse_attention.cu``); and the fused attention half of a
GPT-2 block (``GPT2Config.fused_block``, ``csrc/fused_block_tc.cu`` on the
tensor cores, ``csrc/fused_block.cu`` on the CUDA cores) with the
BERT family (``models.bert`` over ``ops.transformer``). Serving runs its
programs as CUDA graphs on the card and takes speculative decoding, the
dense mirror, the request tracer and warm restart
(``resilience.serve_restart``); GPT-2 has ``generate`` and ``beam_search``.
Training takes activation checkpointing (``GPT2Config.remat`` / ``remat_policy``, the
config's ``activation_checkpointing`` block; ``checkpointing``), client
``(init, apply)`` optimizers, ZeRO-Offload, and checkpoints in the JAX
package's format (``checkpoint``) with the ``resilience`` block, and the
data-parallel exchanges: 1-bit Adam (``ops.onebit_adam``), the two-level and
compressed schedules and their bucketed overlap (``comm``), row-sparse
gradients (``runtime.sparse_tensor``), ZeRO stage 3, and Megatron tensor
parallelism (``parallel``: the topology, the grid with its process groups,
the mesh; ``initialize(mpu=..., param_shardings=...)``), with head-sharded
serving (``serving.sharding.model``), and pipeline parallelism
(``PipelineModule`` / ``LayerSpec`` / ``TiedLayerSpec`` through
``initialize`` -> ``PipelineEngine``: the instruction executor on one
device, or the per-rank executor over a pipe group,
``parallel.pipeline_spmd``; ``models.gpt2_pipe.GPT2Pipe``). ``models.resnet``
is the CIFAR ResNet; ``resilience.crash_sim`` the kill/restart harness.
Entry points run on the card unless the caller passes ``device="cpu"``.
``__version__``, ``__git_hash__``, ``__git_branch__`` and ``installed_ops``
are read lazily (``git_version_info``); ``deepspeed_tpu_torch.pt`` is the
reference's legacy module alias. ROADMAP.md lists what later slices bring.
"""

import sys as _sys
import types as _types

from . import git_version_info as _gvi
from .runtime import config as _rt_config, utils as _rt_utils
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.activation_checkpointing import checkpointing  # noqa: F401
from .parallel.pipe import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: F401


def __getattr__(name):
    # lazy provenance (PEP 562): no git subprocess at import time
    _map = {"__version__": "version", "__git_hash__": "git_hash",
            "__git_branch__": "git_branch", "installed_ops": "installed_ops"}
    if name in _map:
        return getattr(_gvi, _map[name])
    if name == "PipelineEngine":
        # the engine loads with its first use
        from .runtime.pipe.engine import PipelineEngine
        return PipelineEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# the legacy ``deepspeed.pt`` module structure (deepspeed_tpu/__init__.py:134-145)
pt = _types.ModuleType("pt", "legacy pt module alias for backwards compatibility")
pt.deepspeed_utils = _rt_utils
pt.deepspeed_config = _rt_config
_sys.modules[__name__ + ".pt"] = pt
_sys.modules[__name__ + ".pt.deepspeed_utils"] = _rt_utils
_sys.modules[__name__ + ".pt.deepspeed_config"] = _rt_config


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
               collate_fn=None, config_params=None, device=None, param_shardings=None):
    """Initialize the training engine (``deepspeed.initialize``-shaped).

    ``model`` is a ``torch.nn.Module`` whose ``forward(*batch)`` returns the
    loss (``models.gpt2.GPT2Model`` does, given labels, and the
    ``models.bert`` heads); ``model_parameters``
    an optional name -> tensor dict loaded into it (``params_from_jax``
    gives one). The engine runs on ``device``: the card unless ``"cpu"``; no
    card and no ``"cpu"`` raises. With ``WORLD_SIZE`` > 1 in the environment
    the process group is joined first (``runtime/dist.py``). ``mpu`` (a
    ``parallel.PipelineParallelGrid``, or any object with the mpu sizes)
    gives the engine its (pipe, data, model) mesh; with
    ``param_shardings=model.param_shardings(mesh)`` the model is
    tensor-parallel over the model axis (Megatron's layout) and ZeRO
    partitions over the data axis. Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``."""
    from .runtime.engine import make_engine

    engine = make_engine(args=args, model=model, optimizer=optimizer,
                         model_parameters=model_parameters, training_data=training_data,
                         lr_scheduler=lr_scheduler, mpu=mpu,
                         dist_init_required=dist_init_required, collate_fn=collate_fn,
                         config_params=config_params, device=device,
                         param_shardings=param_shardings)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def add_config_arguments(parser):
    """Add the DeepSpeed arguments (``--deepspeed``, ``--deepspeed_config``,
    ``--deepspeed_mpi``) to an argparse parser and return it."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code, no impact on engine)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration.")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI; this flag will force multi-host distributed init.")
    return parser


def init_inference(model, model_parameters=None, config_params=None,
                   device=None, telemetry=None, mirror=False, draft_model=None,
                   draft_parameters=None):
    """Build the serving engine (``deepspeed.init_inference``-shaped).

    ``model`` is a ``models.gpt2.GPT2Model``; it is moved to ``device`` (the
    card unless ``"cpu"``; no card and no ``"cpu"`` raises). ``model_parameters``
    is an optional name -> tensor dict loaded into it (``params_from_jax``
    gives one). ``config_params`` is a DeepSpeed config dict or path whose
    ``"serving"`` block sizes the paged KV pool and the scheduler, and turns
    on the request tracer and speculation. Returns a ``serve.InferenceEngine``:
    ``submit()`` requests, drive ``step()`` (or ``run()``) to completion.
    ``mirror=True`` runs the dense-cache oracle in bitwise lockstep (it
    doubles the work). ``serving.speculation.enabled`` needs the live draft
    here: ``draft_model`` (a ``GPT2Model``, moved to ``device``; the target
    itself for a self-draft) and optionally ``draft_parameters`` to load into
    it (the config's ``draft_model`` string is a report label). ``telemetry``
    is a ``utils.telemetry.TelemetrySession``: the engine's captures (or, on
    the CPU, first calls) reach its compile watchdog and every iteration
    emits ``Serving/*`` scalars through its monitor. ``serving.sharding.model``
    > 1 shards the attention heads and the KV pools over the ranks of the
    ``torch.distributed`` world, which must have that many: every rank calls
    this and drives the same requests. A module whose parameters are slices (a ZeRO
    stage-3 or tensor-parallel engine's) serves from its whole leaves."""
    from .device import resolve_device
    from .serve.engine import InferenceEngine

    dev = resolve_device(device)
    config_params = config_params if config_params is not None else {}
    if isinstance(config_params, dict):
        config_params = dict(config_params)
        # serving is batch-free; satisfy the training config's batch check
        if not any(k in config_params for k in
                   ("train_batch_size", "train_micro_batch_size_per_gpu")):
            config_params["train_batch_size"] = 1
    ds_config = DeepSpeedConfig(config_params, world_size=1)
    model.to(dev)
    if draft_model is not None:
        draft_model.to(dev)
    return InferenceEngine(
        model, model_parameters,
        num_slots=ds_config.serving_max_seqs,
        block_size=ds_config.serving_block_size,
        num_blocks=ds_config.serving_num_blocks,
        max_model_len=ds_config.serving_max_model_len,
        prefill_chunk=ds_config.serving_prefill_chunk,
        use_pallas=ds_config.serving_use_pallas_decode,
        telemetry=telemetry, mirror=mirror,
        prefix_cache=ds_config.serving_prefix_cache_enabled,
        sharding={"model": ds_config.serving_sharding_model},
        request_trace={
            "enabled": ds_config.serving_request_trace_enabled,
            "capacity": ds_config.serving_request_trace_capacity,
            "iteration_capacity":
                ds_config.serving_request_trace_iteration_capacity,
            "dump_dir": ds_config.serving_request_trace_dump_dir,
            "slo": {"ttft_ms": ds_config.serving_slo_ttft_ms,
                    "tpot_ms": ds_config.serving_slo_tpot_ms},
        },
        speculation={
            "enabled": True,
            "draft_model": draft_model,
            "draft_params": draft_parameters,
            "max_draft_tokens":
                ds_config.serving_speculation_max_draft_tokens,
            "draft_pool_blocks":
                ds_config.serving_speculation_draft_pool_blocks,
        } if ds_config.serving_speculation_enabled else None)
