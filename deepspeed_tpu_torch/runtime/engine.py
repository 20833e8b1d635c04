"""DeepSpeedEngine: the training wrapper (PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/engine.py`` with its API and
semantics: ``loss = engine(*batch); engine.backward(loss); engine.step()``
with gradient-accumulation boundaries; a float32 master copy of every
parameter, the module's own parameters as the compute-dtype copy; the loss
scaled by ``scale / gradient_accumulation_steps`` before the backward; grads
in ``grad_dtype`` (the compute dtype at ZeRO stage >= 2, float32 below,
``allreduce_always_fp32`` / ``communication_data_type`` override it), moved
after every micro-step into an accumulator that is float32 when the window
spans several micro-batches; at the boundary the fp16 overflow check and
unscale, the global norm, clipping, the optimizer (skipped on overflow), the
loss-scaler update, the master -> compute re-cast, and the LR scheduler on
clean steps only.

ZeRO over ``torch.distributed``, explicit where the JAX package leaves it to
GSPMD (``zero/sharding.py``). Each rank runs its own micro-batch; its loss is
the mean over its rows, so the mean of the ranks' gradients is the JAX
global-batch gradient when the ranks hold equal numbers of valid labels.
- stage 0: grads all-reduced (mean); master and moments whole on each rank;
- stage 1: grads all-reduced; each rank holds and updates only its
  ``zero_spec`` slice of master and moments, then the compute params are
  all-gathered;
- stage 2: as stage 1, but each micro-step's grads are reduce-scattered into
  a sharded accumulator;
- leaves ``zero_spec`` keeps replicated (under 1024 elements, or no
  divisible axis) are all-reduced and updated whole on every rank;
- the global norm sums the sharded squares over the ranks.
With one rank every collective is skipped.

The mean over the ranks is the exchange ``_configure_exchange`` picks, in
the JAX engine's precedence (deepspeed_tpu/runtime/engine.py:1060-1301):
1-bit Adam (``optimizer.type: OneBitAdam``, ZeRO 0, one group) keeps each
rank's grads local and averages its momentum with the compressed
allreduce (``ops/onebit_adam.py``); ``sparse_gradients`` all-gathers the
(indices, values) of the model's ``sparse_grad_paths`` tables
(``runtime/sparse_tensor.py``); ``comm.overlap.mode: bucketed`` cuts the
grads into buckets whose exchange begins from the grad hooks as the
backward completes each (``register_post_accumulate_grad_hook``,
asynchronous collectives waited on before the update); ``comm.mode:
hierarchical`` runs the two-level schedule over the ``comm.dcn_slices``
topology (``comm/``); ``hierarchical_compressed`` switches to the
error-feedback compressed exchange at ``comm.compress_start_step``, the
engine holding its error feedback (``_comm_we`` / ``_comm_se``, saved with
checkpoints and remapped across world sizes, ``resilience/elastic.py``).
The flat vectors are in the JAX package's leaf order (``_jax_order``), so
the 1-bit state and the error feedback keep the JAX checkpoint's layout.

The engine updates master, moments and accumulators in place (the JAX
functions return new trees; the port keeps one copy of each). A client
optimizer is the JAX package's ``(init, apply)`` pair on its trees
(``_client_tree``): ``init(master) -> state``, ``apply(grads, state, master,
step, hyper) -> (master, state)``, the returned master adopted and the
compute params re-cast; an ``apply`` marked ``external_master`` owns the
parameter state, so the engine holds no float32 master (``master_params`` is
a float32 view of the compute params), hands it None and re-casts nothing.
The ``activation_checkpointing`` block configures
``activation_checkpointing/checkpointing.py``.

ZeRO-Offload (``zero_optimization.cpu_offload``, stage 2): the float32 master
and the Adam moments live in the host's memory (``ops/cpu_adam.py``
``DeepSpeedCPUAdam``, filled leaf by leaf from the module's parameters, so no
float32 copy of the model stays on the card); grads stay in the compute
dtype on the card (float32 accumulator across micro-batches). The step
(``_offload_step``, the JAX engine's order): the grads' D2H fetch begins, one
device pass gives the global norm and the fp16 overflow, one host sync reads
them, unscale × predivide × clip fold into the kernel's ``grad_scale``, the
host Adam runs over the pipelined chunks with the per-group hypers and pushes
the compute-dtype params back, then the scaler update; an overflow skips the
host step. Only Adam and AdamW are offloaded; another optimizer or a client
pair raises ``AssertionError`` as in the JAX engine. At dp > 1 each rank
steps its own slices and ``unshard`` rebuilds the compute params.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``,
``checkpoint/checkpointing.py``) are the JAX engine's files, key for key:
``_ckpt_keys`` gives each leaf's on-disk key, ``_ckpt_export`` /
``_ckpt_import`` move the state between this rank's slices and the full
host arrays (the JAX engine's identity layout). The ``resilience`` block
saves every ``save_interval`` steps from ``_finish_step`` through
``resilience/async_ckpt.py`` and, with ``auto_resume``, restores the newest
committed tag at construction.

The fused step (deepspeed_tpu/runtime/engine.py:1473-1583, 1939-2048): with
``fused_step`` (a built-in or client optimizer), and always for an
external-master client pair, at ``gradient_accumulation_steps`` 1 without
ZeRO-Offload or cpu activation checkpointing (else a warning and the
two-step path), the update runs inside ``forward()`` and its state is
adopted there; ``backward()`` marks the window, ``step()`` commits the
bookkeeping, ``zero_grad()`` drops it, and a second ``forward()`` before
``step()`` raises ``RuntimeError`` (strict rotation). The backward runs to
its end inside ``forward()``, then the update body that the two-step path
runs too (``_prep_grads`` / ``_update``): the JAX semantics, with no
memory saving (the JAX step frees each grad leaf as the optimizer consumes
it; here the whole grad tree exists at the update, as in the two-step path).

Telemetry (deepspeed_tpu/runtime/engine.py:469-661, 1912-1920, 2036-2039,
2160-2314): the tensorboard ``SummaryMonitor``, the ``TelemetrySession``
(``utils/telemetry.py``: watched programs, trace window, step scalars), the
metric catalog and alert plane, the cluster monitor (heartbeats and the hang
watchdog, ``utils/cluster.py``) and the run goodput ledger
(``utils/goodput.py``), wired where the JAX engine wires them. The watched
programs are ``forward`` and ``backward`` (the two-step path's halves of
JAX's ``loss_and_grad``), ``apply_update``, ``fused_step``, ``offload_step``
and ``eval_loss``; ``ds_fwd_bwd`` and ``ds_apply_update`` name their regions
(``named_scope``). The step fetches its window losses (and the grad norm)
once, in ``TelemetrySession.fetch_window``, for the ``Train/Samples/*``
scalars and the session both. ``telemetry.anatomy`` prices each step by its
counted flops and bytes at a roofline spec, ``telemetry.profile`` ingests the
trace window, ``telemetry.hbm`` installs ``memory_manifest``'s classes.

Numerics (deepspeed_tpu/runtime/engine.py:546-582, 1328-1400, 2219-2238,
2317-2360): with the ``numerics`` block, ``_prep_grads`` forms the
per-subtree grad sums of squares and nonfinite counts (``utils/numerics.py``;
the norm and the overflow flag are then derived from them, their cross-rank
sums replacing the plain path's), ``_apply_update`` the weight and update
norms where the engine holds a master (keeping the pre-update master for the
update's: this rank's slice, 4 bytes a parameter); the offload step the grad
stats only. They come to the host with the step's one fetch, as does the
desync audit's ``[dp, n_subtrees]`` checksum matrix on its interval (an
all-gather of int64 sums mod 2^32; at world 1 too, where the JAX engine
skips it). The cluster monitor and the goodput ledger ride the numerics
flight recorder. ``memory_manifest`` and ``flops_profile`` as in JAX
(``utils/hbm.py``, ``utils/flops_profiler.py``).

What the slice does not carry raises ``NotImplementedError`` naming its
ROADMAP.md item.
``compilation_cache_dir`` names the JAX compile cache and has no counterpart
in eager PyTorch; it is ignored.
"""

import re
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from ..checkpoint import checkpointing as ckpt
from ..comm import hierarchical as hier
from ..comm.topology import CommGroups, CommTopology, derive_topology
from ..device import resolve_device
from ..ops import adam as adam_opt
from ..ops.cpu_adam import DeepSpeedCPUAdam
from ..ops import lamb as lamb_opt
from ..ops import sgd as sgd_opt
from ..resilience.async_ckpt import AsyncCheckpointer
from ..resilience.auto_resume import auto_resume
from ..utils import log_dist, logger
from ..utils.cluster import named_scope as ds_named_scope
from ..utils.op_record import dtype_name
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer, device_sync
from .activation_checkpointing import checkpointing as act_ckpt
from .config import DeepSpeedConfig
from .constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, COMM_MODE_COMPRESSED,
                        COMM_MODE_FLAT, COMM_OVERLAP_BUCKETED, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, ROUTE_TRAIN, SGD_OPTIMIZER)
from .dataloader import DeepSpeedDataLoader
from .fp16 import loss_scaler as ls
from .lr_schedules import get_scheduler
from .utils import clip_grads_by_global_norm, detect_overflow
from .zero.sharding import (reduce_scatter, shard, sharding_coverage, slice_bounds, unshard,
                            zero_spec)


def _later(what, item):
    return NotImplementedError(f"{what} is not in the PyTorch port yet: ROADMAP.md {item}")


# backward() of a fused step: the grads were consumed inside forward()
_FUSED = object()

_ROTATION = ("fused step: the previous forward()'s update was never committed — call "
             "backward() and step() before the next forward() (strict "
             "forward/backward/step rotation)")


class OptimizerHandle:
    """Host-side view of the optimizer's hyper-parameters (the reference's
    param_groups). Group 0 holds the optimizer block's values; each
    ``group_specs`` entry adds a group that inherits them and applies its
    overrides (lr, weight_decay, betas, eps). Schedulers mutate
    ``param_groups[i]``; ``current_hyper`` hands the values to the update."""

    def __init__(self, name: str, params: dict, group_specs=()):
        self.name = name
        params = params or {}

        def group_dict(overrides: dict) -> dict:
            hyper = adam_opt.hyper_from_params({**params, **overrides})
            return {"lr": hyper["lr"], "betas": (hyper["beta1"], hyper["beta2"]),
                    "eps": hyper["eps"], "weight_decay": hyper["weight_decay"]}

        self.param_groups = [group_dict({})]
        for spec in group_specs or ():
            overrides = {k: v for k, v in dict(spec).items()
                         if k in ("lr", "weight_decay", "betas", "eps")}
            self.param_groups.append(group_dict(overrides))

    def current_hyper(self) -> list:
        """Per-group hyper dicts {lr, beta1, beta2, eps, weight_decay}."""
        return [dict(lr=g["lr"], beta1=g["betas"][0], beta2=g["betas"][1],
                     eps=g["eps"], weight_decay=g["weight_decay"])
                for g in self.param_groups]


def _adam_l2(grads, state, master, step, hyper, groups=None, **_):
    # "Adam" is classic L2 Adam; "AdamW" decoupled (the JAX package's split)
    return adam_opt.apply(grads, state, master, step, hyper, adamw=False, groups=groups)


_OPTIMIZERS = {
    ADAM_OPTIMIZER: (adam_opt.init, _adam_l2),
    ADAMW_OPTIMIZER: (adam_opt.init, adam_opt.apply),
    LAMB_OPTIMIZER: (lamb_opt.init, lamb_opt.apply),
    SGD_OPTIMIZER: (sgd_opt.init, sgd_opt.apply),
}


def make_engine(args=None, model=None, optimizer=None, model_parameters=None,
                training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
                collate_fn=None, config_params=None, device=None):
    """Engine factory (the JAX package's dispatch point for pipeline models)."""
    if any(c.__name__ == "PipelineModule" for c in type(model).__mro__):
        raise _later("a PipelineModule model", "item 16 (pipeline)")
    if dist_init_required is not False:
        from .dist import init_distributed
        init_distributed(resolve_device(device).type)
    return DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                           model_parameters=model_parameters, training_data=training_data,
                           lr_scheduler=lr_scheduler, mpu=mpu,
                           dist_init_required=dist_init_required, collate_fn=collate_fn,
                           config_params=config_params, device=device)


def _accumulate(acc, grads):
    """Add one micro-batch's grads into the accumulator in place, in the
    accumulator's dtype (``a + g.astype(acc_dtype)``)."""
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


class DeepSpeedEngine:

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device=None, param_shardings=None):
        if mpu is not None or param_shardings is not None:
            raise _later("tensor parallelism (mpu / param_shardings)", "item 15")
        if not isinstance(model, nn.Module):
            raise TypeError("model must be a torch.nn.Module whose forward(*batch) "
                            "returns the loss")
        self._client_optimizer = (optimizer if optimizer is not None
                                  and not isinstance(optimizer, str) else None)
        # an apply marked external_master owns the parameter state: no
        # engine-held float32 master (deepspeed_tpu/runtime/engine.py:278-288)
        client_apply = (optimizer[1] if isinstance(optimizer, tuple)
                        and len(optimizer) == 2 else None)
        self._external_master = bool(getattr(client_apply, "external_master", False))
        self.client_lr_scheduler = lr_scheduler
        self.training_data = training_data
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._in_training = True
        self.telemetry = None
        self.monitor = None
        self._cluster = None
        self._goodput = None
        self._programs = {}

        self.dp_size = dist.get_world_size() if dist.is_initialized() else 1
        self.dp_rank = dist.get_rank() if dist.is_initialized() else 0

        config_file = getattr(args, "deepspeed_config", None) if args is not None else None
        if config_params is None and config_file is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or config_params")
        self.config = DeepSpeedConfig(config_params if config_params is not None
                                      else config_file, world_size=self.dp_size)
        # the comm topology, derived for every engine; the mode decides whether
        # the grad exchange runs the two-level schedule
        self._comm_mode = self.config.comm_mode
        self._comm_topo = derive_topology(self.dp_size, self.config.comm_dcn_slices)
        self._refuse_comm()
        self._refuse_unported()
        # 1-bit Adam keeps each rank's grads unreduced: its compressed momentum
        # exchange replaces the gradient mean (reference onebit_adam.py:372)
        self._use_stacked_grads = (self.config.optimizer_name == ONEBIT_ADAM_OPTIMIZER
                                   and (optimizer is None or isinstance(optimizer, str)))
        if self._use_stacked_grads and self.zero_optimization_stage() != 0:
            raise AssertionError("1-bit Adam does not compose with ZeRO (reference parity)")
        offload = bool(self.config.zero_enabled and self.config.zero_config.cpu_offload)
        if offload:
            self._refuse_offload_optimizer(optimizer)
        if (client_apply is not None and self.config.zero_enabled and self.dp_size > 1):
            raise _later("a client (init, apply) optimizer under ZeRO at dp > 1 (the JAX "
                         "engine hands it global trees; the port holds per-rank slices)",
                         "item 24")

        if self.fp16_enabled():
            self.compute_dtype = torch.float16
        elif self.bfloat16_enabled():
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self.device = resolve_device(device)
        model.to(self.device)
        if model_parameters is not None:
            if hasattr(model, "load_parameters"):
                model.load_parameters(model_parameters)
            else:
                model.load_state_dict(model_parameters, strict=True)
        self.module = model

        # ---- master (float32, this rank's ZeRO slices) and compute params ----
        named = list(model.named_parameters())
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._ckpt_key_list = None          # _ckpt_keys, built at first use
        stage = self.zero_optimization_stage()
        self._axes = [zero_spec(tuple(p.shape), self.dp_size) if stage >= 1 else None
                      for p in self._params]
        self._offload = None
        with torch.no_grad():
            if offload:
                # host-tier master: each leaf's slice copied to the host on its own
                zc = self.config.zero_config
                self._offload = DeepSpeedCPUAdam(
                    [shard(p.detach(), a, self.dp_rank, self.dp_size)
                     for p, a in zip(self._params, self._axes)],
                    adamw=(self.config.optimizer_name == ADAMW_OPTIMIZER),
                    pipeline=zc.offload_pipeline, pipeline_depth=zc.offload_pipeline_depth,
                    max_region_elements=zc.offload_max_region_elements,
                    leaf_slices=[slice_bounds(tuple(p.shape), a, self.dp_rank, self.dp_size)
                                 for p, a in zip(self._params, self._axes)])
                self._master = self._offload.params_tree()   # views of the host buffer
            else:
                self._master = (None if self._external_master else
                                [shard(p.detach().float().clone(), a, self.dp_rank,
                                       self.dp_size)
                                 for p, a in zip(self._params, self._axes)])
            model.to(self.compute_dtype)
        # stage 2 keeps the accumulated grads reduce-scattered like the master
        self._grad_axes = self._axes if stage >= 2 else [None] * len(self._params)
        self._zero_sharded_fraction = None
        if stage >= 1 and self.dp_size > 1:
            sharded_b, total_b = sharding_coverage(
                self._axes, [p.detach().float() for p in self._params])
            self._zero_sharded_fraction = sharded_b / max(total_b, 1)
            log_dist(f"ZeRO-{stage}: {sharded_b / 2**20:.1f}/{total_b / 2**20:.1f} MiB "
                     f"({self._zero_sharded_fraction:.1%}) of master+optimizer state "
                     f"sharded over data={self.dp_size}", ranks=[0])

        self._sparse_flags = self._sparse_grad_flags(model)
        # optional hint: the token count of this rank's micro-batch (the JAX
        # engine's hint takes the global batch and divides by dp)
        self._sparse_tokens_fn = getattr(model, "sparse_grad_tokens", None)
        self._pending_tokens = None
        self._comm_groups = None
        self._onebit = None
        self._configure_exchange()
        self._configure_optimizer()

        self._dynamic_scale = self.fp16_enabled() and self.config.loss_scale == 0
        if self.fp16_enabled():
            self.scaler_state = ls.init_state(self.config.loss_scale,
                                              self.config.initial_scale_power,
                                              self.config.hysteresis)
        else:
            self.scaler_state = ls.init_state(1.0)  # scale fixed at 1

        grad_dtype = (self.compute_dtype if stage >= 2 or self._offload is not None
                      else torch.float32)
        if self.config.allreduce_always_fp32:
            grad_dtype = torch.float32
        if self.config.communication_data_type is not None:
            grad_dtype = {"fp32": torch.float32, "fp16": torch.float16,
                          "bf16": torch.bfloat16}[self.config.communication_data_type]
        self._grad_dtype = grad_dtype
        # a window of several micro-batches accumulates in float32: a bf16
        # a + g loses mantissa as the window grows, a scaled fp16 sum overflows
        self._acc_dtype = (torch.float32 if (grad_dtype != torch.float32
                                             and self.gradient_accumulation_steps() > 1)
                           else grad_dtype)
        self._grad_acc = None
        self._pending_loss = None
        self._pending_is_fused = False      # the pending loss is a fused step's
        self._window_losses = []
        self._last_grad_norm = None

        self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        sync = device_sync(self.device)
        self.timers = SynchronizedWallClockTimer(sync)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu() * self.dp_size,
            num_workers=1, steps_per_output=self.steps_per_print(),
            monitor_memory=False, sync_fn=sync)
        # push the block into the process-global module only when this config
        # carries it: a second engine without one must not clobber the first's
        mesh = {"data": self.dp_size, "model": 1}
        if self.config.activation_checkpointing_config.configured_in_json:
            act_ckpt.configure(deepspeed_config=self.config, mesh=mesh)
        else:
            act_ckpt.set_default_mesh(mesh)
        if self.config.dump_state:
            self.config.print("DeepSpeedEngine configuration")
        self._numerics = None
        self._sentinel_index = None
        self._pending_sentinel = None
        self._audit_plan = None
        self._configure_observatories()
        if self.config.numerics_enabled:
            self._configure_numerics()
        self._configure_cluster_goodput()

        self.last_checkpoint_load = None    # load_checkpoint's seconds by stage
        # ---- resilience: periodic async checkpointing and auto-resume
        # (deepspeed_tpu/runtime/engine.py:676-700). All host-side: the save
        # hook in _finish_step snapshots the committed step state and commits
        # on a writer thread
        self._resilience = None
        if self.config.resilience_enabled and self.config.resilience_save_dir:
            self._resilience = AsyncCheckpointer(self, self.config.resilience_save_dir)
            if self.config.resilience_auto_resume:
                _, _, resume_info = auto_resume(self, self.config.resilience_save_dir)
                if self._goodput is not None and resume_info is not None:
                    # restart-replay billing (deepspeed_tpu/runtime/engine.py:
                    # 688-706): the steps between the restore point and the
                    # pre-crash step were paid for once already. The pre-crash
                    # step is the recorder's first bad step (exclusive) or,
                    # after a clean preemption, the dump's last recorded step.
                    stop = resume_info.get("first_bad_step")
                    if stop is not None:
                        stop = int(stop) - 1
                    elif self._numerics is not None:
                        from ..utils.numerics import scan_dump_dir
                        bundle = scan_dump_dir(self._numerics.recorder.dump_dir) or {}
                        stop = (bundle.get("span") or {}).get("last_step")
                    if stop is not None:
                        self._goodput.set_replay_until(int(stop))

        # ---- the fused step (deepspeed_tpu/runtime/engine.py:1183-1205, 1473-1527)
        self._fused = self._fused_eligible()
        self._fused_pending = None          # (overflow, norm, sentinel) of the uncommitted update
        self._warned_fused_cpu_ckpt = False

        # ---- memory observatory (deepspeed_tpu/runtime/engine.py:664-674):
        # the per-class resident bytes into the telemetry session
        if self.telemetry is not None and self.config.telemetry_hbm_enabled:
            from ..utils import hbm as _hbm
            manifest = self.memory_manifest()
            _, class_bytes = _hbm.manifest_signatures(manifest)
            self.telemetry.set_memory_manifest(class_bytes, geometry=manifest.get("geometry"))

    def _refuse_unported(self):
        c = self.config
        if c.zero_enabled and c.zero_optimization_stage >= 3:
            raise _later("ZeRO stage 3", "item 17b")
        if c.sequence_parallel_enabled:
            raise _later("sequence_parallel", "item 14")

    def _refuse_comm(self):
        """The JAX engine's refusals for the two-level and bucketed exchanges
        (deepspeed_tpu/runtime/engine.py:185-235)."""
        c = self.config
        offload = c.zero_enabled and c.zero_config.cpu_offload
        stage = self.zero_optimization_stage()
        mode = self._comm_mode
        if mode != COMM_MODE_FLAT:
            if offload:
                raise ValueError(f"comm.mode={mode!r} does not compose with ZeRO-Offload "
                                 "(the host-tier step owns the grad layout)")
            if stage >= 3:
                raise ValueError(f"comm.mode={mode!r} requires ZeRO stage <= 2: the "
                                 "two-level exchange reduces whole replicated leaves")
            if c.sparse_gradients_enabled:
                raise ValueError(f"comm.mode={mode!r} does not compose with "
                                 "sparse_gradients (the row-sparse reduction owns the "
                                 "grad exchange); pick one")
            if (mode == COMM_MODE_COMPRESSED and self.gradient_accumulation_steps() > 1
                    and c.optimizer_name != ONEBIT_ADAM_OPTIMIZER):
                raise ValueError(
                    "comm.mode='hierarchical_compressed' requires "
                    "gradient_accumulation_steps == 1: error-feedback compression "
                    "of per-micro-batch partial gradients would accumulate "
                    "compression error across the window")
        if c.comm_overlap_mode == COMM_OVERLAP_BUCKETED:
            if offload:
                raise ValueError("comm.overlap.mode='bucketed' does not compose with "
                                 "ZeRO-Offload (the host-tier step owns the grad layout)")
            if stage >= 3:
                raise ValueError("comm.overlap.mode='bucketed' requires ZeRO stage <= 2: "
                                 "the bucketed exchange reduces whole replicated leaves")
            if c.sparse_gradients_enabled:
                raise ValueError("comm.overlap.mode='bucketed' does not compose with "
                                 "sparse_gradients (the row-sparse reduction owns the "
                                 "grad exchange); pick one")

    def _configure_exchange(self):
        """The data-parallel grad exchange, by the JAX engine's precedence
        (deepspeed_tpu/runtime/engine.py:1060-1301): 1-bit Adam's local
        grads (``stacked``), the row-sparse reduction (``sparse``), the
        bucketed overlap (``bucketed``), the two-level schedule
        (``hierarchical``), else the per-leaf mean (``flat``). Under
        ``hierarchical_compressed`` the engine holds the error feedback
        (``_comm_we`` / ``_comm_se``, this rank's rows) and the exchange
        compresses from ``comm.compress_start_step`` on. At one rank only the
        1-bit Adam path differs from ``flat``."""
        c, dp = self.config, self.dp_size
        self._overlap_plan = None
        self._comm_we = self._comm_se = None
        self._compress = False
        overlap_requested = c.comm_overlap_mode == COMM_OVERLAP_BUCKETED
        overlap_active = (overlap_requested and not self._use_stacked_grads
                          and self._sparse_flags is None and dp > 1 and self._offload is None)
        if overlap_requested and not overlap_active and dp > 1:
            logger.warning("[deepspeed_tpu_torch] comm.overlap.mode='bucketed' requested but "
                           "the gradient exchange is owned elsewhere (1-bit Adam's local "
                           "grads or the sparse-gradient reduction); overlap is inert")
        hierarchical = self._comm_mode != COMM_MODE_FLAT
        if self._use_stacked_grads:
            kind = "stacked"
        elif self._sparse_flags is not None and dp > 1:
            kind = "sparse"
        elif overlap_active:
            kind = "bucketed"
        elif hierarchical and dp > 1:
            kind = "hierarchical"
        else:
            kind = "flat"
        self._exchange_kind = kind
        if kind not in ("stacked", "bucketed", "hierarchical"):
            return
        self._jax_order = pytree.tree_leaves(self._sentinel_tree())
        ordered = [self._params[i] for i in self._jax_order]
        topo = self._comm_topo if hierarchical else CommTopology(dp, 1)
        self._comm_groups = CommGroups(topo, self.dp_rank)
        sizes = [int(p.numel()) for p in ordered]
        n_total = sum(sizes)
        self._n_pad = hier.padded_size(n_total, dp)
        if kind == "bucketed":
            bucket_bytes = int(c.comm_overlap_bucket_mb * (1 << 20))
            self._overlap_plan = hier.bucket_plan(ordered, bucket_bytes, dp)
            self._bucket_of = {}
            for k, b in enumerate(self._overlap_plan):
                for j in b["leaf_indices"]:
                    self._bucket_of[self._jax_order[j]] = k
            self._ready = {}
            self._inflight = {}
            self._collecting = False
            for i, p in enumerate(self._params):
                p.register_post_accumulate_grad_hook(self._grad_hook(i))
        self._compress = self._comm_mode == COMM_MODE_COMPRESSED and kind != "stacked"
        if self._compress:
            if kind == "bucketed":
                self._bucket_segs = [hier.leaf_segments(b["sizes"], b["n_pad"])
                                     for b in self._overlap_plan]
                we_shape, se_shape = hier.bucketed_error_state_shapes(self._overlap_plan, topo)
            else:
                self._segs = hier.leaf_segments(sizes, self._n_pad)
                we_shape, se_shape = hier.error_state_shapes(self._n_pad, topo)
            self._comm_we = torch.zeros(we_shape[1], dtype=torch.float32, device=self.device)
            self._comm_se = torch.zeros(se_shape[1], dtype=torch.float32, device=self.device)

    def _sparse_grad_flags(self, model):
        """Per-leaf flags of the row-sparse leaves (deepspeed_tpu/runtime/
        engine.py:305-343): 2-D leaves whose JAX path matches the model's
        ``sparse_grad_paths()``; None when none does or the mode is off."""
        if not self.config.sparse_gradients_enabled or self._use_stacked_grads:
            return None
        patterns = tuple(getattr(model, "sparse_grad_paths", lambda: ())())
        if not patterns:
            logger.warning("sparse_gradients requested but the model defines no "
                           "sparse_grad_paths(); falling back to dense reduction")
            return None
        from .sparse_tensor import match_sparse_paths
        flags = [False] * len(self._params)
        for key, i in self._ckpt_keys():
            flags[i] = self._params[i].dim() == 2 and match_sparse_paths(key, patterns)
        logger.info(f"[deepspeed_tpu_torch] sparse gradients enabled for {sum(flags)} "
                    f"embedding leaves (patterns={patterns})")
        return flags if any(flags) else None

    def _configure_observatories(self):
        """The monitor and the telemetry session with its anatomy spec,
        profile, metrics and alerts, in the JAX engine's order
        (deepspeed_tpu/runtime/engine.py:469-545)."""
        c = self.config
        if c.tensorboard_enabled:
            from ..utils.monitor import SummaryMonitor
            self.monitor = SummaryMonitor(c.tensorboard_output_path or None,
                                          c.tensorboard_job_name)
        if not c.telemetry_enabled:
            return
        from ..utils.telemetry import TelemetrySession
        anatomy_spec = None
        if c.telemetry_anatomy_enabled:
            # the step-anatomy roofline spec, resolved once
            from ..utils.roofline import resolve_spec
            anatomy_spec = resolve_spec(c.telemetry_anatomy_chip, c.telemetry_anatomy_peak_tflops,
                                        c.telemetry_anatomy_hbm_gbps,
                                        c.telemetry_anatomy_ici_gbps,
                                        c.telemetry_anatomy_dcn_gbps)
        # with anatomy on and no explicit MFU peak, price MFU off the same spec
        peak_tflops = c.telemetry_peak_tflops or (anatomy_spec.peak_tflops
                                                  if anatomy_spec else 0.0)
        self.telemetry = TelemetrySession(
            monitor=self.monitor, peak_tflops=peak_tflops or None,
            trace_dir=c.telemetry_trace_dir or None,
            trace_steps=c.telemetry_trace_steps, mfu_window=c.telemetry_mfu_window,
            recompile_warn=c.telemetry_recompile_warn,
            output_path=c.telemetry_output_path or None,
            job_name=c.telemetry_job_name, device=self.device, anatomy_spec=anatomy_spec)
        if c.telemetry_profile_enabled:
            self.telemetry.configure_profile(
                True, reconcile_tolerance=c.telemetry_profile_reconcile_tolerance,
                emit_scalars=c.telemetry_profile_emit_scalars)
        if c.telemetry_metrics_enabled or c.telemetry_alerts_enabled:
            self.telemetry.configure_metrics(
                ring_len=c.telemetry_metrics_ring_len,
                strict=c.telemetry_metrics_strict_catalog,
                export_path=c.telemetry_metrics_export_path or None)
        if c.telemetry_alerts_enabled:
            self.telemetry.configure_alerts(rules=c.telemetry_alerts_rules)

    def _configure_numerics(self):
        """The numerics observatory (deepspeed_tpu/runtime/engine.py:546-582):
        the subtree index over the JAX tree paths, the loss-scale journal
        (fp16), the flight recorder and the monitor; page alerts dump
        through its recorder."""
        c = self.config
        from ..utils.numerics import FlightRecorder, NumericsMonitor, build_subtree_index
        self._sentinel_index = build_subtree_index(self._sentinel_tree(),
                                                   c.numerics_subtree_depth, positions=True)
        # the index's device tensors and, at dp > 1, the masks of the sharded
        # leaves: made here, so that no step copies them to the device
        self._sentinel_index.members(self.device)
        self._shard_masks = {}
        if self.dp_size > 1:
            for axes in (self._grad_axes, self._axes):
                if any(a is not None for a in axes):
                    self._shard_masks[id(axes)] = torch.tensor(
                        [a is not None for a in axes], device=self.device)
        journal = None
        if self.fp16_enabled():
            # host shadow of the scaler, seeded from the config
            init_scale = (float(c.loss_scale) if c.loss_scale and c.loss_scale > 0
                          else float(2 ** c.initial_scale_power))
            journal = ls.LossScaleJournal(self._dynamic_scale, init_scale,
                                          scale_window=c.loss_scale_window,
                                          min_scale=c.min_loss_scale, hysteresis=c.hysteresis)
        recorder = FlightRecorder(capacity=c.numerics_ring_size,
                                  dump_dir=c.numerics_dump_dir or "numerics_dumps",
                                  telemetry=self.telemetry, host_id=self.dp_rank)
        recorder.install(c.numerics_install_signal_handlers)
        self._numerics = NumericsMonitor(
            self._sentinel_index, monitor=self.monitor, telemetry=self.telemetry,
            journal=journal, recorder=recorder, audit_interval=c.numerics_audit_interval,
            consecutive_skip_trigger=c.numerics_consecutive_skip_trigger,
            trigger_on_nonfinite_loss=c.numerics_trigger_on_nonfinite_loss)
        if self.telemetry is not None and self.telemetry.alert_engine is not None:
            self.telemetry.alert_engine.recorder = recorder

    def _configure_cluster_goodput(self):
        """The cluster monitor and the goodput ledger
        (deepspeed_tpu/runtime/engine.py:590-661), riding the numerics
        recorder when there is one."""
        c = self.config
        if self.telemetry is None:
            return
        num_recorder = self._numerics.recorder if self._numerics is not None else None
        if c.telemetry_cluster_enabled:
            from ..utils.cluster import ClusterMonitor
            recorder, cluster_dump_dir = num_recorder, None
            if recorder is None:
                # no numerics recorder to ride: the watchdog gets its own
                from ..utils.numerics import FlightRecorder
                cluster_dump_dir = c.telemetry_cluster_dump_dir or "cluster_dumps"
                recorder = FlightRecorder(capacity=64, dump_dir=cluster_dump_dir,
                                          telemetry=self.telemetry, host_id=self.dp_rank)
            self._cluster = ClusterMonitor(
                telemetry=self.telemetry, recorder=recorder,
                heartbeat_interval=c.telemetry_cluster_heartbeat_interval,
                hang_deadline_s=c.telemetry_cluster_hang_deadline_s,
                straggler_threshold=c.telemetry_cluster_straggler_threshold,
                signal_peers=c.telemetry_cluster_signal_peers,
                warmup_steps=c.telemetry_cluster_warmup_steps,
                dump_dir=cluster_dump_dir)
            recorder.cluster = self._cluster
            if self.telemetry.alert_engine is not None \
                    and self.telemetry.alert_engine.recorder is None:
                # page alerts dump through the cluster watchdog's recorder
                self.telemetry.alert_engine.recorder = recorder
        if c.telemetry_goodput_enabled:
            from ..utils.goodput import RunLedger
            gp_recorder = num_recorder
            if gp_recorder is None and self._cluster is not None:
                gp_recorder = self._cluster.recorder
            ledger_dir = (c.telemetry_goodput_ledger_dir
                          or (gp_recorder.dump_dir if gp_recorder is not None else None)
                          or "goodput_ledgers")
            if gp_recorder is not None:
                run_id = gp_recorder.run_id
            else:
                from ..utils.numerics import default_run_id
                run_id = default_run_id()
            self._goodput = RunLedger(run_id=run_id, host=self.dp_rank,
                                      ledger_dir=ledger_dir,
                                      eval_tag=c.telemetry_goodput_eval_tag)
            # carve-out baselines: compile seconds, watchdog fires and
            # checkpoint saves are cumulative; the ledger bills per-step deltas
            self._goodput_compile_base = 0.0
            self._goodput_hang_base = 0
            self._goodput_saves_base = 0
            self._goodput_init_open = True
            if self._cluster is not None:
                self._cluster.goodput = self._goodput

    def _program(self, name, fn):
        """``fn`` through the telemetry compile watchdog (itself when
        telemetry is off)."""
        if self.telemetry is None:
            return fn
        prog = self._programs.get(name)
        if prog is None:
            prog = self._programs[name] = self.telemetry.watch(name, fn)
        return prog

    def _refuse_offload_optimizer(self, optimizer):
        """The JAX engine's asserts (deepspeed_tpu/runtime/engine.py:861-865),
        raised so that python -O keeps them."""
        name = self.config.optimizer_name or ADAM_OPTIMIZER
        if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            raise AssertionError(f"ZeRO-Offload supports Adam/AdamW (got {name!r})")
        if optimizer is not None and not isinstance(optimizer, str):
            raise AssertionError("ZeRO-Offload steps the host-side DeepSpeedCPUAdam; "
                                 "client optimizers unsupported")

    # ------------------------------------------------------------------ state views
    @property
    def master_params(self):
        """name -> this rank's float32 master (its ZeRO slice of the leaf); under
        ZeRO-Offload views of the host buffer; under an external-master client
        optimizer a float32 view of the compute params, made on access."""
        if self._external_master:
            return {n: p.detach().float() for n, p in zip(self._names, self._params)}
        return dict(zip(self._names, self._master))

    def offload_step_timing(self):
        """The last ZeRO-Offload step's lanes (``DeepSpeedCPUAdam.step_regions``),
        or None before it or without offload."""
        return self._offload.last_step_timing if self._offload is not None else None

    # ------------------------------------------------------------------ config accessors
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def zero_optimization(self):
        return self.config.zero_enabled

    def zero_optimization_stage(self):
        return self.config.zero_optimization_stage

    def fp16_enabled(self):
        return self.config.fp16_enabled

    def bfloat16_enabled(self):
        return self.config.bf16_enabled

    def gradient_clipping(self):
        return self.config.gradient_clipping

    def allreduce_always_fp32(self):
        return self.config.allreduce_always_fp32

    def wall_clock_breakdown(self):
        # with telemetry on, the barrier-per-section timers would perturb the
        # run being measured: only behind telemetry.perturbing_breakdown
        if self.telemetry is not None:
            if self.config.telemetry_perturbing_breakdown:
                self.telemetry.warn_perturbing_once()
                return True
            if self.config.wall_clock_breakdown:
                self.telemetry.note_breakdown_suppressed_once()
            return False
        return self.config.wall_clock_breakdown

    def dynamic_loss_scale(self):
        return self._dynamic_scale

    def loss_scale(self):
        return float(self.scaler_state.cur_scale)

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def get_mom(self):
        return [g["betas"] for g in self.optimizer.param_groups]

    # ------------------------------------------------------------------ setup
    def _group_ids(self, specs):
        """Per-leaf group ids from pattern specs: a leaf whose path (the JAX
        package's "blocks/0/attn/c_attn_w" form) matches ``specs[i]['pattern']``
        (first match wins) is in group i + 1, any other in group 0."""
        compiled = [re.compile(s["pattern"]) for s in specs]
        ids, counts = [], [0] * (len(specs) + 1)
        for name in self._names:
            path = name.replace(".", "/")
            gi = next((i + 1 for i, rx in enumerate(compiled) if rx.search(path)), 0)
            ids.append(gi)
            counts[gi] += 1
        log_dist(f"optimizer param groups: {counts[0]} base leaves + "
                 f"{counts[1:]} per pattern group", ranks=[0])
        return ids

    def _configure_optimizer(self):
        specs = (self.config.optimizer_params or {}).get("param_groups")
        if not specs:
            hook = getattr(self.module, "param_group_patterns", None)
            specs = tuple(hook()) if callable(hook) else ()
        specs = tuple(specs or ())
        if self._client_optimizer is not None:
            self._configure_client_optimizer(specs)
            return
        self._groups = self._group_ids(specs) if specs else None
        name = self.config.optimizer_name or ADAM_OPTIMIZER
        if name == ONEBIT_ADAM_OPTIMIZER:
            self._configure_onebit(specs)
            return
        if name not in _OPTIMIZERS:
            raise ValueError(f"Unrecognized optimizer {name!r}")
        self.optimizer = OptimizerHandle(name, self.config.optimizer_params or {},
                                         group_specs=specs)
        if self._offload is not None:
            # the host tier steps DeepSpeedCPUAdam; the state views read its buffers
            self._opt_init = self._opt_apply = None
            self.opt_state = adam_opt.AdamState(
                exp_avg=self._offload.exp_avg_tree(),
                exp_avg_sq=self._offload.exp_avg_sq_tree())
            log_dist(f"Using ZeRO-Offload: host-tier DeepSpeedCPUAdam ({name}, "
                     f"{self._offload.numel} local master elements)", ranks=[0])
            return
        self._opt_init, self._opt_apply = _OPTIMIZERS[name]
        self.opt_state = self._opt_init(self._master)
        log_dist(f"Using DeepSpeed Optimizer param name {self.optimizer.name}", ranks=[0])

    def _configure_onebit(self, specs):
        """1-bit Adam (deepspeed_tpu/runtime/engine.py:894-906): one group,
        ``freeze_step`` from the optimizer block, its momentum exchange over
        the engine's comm groups (two-level under a hierarchical
        ``comm.mode``), the flat vector in the JAX leaf order."""
        from ..ops.onebit_adam import OneBitAdam
        if specs:
            raise AssertionError("1-bit Adam runs a single param group (compressed "
                                 "error feedback is not per-group)")
        params = self.config.optimizer_params or {}
        self._onebit = OneBitAdam(freeze_step=params.get("freeze_step", 100000),
                                  dp_size=self.dp_size, groups=self._comm_groups,
                                  order=self._jax_order)
        self._opt_init, self._opt_apply = self._onebit.init, self._onebit.apply
        self.optimizer = OptimizerHandle(ONEBIT_ADAM_OPTIMIZER, params)
        self.opt_state = self._opt_init(self._master)
        log_dist(f"Using 1-bit Adam (freeze_step {self._onebit.freeze_step}, "
                 f"{self.opt_state.exp_avg.numel()} padded elements)", ranks=[0])

    def _configure_client_optimizer(self, specs):
        """A client ``(init, apply)`` pair, with the JAX engine's refusals
        (deepspeed_tpu/runtime/engine.py:872-890)."""
        opt = self._client_optimizer
        if not (isinstance(opt, tuple) and len(opt) == 2):
            raise TypeError("client optimizer must be an (init_fn, apply_fn) pair; "
                            "torch optimizers are not supported")
        # the JAX engine's asserts, raised so that python -O keeps them
        if specs:
            raise AssertionError("param_groups require a built-in optimizer; a client "
                                 "(init, apply) pair has no groups kwarg contract")
        if self.config.zero_enabled:
            if not self.config.zero_allow_untested_optimizer:
                raise AssertionError(
                    'You are using an untested ZeRO Optimizer. Please add '
                    '<"zero_allow_untested_optimizer": true> in the configuration '
                    'file to use it.')
            log_dist("**** You are using ZeRO with an untested optimizer, "
                     "proceed with caution *****", ranks=[0])
        self._groups = None
        self._opt_init, self._opt_apply = opt
        self.optimizer = OptimizerHandle("client", self.config.optimizer_params or {})
        self._layout = self._client_layout()
        with torch.no_grad():
            # external master: init sees the params' float32 upcast, dropped after
            master = (self._master if not self._external_master
                      else [p.detach().float() for p in self._params])
            self.opt_state = self._opt_init(self._client_tree(master))
        log_dist(f"Using client optimizer (external_master={self._external_master})",
                 ranks=[0])

    def _client_layout(self):
        """The tree a client pair sees, its leaves indices into the engine's
        leaf list: the module's ``params_tree()`` layout where it has one (the
        JAX package's nested dicts), else the name -> tensor dict. Dict keys
        are sorted, so torch's pytree walks the leaves in ``jax.tree_util``'s
        order (``bench.py``'s ``shard_of`` concatenates in that order)."""
        index = {id(p): i for i, p in enumerate(self._params)}
        hook = getattr(self.module, "params_tree", None)
        tree = hook() if callable(hook) else dict(zip(self._names, self._params))

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [build(n) for n in node]
            return index[id(node)]

        layout = build(tree)
        if sorted(pytree.tree_leaves(layout)) != list(range(len(self._params))):
            raise ValueError("params_tree() must hold every parameter once")
        return layout

    def _client_tree(self, values):
        return pytree.tree_map(lambda i: values[i], self._layout)

    def _client_leaves(self, tree):
        """The engine-ordered leaf list of a tree in the client layout."""
        out = [None] * len(self._params)
        for i, leaf in zip(pytree.tree_leaves(self._layout), pytree.tree_leaves(tree)):
            out[i] = leaf
        return out

    def _sentinel_tree(self):
        """The tree whose paths name the sentinel's subtrees, its leaves the
        engine's leaf positions: the module's ``params_tree()`` with sorted
        keys (the JAX paths), else the parameter names split on "."."""
        if callable(getattr(self.module, "params_tree", None)):
            return self._client_layout()
        tree = {}
        for i, name in enumerate(self._names):
            node = tree
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = i

        def order(node):
            return ({k: order(node[k]) for k in sorted(node)} if isinstance(node, dict)
                    else node)
        return order(tree)

    def _client_step(self, grads, step):
        """``apply(grads, state, master, step, hyper)``: hyper the JAX
        engine's dict of 0-d float32 scalars, step a 0-d int32."""
        g = self.optimizer.param_groups[0]
        hyper = {k: torch.tensor(v, dtype=torch.float32, device=self.device)
                 for k, v in (("lr", g["lr"]), ("beta1", g["betas"][0]),
                              ("beta2", g["betas"][1]), ("eps", g["eps"]),
                              ("weight_decay", g["weight_decay"]))}
        step = torch.tensor(step, dtype=torch.int32, device=self.device)
        grads = self._client_tree(grads)
        if self._external_master:
            _, self.opt_state = self._opt_apply(grads, self.opt_state, None, step, hyper)
            return
        master, self.opt_state = self._opt_apply(grads, self.opt_state,
                                                 self._client_tree(self._master), step, hyper)
        for m, new in zip(self._master, self._client_leaves(master)):
            if new is not m:
                m.copy_(new)

    def _configure_lr_scheduler(self, client_lr_scheduler):
        if client_lr_scheduler is not None:
            self.lr_scheduler = client_lr_scheduler
        elif self.config.scheduler_name is not None:
            self.lr_scheduler = get_scheduler(self.config.scheduler_name, self.optimizer,
                                              self.config.scheduler_params or {})
            log_dist(f"DeepSpeed using configured LR scheduler = "
                     f"{self.config.scheduler_name}", ranks=[0])
        else:
            self.lr_scheduler = None

    def deepspeed_io(self, dataset, batch_size=None, route=ROUTE_TRAIN, data_sampler=None,
                     collate_fn=None, num_local_io_workers=None):
        """A loader of this rank's micro-batches (``batch_size`` rows each,
        default ``train_micro_batch_size_per_gpu``)."""
        return DeepSpeedDataLoader(dataset,
                                   batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
                                   collate_fn=collate_fn or self.collate_fn,
                                   data_parallel_world_size=self.dp_size,
                                   data_parallel_rank=self.dp_rank)

    # ------------------------------------------------------------------ train API
    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return x

    def train(self, mode=True):
        self._in_training = mode

    def eval(self):
        self._in_training = False

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def forward(self, *inputs):
        """The loss of this micro-batch. In training mode autograd records it
        for ``backward``; under the fused step the update runs here and the
        detached loss is returned. In eval mode it runs under
        ``torch.no_grad``."""
        if (self.telemetry is not None and self._in_training
                and self.micro_steps % self.gradient_accumulation_steps() == 0):
            # first micro-step of an optimizer-step window
            self.telemetry.on_step_begin(self.global_steps)
            if self._cluster is not None:
                self._cluster.on_step_begin(self.global_steps)
            self._goodput_close_init()
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").start()
        batch = tuple(self._to_device(x) for x in inputs)
        if self._in_training and self._exchange_kind == "sparse":
            self._pending_tokens = self._local_tokens(batch)
        if self._in_training and self._use_fused():
            loss = self._program("fused_step", self._fused_forward)(*batch)
        elif self._in_training:
            loss = self._program("forward", self._fwd)(*batch)
            self._pending_loss = loss
        else:
            self._goodput_begin_eval()
            with torch.no_grad():
                loss = self._program("eval_loss", self._fwd)(*batch)
            self._goodput_end_eval()
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").stop()
        return loss

    def _loss(self, batch):
        loss = self.module(*batch)
        return loss[0] if isinstance(loss, (tuple, list)) else loss

    def _fwd(self, *batch):
        with ds_named_scope("ds_fwd_bwd"):
            return self._loss(batch)

    def backward(self, loss, allreduce_gradients=True, release_loss=False):
        """Differentiate ``loss * scale / gradient_accumulation_steps`` and move
        this micro-batch's grads (reduced over the ranks) into the
        accumulator; under the fused step only mark the window, whose grads
        ``forward()`` consumed. ``allreduce_gradients`` and ``release_loss``
        are accepted for the reference's signature; the grads are always
        reduced."""
        if not self._in_training or self._pending_loss is None:
            raise RuntimeError("backward() called without a preceding forward() in "
                               "training mode")
        if self.wall_clock_breakdown():
            self.timers("backward_microstep").start()
        if self._pending_is_fused:
            # deepspeed_tpu/runtime/engine.py:1982-1990 (a zero_grad() since the
            # forward dropped the window's bookkeeping)
            self._pending_is_fused = False
            self._grad_acc = _FUSED if self._fused_pending is not None else None
        else:
            grads = self._program("backward", self._micro_grads)(self._pending_loss)
            if self._grad_acc is None:
                self._grad_acc = [g.to(self._acc_dtype) for g in grads]
            else:
                _accumulate(self._grad_acc, grads)
        self._window_losses.append(self._pending_loss.detach())
        self._pending_loss = None
        self.micro_steps += 1
        if self.wall_clock_breakdown():
            self.timers("backward_microstep").stop()
        return loss

    def _scaled(self, loss):
        factor = np.float32(self.scaler_state.cur_scale) / np.float32(
            self.gradient_accumulation_steps())
        if self.config.prescale_gradients:
            factor = factor / np.float32(self.config.gradient_predivide_factor or 1.0)
        return loss * float(factor)

    def _micro_grads(self, loss, compress=None):
        """This micro-batch's grads, every leaf in ``grad_dtype`` (zeros for
        a leaf the loss does not reach), through the data-parallel exchange
        (``_exchange``). Under the bucketed overlap a bucket's exchange
        begins inside the backward, once its last leaf's grad is there."""
        if compress is None:
            compress = self._compress_now()
        overlap = self._exchange_kind == "bucketed" and not compress
        if overlap:
            self._missing = [len(b["leaf_indices"]) for b in self._overlap_plan]
            self._collecting = True
        try:
            with ds_named_scope("ds_fwd_bwd"):
                self._scaled(loss).backward()
        finally:
            if overlap:
                self._collecting = False
        grads = []
        for p in self._params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads.append(g.to(self._grad_dtype))
        if self.dp_size > 1:
            grads = self._exchange(grads, compress)
        return grads

    def _local_tokens(self, batch):
        """The token count of this rank's micro-batch, which bounds the
        nonzero rows of an embedding grad: the model's ``sparse_grad_tokens``
        hint, else batch arg 0 when it holds integer token ids, else None
        (then the dense reduction: a guessed capacity could drop rows)."""
        if self._sparse_tokens_fn is not None:
            return int(self._sparse_tokens_fn(*batch))
        if batch and isinstance(batch[0], torch.Tensor) and not batch[0].is_floating_point():
            return int(batch[0].numel())
        return None

    def _compress_now(self) -> bool:
        """Whether this step's exchange is the compressed one
        (``hierarchical_compressed`` from ``comm.compress_start_step``)."""
        return self._compress and self.global_steps >= self.config.comm_compress_start_step

    def _exchange(self, grads, compress):
        """The mean over the ranks of this rank's grads, by the exchange
        ``_configure_exchange`` chose; a stage-2 sharded leaf then keeps this
        rank's slice. 1-bit Adam's grads stay local."""
        kind = self._exchange_kind
        if kind == "stacked":
            return grads
        if kind == "flat":
            return [self._reduce(g, a) for g, a in zip(grads, self._grad_axes)]
        if kind == "sparse":
            out = self._sparse_reduce(grads)
        elif compress:
            out = self._compressed_mean(grads)
        elif kind == "bucketed":
            out = self._bucketed_mean(grads)
        else:
            out = self._hierarchical_mean(grads)
        return [shard(g, a, self.dp_rank, self.dp_size) for g, a in zip(out, self._grad_axes)]

    def _from_ordered(self, ordered):
        out = [None] * len(self._params)
        for j, i in enumerate(self._jax_order):
            out[i] = ordered[j]
        return out

    def _hierarchical_mean(self, grads):
        """The two-level mean of the whole grad vector (JAX leaf order,
        padded), in ``grad_dtype`` (deepspeed_tpu/runtime/engine.py:1154-1180)."""
        vec, recipe = hier.flatten_tree([grads[i] for i in self._jax_order])
        vec = torch.nn.functional.pad(vec, (0, self._n_pad - vec.numel()))
        mean = hier.two_level_sum(vec, self._comm_groups) / self.dp_size
        return self._from_ordered(hier.unflatten_tree(mean.to(self._grad_dtype), recipe))

    def _compressed_mean(self, grads):
        """The compressed exchange (deepspeed_tpu/runtime/engine.py:1221-1301)
        in float32 whatever ``grad_dtype`` is (the signs and scales are the
        wire format), the engine's error feedback updated in place; per
        bucket under the overlap."""
        ordered = [grads[i] for i in self._jax_order]
        if self._overlap_plan is not None:
            out, we, se = hier.bucketed_two_level_compressed(
                ordered, self._comm_we, self._comm_se, self._overlap_plan,
                self._comm_groups, self._bucket_segs)
        else:
            vec, recipe = hier.flatten_tree(ordered)
            vec = torch.nn.functional.pad(vec.float(), (0, self._n_pad - vec.numel()))
            mean, we, se = hier.two_level_compressed(vec, self._comm_we, self._comm_se,
                                                     self._comm_groups, self._segs)
            out = hier.unflatten_tree(mean.to(self._grad_dtype), recipe)
        self._comm_we.copy_(we)
        self._comm_se.copy_(se)
        return self._from_ordered(out)

    def _grad_hook(self, i):
        """Leaf ``i``'s post-accumulate hook under the bucketed overlap: keep
        its grad and, when it completes its bucket, begin that bucket's
        exchange (``hier.two_level_start``, asynchronous)."""
        import weakref
        ref = weakref.ref(self)

        def hook(p):
            eng = ref()
            if eng is None or not eng._collecting:
                return
            eng._ready[i] = p.grad.to(eng._grad_dtype)
            k = eng._bucket_of[i]
            eng._missing[k] -= 1
            if eng._missing[k] == 0:
                eng._issue_bucket(k, eng._ready)
        return hook

    def _issue_bucket(self, k, source):
        bucket = self._overlap_plan[k]
        leaves = {j: source[self._jax_order[j]] for j in bucket["leaf_indices"]}
        with ds_named_scope(f"{hier.GRAD_BUCKET_SCOPE}{k}"):
            self._inflight[k] = hier.two_level_start(hier.bucket_vec(leaves, bucket),
                                                     self._comm_groups)

    def _bucketed_mean(self, grads):
        """Wait on every bucket's exchange in plan order (issuing those no
        hook issued: a bucket with a leaf the loss does not reach), finish
        it and unpack the means (deepspeed_tpu/comm/hierarchical.py
        ``bucketed_two_level_mean``)."""
        ordered = [grads[i] for i in self._jax_order]
        out = [None] * len(ordered)
        for k, bucket in enumerate(self._overlap_plan):
            if k not in self._inflight:
                self._issue_bucket(k, grads)
            work, buf = self._inflight.pop(k)
            with ds_named_scope(f"{hier.GRAD_BUCKET_SCOPE}{k}"):
                mean = hier.two_level_finish(work, buf, self._comm_groups) / self.dp_size
            hier.bucket_unpack(mean, bucket, ordered, out)
        self._ready.clear()
        return self._from_ordered(out)

    def _sparse_reduce(self, grads):
        """Row-sparse leaves by all-gathering (indices, values) when the
        table is sparse this step, the rest by the mean
        (deepspeed_tpu/runtime/engine.py:1084-1127)."""
        from .sparse_tensor import row_sparse_allreduce
        tokens = self._pending_tokens
        out = []
        for g, sparse in zip(grads, self._sparse_flags):
            sparse = sparse and tokens is not None
            cap = min(tokens, g.shape[0]) if sparse else 0
            # the gather ships dp * cap rows: only when the table is sparse
            if sparse and cap * self.dp_size < g.shape[0]:
                out.append(row_sparse_allreduce(g, cap))
            else:
                dist.all_reduce(g, op=dist.ReduceOp.SUM)
                out.append(g.div_(self.dp_size))
        return out

    def _reduce(self, g, axis):
        """The mean over the ranks: reduce-scattered to this rank's slice for
        a stage-2 sharded leaf, all-reduced otherwise."""
        if axis is not None:
            g = reduce_scatter(g, axis, self.dp_size)
        else:
            dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g.div_(self.dp_size)

    # ------------------------------------------------------------------ fused step
    def _cpu_checkpointing_active(self) -> bool:
        """deepspeed_tpu/runtime/engine.py:1850-1860: an engine with an
        ``activation_checkpointing`` block decides from its own config, one
        without from the process-global module."""
        ac = self.config.activation_checkpointing_config
        if ac.configured_in_json:
            return bool(ac.cpu_checkpointing)
        return act_ckpt.cpu_checkpointing_enabled()

    def _fused_eligible(self) -> bool:
        """The JAX engine's rule: ``fused_step`` needs gas 1, the plain or the
        uncompressed bucketed exchange, no ZeRO-Offload and no cpu activation
        checkpointing (else it warns and takes the two-step path); an
        external-master pair at gas 1 is always fused."""
        gas1 = self.gradient_accumulation_steps() == 1
        exchange_ok = (self._exchange_kind == "flat"
                       or (self._exchange_kind == "bucketed" and not self._compress))
        if self.config.fused_step and not (gas1 and exchange_ok and self._offload is None
                                           and not self._cpu_checkpointing_active()):
            logger.warning(
                "[deepspeed_tpu_torch] fused_step requested but ineligible (it needs "
                "gradient_accumulation_steps == 1, the plain local grad path or the "
                "bucketed overlap exchange — no 1-bit Adam local grads, sparse-gradient "
                "reduction, non-overlapped hierarchical comm or compressed comm — no "
                "ZeRO-Offload and no cpu activation checkpointing); using the two-step "
                "path")
            return False
        if self._external_master:
            return gas1 and exchange_ok
        return bool(self.config.fused_step)

    def _use_fused(self) -> bool:
        """The fused step, unless cpu activation checkpointing was switched on
        after construction (deepspeed_tpu/runtime/engine.py:1927-1938): then
        a warning, once, and the two-step path."""
        fused = self._fused
        if fused and self._cpu_checkpointing_active():
            if not self._warned_fused_cpu_ckpt:
                self._warned_fused_cpu_ckpt = True
                logger.warning("[deepspeed_tpu_torch] fused_step disabled: cpu activation "
                               "checkpointing was enabled after engine construction; "
                               "using the two-step path")
            fused = False
        return fused

    def _fused_forward(self, *batch):
        """deepspeed_tpu/runtime/engine.py:1939-1951: the whole step at
        ``forward()``, with ``current_hyper()`` of this moment and step
        number ``global_steps + 1 - skipped_steps``."""
        if self._fused_pending is not None:
            raise RuntimeError(_ROTATION)
        loss = self._fwd(*batch)
        self._fused_pending = self._update(self._micro_grads(loss))
        loss = loss.detach()
        self._pending_loss, self._pending_is_fused = loss, True
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def zero_grad(self):
        """Drop the accumulated grads. Mid-window of a fused step the update
        has been applied already; only its bookkeeping is dropped."""
        self._grad_acc = None
        self._fused_pending = None

    def step(self):
        """Apply the optimizer at the gradient-accumulation boundary; under the
        fused step commit the bookkeeping of the update ``forward()`` ran."""
        if self.is_gradient_accumulation_boundary() and self._grad_acc is not None:
            self._take_model_step()

    def _grad_norm(self, grads):
        """Global L2 norm: squares of sharded grads summed over the ranks,
        replicated ones counted once (an axis is set only when dp > 1)."""
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        whole = [s for s, a in zip(sq, self._grad_axes) if a is None]
        sharded = [s for s, a in zip(sq, self._grad_axes) if a is not None]
        if whole:
            total = total + torch.stack(whole).sum()
        if sharded:
            part = torch.stack(sharded).sum()
            dist.all_reduce(part, op=dist.ReduceOp.SUM)
            total = total + part
        return torch.sqrt(total)

    def _leaf_sumsq(self, i, t):
        """A master leaf's squared norm, summed over the ranks when sharded."""
        s = torch.sum(torch.square(t))
        if self._axes[i] is not None:
            dist.all_reduce(s, op=dist.ReduceOp.SUM)
        return s

    def _sum_sharded(self, per_leaf, axes):
        """A per-leaf vector with the entries of the leaves ``axes`` shards
        summed over the ranks (their slices' parts); the others, whole on
        every rank, kept. The masks are built with the sentinel, so no step
        copies one to the device."""
        mask = self._shard_masks.get(id(axes))
        if mask is None:
            return per_leaf
        part = torch.where(mask, per_leaf, torch.zeros_like(per_leaf))
        dist.all_reduce(part, op=dist.ReduceOp.SUM)
        return torch.where(mask, part, per_leaf)

    def _prep_grads(self, grads):
        """deepspeed_tpu/runtime/engine.py:1328-1369 ``prep_grads``: the fp16
        overflow check and unscale, the predivide, the global norm, the clip.
        With the numerics sentinel, also the per-subtree grad sums of squares
        and nonfinite counts, from which the overflow flag and the norm are
        then derived (one pass over the tree, and the collectives replaced,
        not added). Returns (grads, overflow, norm, sentinel or None)."""
        fp16 = self.fp16_enabled()
        index = self._sentinel_index
        nonfinite = None
        if index is not None:
            from ..utils.numerics import bucket_nonfinite, leaf_nonfinite
            counts = self._sum_sharded(leaf_nonfinite(grads), self._grad_axes)
            if self._use_stacked_grads and self.dp_size > 1:
                dist.all_reduce(counts, op=dist.ReduceOp.SUM)    # every rank's grads
            nonfinite = bucket_nonfinite(None, index, per_leaf=counts)
            overflow = nonfinite.sum() > 0
        else:
            overflow, _ = detect_overflow(grads, fp16)
        if fp16:
            flag = overflow.to(self.device, torch.float32)
            if self.dp_size > 1 and index is None:
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            overflow = bool(flag)
            scale = self.scaler_state.cur_scale
            inv = 1.0 / scale if scale > 0 else 1.0
            # bf16 and f32 unscale in place by a power of two; fp16 through
            # float32, whose exponent keeps the small unscaled grads
            grads = [g.float() * inv if g.dtype == torch.float16
                     else g.mul_(torch.tensor(inv, dtype=g.dtype)) for g in grads]
        else:
            overflow = False
        predivide = float(self.config.gradient_predivide_factor or 1.0)
        if self.config.prescale_gradients and predivide != 1.0:
            grads = [g.mul_(torch.tensor(predivide, dtype=g.dtype)) for g in grads]
        norm_grads = grads
        if self._use_stacked_grads and self.dp_size > 1:
            # 1-bit Adam's local grads: the logical gradient is their mean over
            # the ranks; norm (and clip) on that, not on one rank's
            norm_grads = []
            for g in grads:
                t = g.clone()
                dist.all_reduce(t, op=dist.ReduceOp.SUM)
                norm_grads.append(t.div_(self.dp_size))
        sent = None
        if index is not None:
            from ..utils.numerics import bucket_sumsq, leaf_sumsq
            gss = bucket_sumsq(None, index, per_leaf=self._sum_sharded(leaf_sumsq(norm_grads),
                                                                        self._grad_axes))
            norm = torch.sqrt(gss.sum())
            sent = {"grad_sumsq": gss, "grad_nonfinite": nonfinite}
        else:
            norm = self._grad_norm(norm_grads)
        del norm_grads
        clip = float(self.gradient_clipping() or 0.0)
        if clip > 0:
            clip_grads_by_global_norm(grads, clip, norm=norm)
        return grads, overflow, norm, sent

    @torch.no_grad()
    def _update(self, grads):
        """deepspeed_tpu/runtime/engine.py:1371-1400 ``apply_update``, the one
        body of the two-step path and the fused step: prep, the optimizer on
        this rank's slices and the master -> compute re-cast (skipped on
        overflow), the scaler update. Returns (overflow, norm, sentinel)."""
        with ds_named_scope("ds_apply_update"):
            return self._apply_update(grads)

    def _apply_update(self, grads):
        grads, overflow, norm, sent = self._prep_grads(grads)
        # the sentinel's weight and update norms need an engine-held master;
        # the update's needs the pre-update master, copied for it (4 bytes a
        # parameter of this rank's slice: the sentinel's one memory cost)
        track = sent is not None and self._master is not None
        old = [m.clone() for m in self._master] if track and not overflow else None
        if not overflow:
            # stage 1 holds whole grads and sliced master: take this rank's slice
            opt_grads = [g if self._grad_axes[i] is not None
                         else shard(g, self._axes[i], self.dp_rank, self.dp_size)
                         for i, g in enumerate(grads)]
            step = self.global_steps + 1 - self.skipped_steps
            if self._client_optimizer is not None:
                self._client_step(opt_grads, step)
            else:
                kw = {"sumsq": self._leaf_sumsq} if self._opt_apply is lamb_opt.apply else {}
                self._opt_apply(opt_grads, self.opt_state, self._master, step,
                                self.optimizer.current_hyper(), groups=self._groups, **kw)
            del opt_grads
            if not self._external_master:
                for p, m, a in zip(self._params, self._master, self._axes):
                    p.copy_(unshard(m.to(self.compute_dtype), a, self.dp_size))
        if track:
            from ..utils.numerics import bucket_sumsq, leaf_sumsq
            index = self._sentinel_index
            wss = self._sum_sharded(leaf_sumsq(self._master), self._axes)
            if old is None:     # a skipped step: the update is exactly zero
                uss = torch.zeros_like(wss)
            else:
                uss = self._sum_sharded(
                    torch.stack([torch.sum(torch.square(m - o))
                                 for m, o in zip(self._master, old)]), self._axes)
            del old
            sent = dict(sent, weight_sumsq=bucket_sumsq(None, index, per_leaf=wss),
                        update_sumsq=bucket_sumsq(None, index, per_leaf=uss))
        self._update_scaler(overflow)
        return overflow, norm, sent

    def _update_scaler(self, overflow):
        self.scaler_state = ls.update(
            self.scaler_state, overflow, dynamic=self._dynamic_scale,
            scale_window=self.config.loss_scale_window,
            min_scale=self.config.min_loss_scale, hysteresis=self.config.hysteresis)

    @torch.no_grad()
    def _take_model_step(self):
        if self.telemetry is not None:
            # host-local dispatch boundary: every host-side phase of the step
            # is behind us (deepspeed_tpu/runtime/engine.py:2029-2039)
            self.telemetry.mark_step_dispatched()
        if self.wall_clock_breakdown():
            self.timers("step_microstep").start()
        if self._grad_acc is _FUSED:
            # deepspeed_tpu/runtime/engine.py:2042-2048: the state was adopted
            # at forward(); commit the bookkeeping
            overflow, self._last_grad_norm, self._pending_sentinel = self._fused_pending
            self._fused_pending = None
            self._finish_step(self.fp16_enabled() and overflow)
        elif self._offload is not None:
            self._finish_step(self._program("offload_step", self._offload_step)())
        else:
            overflow, self._last_grad_norm, self._pending_sentinel = self._program(
                "apply_update", self._update)(self._grad_acc)
            self._finish_step(overflow)

    def _offload_step(self) -> bool:
        """The host-tier step (deepspeed_tpu/runtime/engine.py:2079-2146):
        the grads' fetch begins, one device pass gives the norm and the fp16
        overflow, one host sync reads both, unscale x predivide x clip fold
        into ``grad_scale``, then the pipelined host Adam (skipped on
        overflow) pushes the compute params back, and the scaler updates.
        Returns the overflow."""
        grads = self._grad_acc
        handles = self._offload.begin_grad_fetch(grads)
        fp16 = self.fp16_enabled()
        index = self._sentinel_index
        sent = None
        flag = torch.zeros((), dtype=torch.float32, device=self.device)
        if index is not None:
            # the sentinel's vectors give the norm and the flag, and ride the
            # step's one host sync
            from ..utils.numerics import (bucket_nonfinite, bucket_sumsq, leaf_nonfinite,
                                          leaf_sumsq)
            sent = {"grad_sumsq": bucket_sumsq(None, index, per_leaf=self._sum_sharded(
                        leaf_sumsq(grads), self._grad_axes)),
                    "grad_nonfinite": bucket_nonfinite(None, index, per_leaf=self._sum_sharded(
                        leaf_nonfinite(grads), self._grad_axes))}
            norm_dev = torch.sqrt(sent["grad_sumsq"].sum())
            if fp16:
                flag = (sent["grad_nonfinite"].sum() > 0).to(torch.float32)
        else:
            norm_dev = self._grad_norm(grads)
            if fp16:
                flag = detect_overflow(grads, True)[0].to(self.device, torch.float32)
                if self.dp_size > 1:
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        from ..utils.telemetry import pack_fetch
        buf, unpack = pack_fetch([norm_dev, flag], sent)
        (norm_raw, flag), sent = unpack(buf.cpu())   # the one host sync
        overflow = bool(flag)
        scale = float(self.scaler_state.cur_scale)
        factor = 1.0
        if scale != 1.0 and scale > 0:
            factor = 1.0 / scale
        predivide = float(self.config.gradient_predivide_factor or 1.0)
        if self.config.prescale_gradients and predivide != 1.0:
            factor *= predivide
        norm = norm_raw * factor
        self._last_grad_norm = norm
        if index is not None:
            # sums of squares of the raw (still scaled) grads: factor^2 gives
            # the unscaled values the device path's sentinel reports
            self._pending_sentinel = {"grad_sumsq": sent["grad_sumsq"] * (factor * factor),
                                      "grad_nonfinite": sent["grad_nonfinite"]}
        clip = float(self.gradient_clipping() or 0.0)
        if clip > 0 and norm > clip:
            factor *= clip / (norm + 1e-6)
        if not overflow:
            hyper = self.optimizer.current_hyper()
            leaf_hypers = (None if self._groups is None else
                           [hyper[gi] for gi in self._groups])
            g = hyper[0]
            sharded = self.dp_size > 1
            out = [torch.empty(m.shape, dtype=self.compute_dtype, device=self.device)
                   if sharded and a is not None else p.data
                   for p, m, a in zip(self._params, self._master, self._axes)]
            self._offload.step_regions(
                handles, self.global_steps + 1 - self.skipped_steps, lr=g["lr"],
                beta1=g["beta1"], beta2=g["beta2"], eps=g["eps"],
                weight_decay=g["weight_decay"], grad_scale=factor, leaf_hypers=leaf_hypers,
                out=out)
            if sharded:
                for p, part, a in zip(self._params, out, self._axes):
                    if a is not None:
                        p.copy_(unshard(part, a, self.dp_size))
        self._update_scaler(overflow)
        return overflow

    def _finish_step(self, overflowed: bool):
        self._grad_acc = None
        if overflowed:
            self.skipped_steps += 1
            logger.info("[deepspeed_tpu_torch] OVERFLOW! Skipping step.")
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps == 0 or (self.global_steps + 1) % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps + 1}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}, mom={self.get_mom()}", ranks=[0])
        self.global_steps += 1
        self._observe_step(overflowed)
        self._window_losses = []
        interval = self.config.resilience_save_interval
        if (self._resilience is not None and interval > 0
                and self.global_steps % interval == 0):
            # snapshot on this thread (device->host of committed step state),
            # commit in the background — the next step never fences on the
            # filesystem. async_save=False degrades to the synchronous path.
            self._resilience.save(tag=f"global_step{self.global_steps}")
            if not self.config.resilience_async_save:
                self._resilience.wait()
        # goodput: close this step's interval AFTER the save hook, so its
        # snapshot fence is carved out of this step, not the next
        self._goodput_close_train_step()
        if self.wall_clock_breakdown():
            self.timers("step_microstep").stop()
            self.timers.log(["forward_microstep", "backward_microstep", "step_microstep"],
                            memory_breakdown=self.config.memory_breakdown)

    def _observe_step(self, overflowed=False):
        """The monitor's ``Train/Samples/*`` scalars, the session's
        ``end_step``, the numerics commit (and, on its interval, the desync
        audit) and the cluster heartbeat (deepspeed_tpu/runtime/engine.py:
        2160-2194). The window losses, the grad norm, the sentinel's vectors
        and an audit step's checksum matrix come to the host in one fetch,
        shared by all."""
        sent = self._pending_sentinel
        self._pending_sentinel = None
        if self.monitor is None and self.telemetry is None and self._numerics is None:
            return
        audit_s = None
        if self._numerics is not None and self._numerics.audit_due(self.global_steps):
            t0 = time.perf_counter()
            sent = dict(sent or {}, audit=self._audit_matrix())
            audit_s = time.perf_counter() - t0
        norm = self._last_grad_norm
        extra = [norm] if isinstance(norm, torch.Tensor) else []
        numerics_host = None
        if self.telemetry is not None:
            window, fetched = self.telemetry.fetch_window(self._window_losses, extra,
                                                          numerics=sent)
            numerics_host = self.telemetry.last_numerics if sent is not None else None
        elif self._window_losses or sent is not None:
            from ..utils.telemetry import pack_fetch
            values = [t.detach().float().reshape(()) for t in self._window_losses + extra]
            buf, unpack = pack_fetch(values, sent)
            host, numerics_host = unpack(buf.cpu())
            window, fetched = host[:len(self._window_losses)], host[len(self._window_losses):]
        else:
            window, fetched = [], []
        if self.monitor is not None:
            # reference scalars: Train/Samples/train_loss + lr + loss_scale
            samples = self.global_steps * self.train_batch_size()
            if window:
                self.monitor.add_scalar("Train/Samples/train_loss",
                                        sum(window) / len(window), samples)
            lr = self.get_lr()
            if lr:
                self.monitor.add_scalar("Train/Samples/lr", lr[0], samples)
            if self.fp16_enabled():
                self.monitor.add_scalar("Train/Samples/loss_scale", self.loss_scale(),
                                        samples)
            if norm is not None:
                self.monitor.add_scalar("Train/Samples/grad_norm",
                                        fetched[0] if extra else float(norm), samples)
            self.monitor.flush()
        if self.telemetry is not None:
            self.telemetry.end_step(self.global_steps, self.train_batch_size(),
                                    pending=self._window_losses, numerics=sent,
                                    run_goodput=self._goodput_scalars())
        if self._numerics is not None:
            grad_norm = (fetched[0] if extra else float(norm)) if norm is not None else None
            self._commit_numerics(numerics_host, overflowed, window[-1] if window else None,
                                  grad_norm, audit_s)
        if self._cluster is not None:
            self._cluster.on_step_end(self.global_steps)

    # ------------------------------------------------------------------ numerics
    def _commit_numerics(self, numerics_host, overflowed, loss, grad_norm, audit_s):
        """deepspeed_tpu/runtime/engine.py:2219-2238: the step's host values
        into the numerics monitor, and an audit step's matrix into its
        audit. Every input is on the host already (it rode the step's
        fetch): no sync of its own."""
        host = dict(numerics_host or {})
        matrix = host.pop("audit", None)
        self._numerics.commit_step(self.global_steps, host or None, loss=loss,
                                   overflowed=bool(overflowed), grad_norm=grad_norm)
        if matrix is not None:
            self._numerics.commit_audit(self.global_steps, matrix.reshape(
                self.dp_size, -1).tolist(), self._audit_plan[0], seconds=audit_s)

    def _build_audit(self):
        """(names, [(subtree id, leaf)]) of the desync audit: every leaf that
        is whole on every rank, the compute params (``params/<subtree>``)
        and the replicated optimizer leaves (``opt/<field>/<subtree>``, one
        level deeper, as JAX's optimizer trees nest), with the JAX engine's
        names (deepspeed_tpu/runtime/engine.py:2345-2394)."""
        from ..utils.numerics import subtree_name
        depth = self.config.numerics_subtree_depth
        names, ids, picks = [], {}, []

        def add(name, leaf):
            if name not in ids:
                ids[name] = len(names)
                names.append(name)
            picks.append((ids[name], leaf))

        paths = pytree.tree_flatten_with_path(self._sentinel_tree())[0]
        for path, i in paths:
            add(f"params/{subtree_name(path, depth)}", self._params[i])
        if self._offload is None and getattr(self, "opt_state", None) is not None:
            if self._client_optimizer is not None:
                for path, leaf in pytree.tree_flatten_with_path(self.opt_state)[0]:
                    add(f"opt/{subtree_name(path, depth + 1)}", leaf)
            elif self._onebit is not None:
                # the moments are whole on every rank; the error rows differ
                for field in ("exp_avg", "exp_avg_sq"):
                    add(f"opt/{field}", getattr(self.opt_state, field))
            else:
                for field, leaves_ in zip(self.opt_state._fields, self.opt_state):
                    for path, i in paths:
                        if self._axes[i] is None:       # a sharded slice differs by rank
                            add(f"opt/{field}/{subtree_name(path, depth)}", leaves_[i])
        return names, picks

    def _audit_matrix(self):
        """The desync audit (deepspeed_tpu/runtime/engine.py:2317-2360): the
        per-subtree uint32 checksums of the replicated leaves (int64 mod
        2^32), all-gathered over the ranks into ``[dp, n_subtrees]`` on the
        device; its host copy rides the step's fetch. At world 1 the one
        row (the JAX engine skips the audit there)."""
        from ..utils.numerics import leaf_checksum
        if self._audit_plan is None:
            self._audit_plan = self._build_audit()
        names, picks = self._audit_plan
        vec = torch.zeros(len(names), dtype=torch.int64, device=self.device)
        for j, leaf in picks:
            vec[j] += leaf_checksum(leaf)
        vec = torch.remainder(vec, 1 << 32)
        if self.dp_size > 1:
            rows = [torch.empty_like(vec) for _ in range(self.dp_size)]
            dist.all_gather(rows, vec)
            return torch.stack(rows)
        return vec[None]

    # ------------------------------------------------------------------ goodput
    # Run-lifecycle ledger hooks (deepspeed_tpu/runtime/engine.py:2232-2314):
    # host arithmetic over counters the other observatories keep.
    def _goodput_scalars(self):
        if self._goodput is None or not self.config.telemetry_goodput_emit_scalars:
            return None
        return dict(self._goodput.scalar_items())

    def _goodput_compile_delta(self):
        comp = self.telemetry.watchdog.compile_seconds()
        delta = comp - self._goodput_compile_base
        self._goodput_compile_base = comp
        return max(delta, 0.0)

    def _goodput_close_init(self):
        if self._goodput is None or not self._goodput_init_open:
            return
        self._goodput_init_open = False
        self._goodput.close("init", {"compile": self._goodput_compile_delta()})

    def _goodput_begin_eval(self):
        if self._goodput is None:
            return
        self._goodput_close_init()
        self._goodput.close("host_gap")

    def _goodput_end_eval(self):
        if self._goodput is None:
            return
        self._goodput.close("eval", {"compile": self._goodput_compile_delta()})

    def _goodput_close_train_step(self):
        """Close one train step's interval: carve compile, the checkpoint
        snapshot fence (``AsyncCheckpointer.last_stall_ms`` when a save ran
        this step) and this host's dispatch skew above the fleet median; a
        step during which the hang watchdog fired bills to hang."""
        if self._goodput is None:
            return
        self._goodput_close_init()
        carve = {"compile": self._goodput_compile_delta()}
        if self._resilience is not None:
            started = self._resilience.saves_started
            if started != self._goodput_saves_base:
                self._goodput_saves_base = started
                carve["checkpoint_stall"] = self._resilience.last_stall_ms / 1000.0
        hang = False
        if self._cluster is not None:
            skew = self._cluster.last_local_skew_s
            if skew > 0.0:
                carve["straggler_skew"] = skew
                self._cluster.last_local_skew_s = 0.0
            if self._cluster.watchdog is not None:
                fired = len(self._cluster.watchdog.fired)
                hang = fired != self._goodput_hang_base
                self._goodput_hang_base = fired
        self._goodput.close_step(self.global_steps, carve, hang=hang)

    # ------------------------------------------------------------------ checkpointing
    def _ckpt_keys(self):
        """(on-disk key, engine leaf index) of every parameter in the JAX
        package's leaf order: its ``_path_key`` over the module's
        ``params_tree()`` (``_client_layout``: dict keys sorted as
        ``jax.tree_util`` sorts them), else the parameter names with "." ->
        "/"."""
        if self._ckpt_key_list is None:
            if callable(getattr(self.module, "params_tree", None)):
                self._ckpt_key_list = [
                    (ckpt._path_key(path), i)
                    for path, i in pytree.tree_flatten_with_path(self._client_layout())[0]]
            else:
                self._ckpt_key_list = [(n.replace(".", "/"), i)
                                       for i, n in enumerate(self._names)]
        return self._ckpt_key_list

    def _ckpt_export(self, kind, materialize=True):
        """The state ``kind`` ("params", "master" or "opt") as {on-disk key:
        full host array}, in the JAX engine's (identity) layout: each ZeRO
        slice all-gathered leaf by leaf, which every rank joins, and copied to
        the host only where ``materialize``. The built-in optimizers' state
        keys by field (``exp_avg/<key>``), a client pair's by its own tree,
        1-bit Adam's by field alone (its flat vectors, and the error buffers
        as the JAX engine's ``(dp, cols)`` arrays: every rank's row)."""
        out = {}

        def put(key, t, axis):
            full = unshard(t, axis, self.dp_size)
            if materialize:
                out[key] = ckpt.to_host(full)

        keys = self._ckpt_keys()
        if kind == "params":
            for key, i in keys:
                put(key, self._params[i], None)
        elif kind == "master":
            for key, i in keys:
                put(key, self._master[i], self._axes[i])
        elif self._client_optimizer is not None:
            for path, leaf in pytree.tree_flatten_with_path(self.opt_state)[0]:
                put(ckpt._path_key(path), leaf, None)
        elif self._onebit is not None:
            for field, t in zip(self.opt_state._fields, self.opt_state):
                if field.endswith("_error"):
                    put(field, t[None], 0)
                else:
                    put(field, t, None)
        else:
            for field, leaves in zip(self.opt_state._fields, self.opt_state):
                for key, i in keys:
                    put(f"{field}/{key}", leaves[i], self._axes[i])
        return out

    @torch.no_grad()
    def _ckpt_import(self, kind, flat):
        """Inverse of ``_ckpt_export``: the full arrays of ``flat`` (key ->
        host array, read on access) copied into this rank's state in place,
        each ZeRO leaf's slice cut on the host, cast to the state's dtype."""
        def get(key, shape):
            if key not in flat:
                raise KeyError(f"checkpoint missing array {key!r}")
            return torch.from_numpy(np.asarray(flat[key])).reshape(shape)

        keys = self._ckpt_keys()
        if kind == "params":
            for key, i in keys:
                self._params[i].copy_(get(key, self._params[i].shape))
        elif kind == "master":
            for key, i in keys:
                self._place_master(i, get(key, self._params[i].shape))
        elif self._client_optimizer is not None:
            for path, leaf in pytree.tree_flatten_with_path(self.opt_state)[0]:
                leaf.copy_(get(ckpt._path_key(path), leaf.shape))
        elif self._onebit is not None:
            for field, t in zip(self.opt_state._fields, self.opt_state):
                if field.endswith("_error"):
                    t.copy_(get(field, (self.dp_size, t.numel()))[self.dp_rank])
                else:
                    t.copy_(get(field, t.shape))
        else:
            for field, leaves in zip(self.opt_state._fields, self.opt_state):
                for key, i in keys:
                    leaves[i].copy_(shard(get(f"{field}/{key}", self._params[i].shape),
                                          self._axes[i], self.dp_rank, self.dp_size))

    @torch.no_grad()
    def _place_master(self, i, full):
        """Put leaf ``i``'s restored full master where this engine keeps it:
        this rank's slice, in place. Under an external-master optimizer there
        is no master storage (the view re-derives from the params)."""
        if not self._external_master:
            self._master[i].copy_(shard(full, self._axes[i], self.dp_rank, self.dp_size))

    def _master_from_params(self):
        """The master re-derived as the float32 upcast of the compute params:
        a checkpoint that holds none (external master), or a load without
        the optimizer states (fp16-derived restore, stage2.py:1781-1836)."""
        for i, p in enumerate(self._params):
            self._place_master(i, p.detach().float())

    def save_checkpoint(self, save_dir, tag=None, client_state={}, save_latest=True):
        return ckpt.save_checkpoint(self, save_dir, tag=tag, client_state=client_state,
                                    save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True):
        return ckpt.load_checkpoint(self, load_dir, tag=tag,
                                    load_optimizer_states=load_optimizer_states,
                                    load_lr_scheduler_states=load_lr_scheduler_states)

    # ------------------------------------------------------------------ observatories
    def _meta(self, tree, dtype=None):
        """Meta tensors of a tree's shapes (``dtype``, else each leaf's)."""
        return pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=dtype or t.dtype, device="meta")
            if isinstance(t, torch.Tensor) else t, tree)

    def _update_cost_program(self):
        """The update's cost on meta tensors of its shapes: the norm, the
        clip, the optimizer and the re-cast (the state is not touched)."""
        grads = [torch.empty(m.shape, dtype=self._acc_dtype, device="meta")
                 for m in (self._master if self._master is not None else self._params)]
        hyper = self.optimizer.current_hyper()

        def run():
            norm = torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                           for g in grads]).sum())
            clip = float(self.gradient_clipping() or 0.0)
            if clip > 0:
                clip_grads_by_global_norm(grads, clip, norm=norm)
            state = self._meta(self.opt_state)
            if self._client_optimizer is not None:
                g = self.optimizer.param_groups[0]
                h = {k: torch.tensor(v, dtype=torch.float32, device="meta")
                     for k, v in (("lr", g["lr"]), ("beta1", g["betas"][0]),
                                  ("beta2", g["betas"][1]), ("eps", g["eps"]),
                                  ("weight_decay", g["weight_decay"]))}
                master = (None if self._external_master
                          else self._client_tree(self._meta(self._master)))
                step = torch.tensor(1, dtype=torch.int32, device="meta")
                self._opt_apply(self._client_tree(grads), state, master, step, h)
                if self._external_master:
                    return
                master = self._meta(self._master)
            else:
                master = self._meta(self._master)
                kw = ({"sumsq": lambda i, t: torch.sum(torch.square(t))}
                      if self._opt_apply is lamb_opt.apply else {})
                self._opt_apply(grads, state, master, 1, hyper, groups=self._groups, **kw)
            for m in master:
                m.to(self.compute_dtype)
        return run

    def flops_profile(self, *inputs, peak_tflops=None):
        """The cost of THIS engine's step (deepspeed_tpu/runtime/engine.py:
        2430) by ``utils/flops_profiler.py``: the forward and the backward
        of one micro-batch ``inputs`` run on the engine's tensors under the
        flop and byte counters (their grads dropped after; the RNG state
        restored, so the run changes nothing), and the update's cost on meta
        tensors of its shapes (the optimizer's state is not touched). Under
        ZeRO-Offload the update runs on the host tier and only the device
        program is counted. ``report["flops"]`` covers one micro-batch and
        one update; ``report["program_flops"]`` splits it
        (``loss_and_grad``, ``apply_update``; one ``fused_step`` on the
        fused path)."""
        from ..utils.flops_profiler import profile as _profile
        batch = tuple(self._to_device(x) for x in inputs)
        cpu_rng = torch.get_rng_state()
        cuda_rng = torch.cuda.get_rng_state(self.device) if self.device.type == "cuda" else None

        def loss_and_grad(*b):
            loss = self._loss(b)
            self._scaled(loss).backward()
            return loss.detach()

        try:
            report = _profile(loss_and_grad, *batch, peak_tflops=peak_tflops)
        finally:
            for p in self._params:
                p.grad = None
            torch.set_rng_state(cpu_rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
        report["program_flops"] = {"loss_and_grad": report["flops"]}
        if self._offload is None:
            upd = _profile(self._update_cost_program())
            for k in ("flops", "bytes_accessed"):
                report[k] += upd[k]
            report["program_flops"]["apply_update"] = upd["flops"]
            report["arithmetic_intensity"] = (report["flops"] / report["bytes_accessed"]
                                              if report["bytes_accessed"] else 0.0)
            if peak_tflops:
                report["optimal_seconds"] = report["flops"] / (peak_tflops * 1e12)
        if self._fused:
            report["program_flops"] = {"fused_step": report["flops"]}
        report["programs"] = list(report["program_flops"])
        report["params"] = sum(int(p.numel()) for p in self._params)
        return report

    def lint_programs(self, sample_batch):
        """``[(name, fn, args, manifest)]`` for every program on this engine's
        ACTIVE step path, with the manifests the program lint passes check
        (lint/program_passes.py; deepspeed_tpu/runtime/engine.py:1591-1753):

        - ``loss_and_grad``: one micro-batch's forward and backward (its
          grads in ``grad_dtype``, reduced over the ranks);
        - ``accumulate`` (gas > 1): the grads added into the accumulator in
          place;
        - ``apply_update``: the update on the accumulator; parameters,
          master and optimizer state in place;
        - ``fused_step`` on the fused path, in place of the three;
        - ``offload_step`` under ZeRO-Offload, in place of the update: the
          host tier's step, which writes the parameters back in place.

        At dp = 1 no large collective may appear; at dp > 1 the backward
        reduces in exactly ``grad_dtype`` (the port issues ``reduce_scatter``
        for the leaves ZeRO >= 2 shards and ``all_reduce`` for the others,
        both reductions) and the update re-gathers the parameters in the
        compute dtype where the master is sliced. Budgets count only results
        above 256 elements, so the norm's scalar all-reduces ride free.

        Capturing a program runs it once: the registry builds throwaway
        engines for that (lint/registry.py). The update programs take a zero
        accumulator of the real one's layout."""
        batch = tuple(self._to_device(x) for x in sample_batch)
        compute = dtype_name(self.compute_dtype)
        grad_dt = dtype_name(self._grad_dtype)
        dp = self.dp_size
        # one reduction a bucket under the bucketed overlap (a re-fused
        # monolithic exchange fails the floor); 1-bit Adam's grads stay local
        n_buckets = len(self._overlap_plan) if self._overlap_plan else 0
        red = ({"min": max(1, n_buckets), "dtypes": [grad_dt]}
               if dp > 1 and self._exchange_kind != "stacked" else {"max": 0})
        scattered = dp > 1 and any(a is not None for a in self._axes)
        gather_gate = ({"all-gather": {"min": 1, "dtypes": [compute]}}
                       if scattered else {})
        # the two-level schedule's intra-slice all-gather (one a bucket) is
        # a declared collective of the backward
        hier_gate = ({"all-gather": {"min": max(1, n_buckets),
                                     "dtypes": sorted({grad_dt, "f32"})}}
                     if self._exchange_kind in ("bucketed", "hierarchical")
                     and self._comm_mode != COMM_MODE_FLAT else {})
        if n_buckets:
            # the smallest bucket's shard must cross the large-collective floor
            small = {"small_element_threshold": max(
                8, min(b["n_pad"] for b in self._overlap_plan) // dp - 1)}
        elif dp > 1 and self._exchange_kind in ("flat", "sparse"):
            # the per-leaf exchange: the smallest leaf's reduction result
            small = {"small_element_threshold": max(8, min(
                (p.numel() // dp if a is not None else p.numel())
                for p, a in zip(self._params, self._grad_axes)) - 1)}
        else:
            small = {}

        def state(*classes):
            getters = {"params": lambda: list(self._params),
                       "master": lambda: list(self._master or ()),
                       "optimizer": lambda: [t for t in pytree.tree_leaves(self.opt_state)
                                             if isinstance(t, torch.Tensor)]}
            if self._external_master:
                classes = [c for c in classes if c == "optimizer"]
            return {c: getters[c] for c in classes}

        def man(inplace=(), inplace_args=(), **kw):
            return dict({"compute_dtype": compute, "strict": True,
                         "donation": {"check_unusable": True, "inplace": dict(inplace),
                                      "inplace_args": list(inplace_args)}}, **kw)

        def acc_like(dtype):
            return [torch.zeros(m.shape if a is not None else p.shape, dtype=dtype,
                                device=self.device)
                    for p, m, a in zip(self._params,
                                       self._master if self._master is not None
                                       else self._params, self._grad_axes)]

        def loss_and_grad(*b):
            loss = self._fwd(*b)
            return loss.detach(), self._micro_grads(loss, compress=False)

        lg = ("loss_and_grad", loss_and_grad, batch,
              man(any_reduction=red, collectives=dict(hier_gate), **small))
        if self._offload is not None:
            def offload_step(acc):
                self._grad_acc = acc
                try:
                    return self._offload_step()
                finally:
                    self._grad_acc = None
            return [lg, ("offload_step", offload_step, (acc_like(self._acc_dtype),),
                         man(state("params"), any_reduction={"max": 0},
                             collectives=gather_gate))]
        if self._use_fused():
            def fused_step(*b):
                try:
                    return self._fused_forward(*b)
                finally:
                    self._fused_pending = self._pending_loss = None
                    self._pending_is_fused = False
            return [("fused_step", fused_step, batch,
                     man(state("params", "master", "optimizer"), any_reduction=red,
                         collectives=dict(gather_gate, **hier_gate), **small))]
        progs = [lg]
        if self._compress:
            # the compressed exchange: packed u8 signs over the cross-slice
            # all-to-all and all-gather, float32 scales and intra-slice steps
            def loss_and_grad_comm(*b):
                loss = self._fwd(*b)
                return loss.detach(), self._micro_grads(loss, compress=True)

            progs.append(("loss_and_grad_comm", loss_and_grad_comm, batch, man(
                [("comm_ef", lambda: [self._comm_we, self._comm_se])],
                any_reduction={"min": 1, "dtypes": ["f32"]},
                collectives={"all-gather": {"min": max(1, n_buckets),
                                            "dtypes": sorted({"f32", "u8", "s8", grad_dt})},
                             "all-to-all": {"min": max(1, n_buckets),
                                            "dtypes": ["s8", "u8"]}},
                small_element_threshold=8 if n_buckets else 16)))
        acc = acc_like(self._acc_dtype)
        if self.gradient_accumulation_steps() > 1:
            progs.append(("accumulate", _accumulate,
                          (acc, acc_like(self._grad_dtype)),
                          man(inplace_args=acc, collectives={})))
        progs.append(("apply_update", self._update, (acc,),
                      man(state("params", "master", "optimizer"), collectives=gather_gate)))
        return progs

    def memory_manifest(self):
        """deepspeed_tpu/runtime/engine.py:1754-1830: every persistent
        device-resident tree this engine owns, grouped into the memory
        observatory's classes (``utils/hbm.py``), with the geometry the
        closed-form ZeRO model needs. Live tensors, or meta tensors for what
        exists only inside a step. Classes, JAX's keys:

        - ``params``: the compute-dtype parameters;
        - ``grads``: the accumulation buffer handed from the backward to the
          update on the two-step and offload paths (meta: it lives between
          the two); absent on the fused path;
        - ``master`` / ``optimizer``: this rank's float32 master and moment
          slices (absent under ZeRO-Offload, whose state is in host memory;
          an external-master client pair's state is ``optimizer`` alone).
        """
        classes = {"params": list(self._params)}
        offload = self._offload is not None
        fused = bool(self._fused)

        def grads_like(dtype):
            return [torch.empty(m.shape if a is not None else p.shape, dtype=dtype,
                                device="meta")
                    for p, m, a in zip(self._params,
                                       self._master if self._master is not None
                                       else self._params, self._grad_axes)]

        if offload:
            classes["grads"] = grads_like(self._grad_dtype)
            grad_itemsize = torch.empty((), dtype=self._grad_dtype).element_size()
        elif not fused:
            classes["grads"] = grads_like(self._acc_dtype)
            grad_itemsize = torch.empty((), dtype=self._acc_dtype).element_size()
        else:
            grad_itemsize = torch.empty((), dtype=self._grad_dtype).element_size()
        master_numel = 0
        if offload:
            pass                    # master and moments live in host memory
        elif self._external_master:
            classes["optimizer"] = self.opt_state
            # the client-declared quantity: an external master is an Adam
            # style float32 triple (master, m1, m2) over the client's shard
            master_numel = sum(int(t.numel()) for t in pytree.tree_leaves(self.opt_state)
                               if isinstance(t, torch.Tensor)) // 3
        else:
            classes["master"] = list(self._master)
            classes["optimizer"] = self.opt_state
        comm_ef_bytes = 0
        if self._comm_we is not None:
            # the compressed exchange's error feedback: this rank's rows
            classes["comm_ef"] = [self._comm_we, self._comm_se]
            comm_ef_bytes = 4 * (self._comm_we.numel() + self._comm_se.numel())
        psi = sum(int(p.numel()) for p in self._params)
        geometry = {
            "kind": "training",
            "psi": psi,
            "param_itemsize": torch.empty((), dtype=self.compute_dtype).element_size(),
            "grad_itemsize": int(grad_itemsize),
            "dp": int(self.dp_size),
            "zero_stage": int(self.zero_optimization_stage()),
            "zero_sharded_fraction": self._zero_sharded_fraction,
            "external_master": bool(self._external_master),
            "master_numel": int(master_numel),
            "offload": offload,
            "fused": fused,
            "gas": int(self.gradient_accumulation_steps()),
            "comm_ef_bytes": int(comm_ef_bytes),
            "n_buckets": len(self._overlap_plan) if self._overlap_plan else 0,
        }
        return {"classes": classes, "geometry": geometry}
