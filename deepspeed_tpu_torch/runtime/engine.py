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

What the slice does not carry raises ``NotImplementedError`` naming its
ROADMAP.md item.
``compilation_cache_dir`` names the JAX compile cache and has no counterpart
in eager PyTorch; it is ignored.
"""

import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from ..checkpoint import checkpointing as ckpt
from ..device import resolve_device
from ..ops import adam as adam_opt
from ..ops.cpu_adam import DeepSpeedCPUAdam
from ..ops import lamb as lamb_opt
from ..ops import sgd as sgd_opt
from ..resilience.async_ckpt import AsyncCheckpointer
from ..resilience.auto_resume import auto_resume
from ..utils import log_dist, logger
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer, device_sync
from .activation_checkpointing import checkpointing as act_ckpt
from .config import DeepSpeedConfig
from .constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, COMM_MODE_FLAT,
                        COMM_OVERLAP_BUCKETED, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
                        ROUTE_TRAIN, SGD_OPTIMIZER)
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

        self.dp_size = dist.get_world_size() if dist.is_initialized() else 1
        self.dp_rank = dist.get_rank() if dist.is_initialized() else 0

        config_file = getattr(args, "deepspeed_config", None) if args is not None else None
        if config_params is None and config_file is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or config_params")
        self.config = DeepSpeedConfig(config_params if config_params is not None
                                      else config_file, world_size=self.dp_size)
        self._refuse_unported()
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

        self._ckpt_key_list = None          # _ckpt_keys, built at first use
        self.last_checkpoint_load = None    # load_checkpoint's seconds by stage
        # ---- resilience: periodic async checkpointing and auto-resume
        # (deepspeed_tpu/runtime/engine.py:676-700). All host-side: the save
        # hook in _finish_step snapshots the committed step state and commits
        # on a writer thread
        self._resilience = None
        if self.config.resilience_enabled and self.config.resilience_save_dir:
            self._resilience = AsyncCheckpointer(self, self.config.resilience_save_dir)
            if self.config.resilience_auto_resume:
                auto_resume(self, self.config.resilience_save_dir)

        # ---- the fused step (deepspeed_tpu/runtime/engine.py:1183-1205, 1473-1527)
        self._fused = self._fused_eligible()
        self._fused_pending = None          # (overflow, norm) of the uncommitted update
        self._warned_fused_cpu_ckpt = False

    def _refuse_unported(self):
        c = self.config
        if c.zero_enabled and c.zero_optimization_stage >= 3:
            raise _later("ZeRO stage 3", "item 17b")
        if c.optimizer_name == ONEBIT_ADAM_OPTIMIZER:
            raise _later("1-bit Adam", "item 18")
        if c.sparse_gradients_enabled:
            raise _later("sparse_gradients", "item 18")
        if c.comm_mode != COMM_MODE_FLAT:
            raise _later(f"comm.mode={c.comm_mode!r}", "item 18")
        if c.comm_overlap_mode == COMM_OVERLAP_BUCKETED:
            raise _later("comm.overlap.mode='bucketed'", "item 18")
        if c.sequence_parallel_enabled:
            raise _later("sequence_parallel", "item 14")
        for on, what, item in ((c.telemetry_enabled, "telemetry", "items 21-22"),
                               (c.numerics_enabled, "numerics", "item 22"),
                               (c.tensorboard_enabled, "the tensorboard monitor", "item 21")):
            if on:
                raise _later(what, item)

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
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").start()
        batch = tuple(self._to_device(x) for x in inputs)
        if self._in_training and self._use_fused():
            loss = self._fused_forward(batch)
        elif self._in_training:
            loss = self._loss(batch)
            self._pending_loss = loss
        else:
            with torch.no_grad():
                loss = self._loss(batch)
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").stop()
        return loss

    def _loss(self, batch):
        loss = self.module(*batch)
        return loss[0] if isinstance(loss, (tuple, list)) else loss

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
            grads = self._micro_grads(self._pending_loss)
            if self._grad_acc is None:
                self._grad_acc = [g.to(self._acc_dtype) for g in grads]
            else:
                for a, g in zip(self._grad_acc, grads):
                    a.add_(g)   # in the accumulator's dtype: a + g.astype(acc_dtype)
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

    def _micro_grads(self, loss):
        """This micro-batch's grads, every leaf in ``grad_dtype`` (zeros for
        a leaf the loss does not reach) and reduced over the ranks."""
        self._scaled(loss).backward()
        grads = []
        for p in self._params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads.append(g.to(self._grad_dtype))
        if self.dp_size > 1:
            grads = [self._reduce(g, a) for g, a in zip(grads, self._grad_axes)]
        return grads

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
        """The JAX engine's rule: ``fused_step`` needs gas 1, no ZeRO-Offload
        and no cpu activation checkpointing (else it warns and takes the
        two-step path); an external-master pair at gas 1 is always fused."""
        gas1 = self.gradient_accumulation_steps() == 1
        if self.config.fused_step and not (gas1 and self._offload is None
                                           and not self._cpu_checkpointing_active()):
            logger.warning(
                "[deepspeed_tpu_torch] fused_step requested but ineligible (it needs "
                "gradient_accumulation_steps == 1, no ZeRO-Offload and no cpu "
                "activation checkpointing); using the two-step path")
            return False
        if self._external_master:
            return gas1
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

    def _fused_forward(self, batch):
        """deepspeed_tpu/runtime/engine.py:1939-1951: the whole step at
        ``forward()``, with ``current_hyper()`` of this moment and step
        number ``global_steps + 1 - skipped_steps``."""
        if self._fused_pending is not None:
            raise RuntimeError(_ROTATION)
        loss = self._loss(batch)
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

    def _prep_grads(self, grads):
        """deepspeed_tpu/runtime/engine.py:1328-1369 ``prep_grads``: the fp16
        overflow check and unscale, the predivide, the global norm, the clip.
        Returns (grads, overflow, norm)."""
        fp16 = self.fp16_enabled()
        overflow, _ = detect_overflow(grads, fp16)
        if fp16:
            flag = overflow.to(self.device, torch.float32)
            if self.dp_size > 1:
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
        norm = self._grad_norm(grads)
        clip = float(self.gradient_clipping() or 0.0)
        if clip > 0:
            clip_grads_by_global_norm(grads, clip, norm=norm)
        return grads, overflow, norm

    @torch.no_grad()
    def _update(self, grads):
        """deepspeed_tpu/runtime/engine.py:1371-1400 ``apply_update``, the one
        body of the two-step path and the fused step: prep, the optimizer on
        this rank's slices and the master -> compute re-cast (skipped on
        overflow), the scaler update. Returns (overflow, norm)."""
        grads, overflow, norm = self._prep_grads(grads)
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
        self._update_scaler(overflow)
        return overflow, norm

    def _update_scaler(self, overflow):
        self.scaler_state = ls.update(
            self.scaler_state, overflow, dynamic=self._dynamic_scale,
            scale_window=self.config.loss_scale_window,
            min_scale=self.config.min_loss_scale, hysteresis=self.config.hysteresis)

    @torch.no_grad()
    def _take_model_step(self):
        if self.wall_clock_breakdown():
            self.timers("step_microstep").start()
        if self._grad_acc is _FUSED:
            # deepspeed_tpu/runtime/engine.py:2042-2048: the state was adopted
            # at forward(); commit the bookkeeping
            overflow, self._last_grad_norm = self._fused_pending
            self._fused_pending = None
            self._finish_step(self.fp16_enabled() and overflow)
        elif self._offload is not None:
            self._finish_step(self._offload_step())
        else:
            overflow, self._last_grad_norm = self._update(self._grad_acc)
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
        norm_dev = self._grad_norm(grads)
        flag = torch.zeros((), dtype=torch.float32, device=self.device)
        if fp16:
            flag = detect_overflow(grads, True)[0].to(self.device, torch.float32)
            if self.dp_size > 1:
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        norm_raw, flag = torch.stack([norm_dev, flag]).tolist()   # the one host sync
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
        if self.wall_clock_breakdown():
            self.timers("step_microstep").stop()
            self.timers.log(["forward_microstep", "backward_microstep", "step_microstep"],
                            memory_breakdown=self.config.memory_breakdown)

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
        keys by field (``exp_avg/<key>``), a client pair's by its own tree."""
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

    # ------------------------------------------------------------------ not ported
    def flops_profile(self, *inputs, peak_tflops=None):
        raise _later("flops_profile", "item 22")

    def lint_programs(self, sample_batch):
        raise _later("lint_programs", "item 23")

    def memory_manifest(self):
        raise _later("memory_manifest", "item 22")
