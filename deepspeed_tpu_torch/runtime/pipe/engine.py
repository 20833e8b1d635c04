"""Pipeline engine: the per-rank executor, with the instruction executor
(PyTorch port).

Counterpart of ``deepspeed_tpu/runtime/pipe/engine.py`` (``PipelineEngine``
:123). ``initialize(model=PipelineModule)`` routes here, onto one of two
executors (``pipeline.spmd``: ``auto`` / ``true`` / ``false``, the JAX
eligibility rule of :136-164 with the torch world's size in place of the
device count):

1. **Per-rank** (the JAX SPMD executor's counterpart): a world of S x dp
   ranks, homogeneous stages (``_find_spmd_decomposition``: an optional
   stage-0 prefix, S identical core blocks, an optional last-stage suffix).
   Each rank builds a stage module (``_StageModule``) holding its stage's
   core layers, the prefix and the suffix, and trains it through the base
   engine over a (pipe = S, data = dp) mesh: the window of M micro-batches
   is one call of ``parallel/pipeline_spmd.py``'s ``pipeline_apply`` (the
   base engine sees a window of 1), ZeRO 1/2 partition over the data group,
   the core leaves are split over the pipe group (their squares summed over
   it for the norm, as a tensor-parallel leaf's over the model group).
2. **Instruction** (``pipeline.spmd: false``, one process, or what the
   per-rank executor does not take): one process runs every stage's
   ``TrainSchedule`` stream (``schedule.py``), merged by step with every
   Send before any Recv, on the engine's device. The channels are keyed by
   (sending stage, micro-batch) and held to the receiver's ring
   (``_assert_ring_bound``). A ForwardPass runs the stage without a graph
   and keeps its input and torch's random state; the BackwardPass
   recomputes the stage with a graph on the same draws and differentiates
   it (the JAX executor's recompute inside its VJP, :519);
   the last stage runs once, in its BackwardPass, as in JAX. So on each
   micro-batch a stage other than the last launches its layers' forward
   twice and the last once. Each stage's gradients are added, per leaf,
   into a float32 window accumulator (the base engine's ``_acc_dtype``),
   so a tied layer's uses sum; the fp16 loss scale rides in the
   last stage's factor (scale / M, :709); at OptimizerStep the
   accumulator is averaged over the data group and the base update runs,
   overflow skipping the step.

Checkpoints are layer-keyed in both (``layer_N/...``, ``tied::KEY/...``):
the per-rank executor writes each core leaf under every stage's key
(``_export_leaf``: an all-gather over the pipe group), so a checkpoint
moves across stage counts and executors. ``forward`` / ``backward`` /
``step`` raise ``PipelineError``: use ``train_batch`` / ``eval_batch``.

With ``telemetry.pipeline_trace.enabled`` the instruction executor records
each instruction's span (``utils/pipeline_trace.py``); the per-rank executor
warns, as the JAX SPMD executor does. ZeRO-Offload raises (the JAX
assertion, :185-187). 1-bit Adam and param groups take the instruction
executor, as in JAX. What the per-rank executor leaves out raises
``NotImplementedError`` naming ROADMAP.md item 16b.
"""

import contextlib
import json
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ...parallel.mesh import PIPE_AXIS, all_gather_cat
from ...parallel.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec, _nest
from ...parallel.pipeline_spmd import RngState, pipeline_apply, vjp
from ...parallel.topology import PipeDataParallelTopology, PipelineParallelGrid
from ...utils import log_dist, logger
from ..engine import DeepSpeedEngine
from . import schedule


def _raw_config_dict(args, config_params):
    """The raw JSON config dict before DeepSpeedConfig exists: the executor
    is chosen before the base engine parses the config."""
    if isinstance(config_params, dict):
        return config_params
    path = getattr(args, "deepspeed_config", None) if args is not None else None
    path = path or (config_params if isinstance(config_params, str) else None)
    if path:
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            return {}
    return {}


def _spec_signature(spec):
    """Comparable identity of a layer spec for the stage-homogeneity check;
    None for a spec that cannot be proven identical across stages (tied
    layers, or specs whose arguments defeat comparison)."""
    if isinstance(spec, TiedLayerSpec):
        return None
    if isinstance(spec, LayerSpec):
        try:
            return ("spec", id(spec.typename), repr(spec))
        except Exception:
            return None
    if isinstance(spec, nn.Module):
        return None
    if callable(spec):
        return ("callable", id(spec))
    return None


def _assert_ring_bound(chan, src_stage, receiver_ring, direction):
    """The reference's per-stage buffer-ring memory contract as an invariant:
    payloads in flight from ``src_stage`` never exceed the receiver's
    ``num_pipe_buffers()``."""
    in_flight = sum(1 for (src, _) in chan if src == src_stage)
    assert in_flight <= receiver_ring, (
        f"stage {src_stage} {direction} channel holds {in_flight} payloads "
        f"> receiver num_pipe_buffers()={receiver_ring}")


class PipelineError(Exception):
    """Errors related to the use of the PipelineEngine."""


_SEND_CMDS = (schedule.SendActivation, schedule.SendGrad, schedule.LoadMicroBatch)

_TIMER_BY_CMD = {
    schedule.LoadMicroBatch: "batch_input",
    schedule.ForwardPass: "forward_microstep",
    schedule.BackwardPass: "backward_microstep",
    schedule.SendActivation: "pipe_send_output",
    schedule.RecvActivation: "pipe_recv_input",
    schedule.SendGrad: "pipe_send_grad",
    schedule.RecvGrad: "pipe_recv_grad",
    schedule.OptimizerStep: "step_microstep",
}
_PIPE_TIMERS = ["batch_input", "forward_microstep", "backward_microstep", "pipe_send_output",
                "pipe_recv_input", "pipe_send_grad", "pipe_recv_grad", "step_microstep",
                "train_batch"]


class _StageModule(nn.Module):
    """One pipe rank's part of a homogeneous ``PipelineModule`` for the
    per-rank executor: its stage's core layers, the prefix and the suffix,
    registered under their canonical keys. ``forward(x_mb, labels_mb)`` is
    the window's mean loss through ``pipeline_apply``: the prefix as its
    first stage, the suffix and ``loss_fn`` as its last (their parameters
    replicated over the pipe group, their gradients summed over it)."""

    split_axis = PIPE_AXIS

    def __init__(self, pipe_module: PipelineModule, decomp, mesh):
        super().__init__()
        from ...models.gpt2 import _TP
        self._pm = (pipe_module,)       # not a submodule: only this rank's layers are
        self.mesh = mesh
        S = pipe_module.num_stages
        s = mesh.axis_index(PIPE_AXIS)
        self.stage = s
        keys = pipe_module.layer_keys
        self.core = [decomp["starts"][s] + j for j in range(decomp["L"])]
        self.prefix, self.suffix = decomp["prefix"], decomp["suffix"]
        for idx in self.prefix + self.core + self.suffix:
            k = keys[idx]
            if k is not None and k not in self._modules:
                self.add_module(k, pipe_module._built_layers[idx])
        # each core key's keys across the stages, by core position
        self.stage_keys = {keys[self.core[j]]: [keys[decomp["starts"][t] + j] for t in range(S)]
                           for j in range(decomp["L"]) if keys[self.core[j]] is not None}
        self._tp = _TP(S, s, mesh.group(PIPE_AXIS))

    @property
    def tp_size(self):
        return self._tp.size

    def _top(self, name):
        return name.split(".", 1)[0]

    def tp_axis(self, name):
        """0 for a core layer's leaf (split over the pipe group), None for the
        prefix's and the suffix's (replicated)."""
        return 0 if self._top(name) in self.stage_keys else None

    def params_tree(self):
        return _nest(self.named_parameters())

    def _params_of(self, idxs):
        pm = self._pm[0]
        seen, out = set(), []
        for idx in idxs:
            k = pm.layer_keys[idx]
            if k is not None and k not in seen:
                seen.add(k)
                out.extend(p for _, p in sorted(self._modules[k].named_parameters()))
        return out

    def forward(self, x_mb, labels_mb):
        pm = self._pm[0]

        def stage_fn(_params, x):
            for idx in self.core:
                x = pm.apply_layer(idx, x)
            return x

        def first_fn(x, *_params):
            for idx in self.prefix:
                x = pm.apply_layer(idx, x)
            return x

        def last_fn(y, labels, *rest):
            mb = rest[-1]
            for idx in self.suffix:
                y = pm.apply_layer(idx, y)
            return pm.loss_fn(y, labels[mb])

        return pipeline_apply(
            stage_fn, self._params_of(self.core), x_mb, mesh=self.mesh,
            first_stage_fn=first_fn if self.prefix else None,
            first_stage_args=tuple(self._params_of(self.prefix)) if self.prefix else (),
            last_stage_fn=last_fn,
            last_stage_args=(labels_mb,) + tuple(self._params_of(self.suffix)),
            last_stage_args_specs=("mb",) + ("rep",) * len(self._params_of(self.suffix)))


class PipelineEngine(DeepSpeedEngine):

    def __init__(self, args=None, model=None, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("model must be a PipelineModule")
        self.pipe_module = model
        self.num_stages = model.num_stages
        if model_parameters is not None:
            # the whole module's canonical names (params_from_jax gives them)
            from ...models.gpt2 import load_parameters
            load_parameters(model, model_parameters)
        self._layer_keys = model.layer_keys

        # ---- executor selection (per-rank vs instruction) ----
        self._spmd = False
        self._spmd_decomp = None
        raw_cfg = _raw_config_dict(args, config_params)
        spmd_opt = (raw_cfg.get("pipeline") or {}).get("spmd", "auto")
        opt_name = str(((raw_cfg.get("optimizer") or {}).get("type") or "")).lower()
        has_param_groups = bool(((raw_cfg.get("optimizer") or {}).get("params") or {})
                                .get("param_groups"))
        world = dist.get_world_size() if dist.is_initialized() else 1
        eligible = (spmd_opt in (True, "auto")
                    and self.num_stages > 1
                    and model.loss_fn is not None
                    and world % self.num_stages == 0
                    # 1-bit Adam needs whole replicated params; param-group
                    # patterns are written against canonical layer paths
                    and opt_name != "onebitadam"
                    and not has_param_groups)
        if eligible:
            self._spmd_decomp = self._find_spmd_decomposition(model)
            if self._spmd_decomp is None and spmd_opt is True:
                raise ValueError(
                    "pipeline.spmd=true but the stage partition is not homogeneous "
                    f"(parts={model.parts}): the per-rank executor needs S identical core "
                    "blocks (plus optional stage-0 prefix / last-stage suffix)")

        if self._spmd_decomp is not None:
            self._spmd = True
            mpu = PipelineParallelGrid(PipeDataParallelTopology(
                num_pp=self.num_stages, num_dp=world // self.num_stages))
            stage_module = _StageModule(model, self._spmd_decomp, mpu.mesh)
            super().__init__(args=args, model=stage_module, optimizer=optimizer,
                             training_data=training_data, lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required, collate_fn=collate_fn,
                             config_params=config_params, device=device)
            own = {i: k for k, i in self._ckpt_keys()}
            # on-disk key of each core leaf at every stage (its own first path part
            # replaced by that stage's layer key)
            self._stage_ckpt_keys = {}
            for i, k in own.items():
                top, rest = k.split("/", 1)
                if top in stage_module.stage_keys:
                    self._stage_ckpt_keys[i] = (k, [f"{t}/{rest}" for t in
                                                    stage_module.stage_keys[top]])
        else:
            super().__init__(args=args, model=model, optimizer=optimizer,
                             training_data=training_data, lr_scheduler=lr_scheduler, mpu=None,
                             dist_init_required=dist_init_required, collate_fn=collate_fn,
                             config_params=config_params, device=device)
        if self._offload is not None:
            raise AssertionError(
                "cpu_offload is not supported with pipeline parallelism (the pipeline "
                "optimizer step runs on device; reference pairs offload with plain ZeRO-2 only)")

        # the real accumulation window (the per-rank executor reports 1 to
        # the base engine: the window is one pipeline_apply call)
        self.micro_batches = self.config.gradient_accumulation_steps
        self.agg_train_loss = None
        if not self._spmd:
            index = {id(p): i for i, p in enumerate(self._params)}
            self._stage_leaves = []
            for s in range(self.num_stages):
                seen, leaves = set(), []
                for idx in range(model.parts[s], model.parts[s + 1]):
                    layer = model._built_layers[idx]
                    if isinstance(layer, nn.Module):
                        for p in layer.parameters():
                            if id(p) not in seen:
                                seen.add(id(p))
                                leaves.append(index[id(p)])
                self._stage_leaves.append(leaves)

        # ---- the pipeline schedule observatory (docs/pipeline-trace.md) ----
        self.pipe_trace = None
        if getattr(self.config, "pipeline_trace_enabled", False):
            if self._spmd:
                logger.warning(
                    "[deepspeed_tpu_torch] telemetry.pipeline_trace: the per-rank executor "
                    "runs the whole window as one pipeline_apply call — there is no "
                    "instruction stream to trace; set pipeline.spmd=false to record spans")
            else:
                from ...utils.pipeline_trace import PipelineTracer
                self.pipe_trace = PipelineTracer(
                    stages=self.num_stages,
                    capacity=self.config.pipeline_trace_capacity,
                    dump_dir=self.config.pipeline_trace_dump_dir or None,
                    host_id=dist.get_rank() if dist.is_initialized() else 0)
                rec = getattr(self._numerics, "recorder", None) if self._numerics else None
                if rec is not None:
                    rec.pipeline_trace = self.pipe_trace

        d = self._spmd_decomp
        log_dist(
            f"PipelineEngine[{'per-rank' if self._spmd else 'instruction'}]: "
            f"{self.num_stages} stages, parts={model.parts}"
            + (f", core={d['L']} layers/stage, prefix={len(d['prefix'])}, "
               f"suffix={len(d['suffix'])}, mesh={dict(self.mesh.shape)}"
               if self._spmd else ""),
            ranks=[0])

    def gradient_accumulation_steps(self):
        # the per-rank executor runs the whole window in one call
        if getattr(self, "_spmd", False):
            return 1
        return super().gradient_accumulation_steps()

    # ------------------------------------------------------------- per-rank layout
    def _find_spmd_decomposition(self, module):
        """Can the stage partition be read as ``[prefix] + S x (identical
        core blocks) + [suffix]``? Returns ``{"starts", "L", "prefix",
        "suffix"}`` or None (deepspeed_tpu/runtime/pipe/engine.py:258-312):
        matching by layer-spec identity and, at every core position, the
        parameters' names, shapes and dtypes."""
        S = module.num_stages
        parts = module.parts
        counts = [parts[s + 1] - parts[s] for s in range(S)]
        sigs = [_spec_signature(spec) for spec in module._layer_specs]
        keys = module.layer_keys

        def layout(idx):
            layer = module._built_layers[idx]
            return [(n, tuple(p.shape), p.dtype) for n, p in layer.named_parameters()]

        def try_core(L):
            if counts[0] < L or counts[-1] < L:
                return None
            if any(counts[s] != L for s in range(1, S - 1)):
                return None
            starts = [parts[1] - L] + [parts[s] for s in range(1, S)]
            pattern = sigs[starts[0]:starts[0] + L]
            if any(p is None for p in pattern):
                return None
            for s in range(1, S):
                if sigs[starts[s]:starts[s] + L] != pattern:
                    return None
            for j in range(L):
                idxs = [starts[s] + j for s in range(S)]
                if any((keys[i] is None) != (keys[idxs[0]] is None) for i in idxs):
                    return None
                if keys[idxs[0]] is not None and any(layout(i) != layout(idxs[0])
                                                     for i in idxs):
                    return None
            return starts

        candidates = [counts[1]] if S > 2 else range(min(counts), 0, -1)
        for L in candidates:
            starts = try_core(L)
            if starts is not None:
                return {"starts": starts, "L": L,
                        "prefix": list(range(0, parts[1] - L)),
                        "suffix": list(range(parts[S - 1] + L, parts[S]))}
        return None

    def _export_leaf(self, key, i, full):
        """A core leaf under every stage's key: the pipe group's copies of it
        gathered (every rank joins)."""
        if not self._spmd or i not in self._stage_ckpt_keys:
            return super()._export_leaf(key, i, full)
        own, per_stage = self._stage_ckpt_keys[i]
        pre = key[:len(key) - len(own)]
        parts = all_gather_cat(full[None], 0, self._tp_group)
        return [(pre + k, parts[s]) for s, k in enumerate(per_stage)]

    def _import_leaf(self, key, i, get):
        if not self._spmd or i not in self._stage_ckpt_keys:
            return super()._import_leaf(key, i, get)
        return get(key, self._shapes[i])

    def canonical_master_params(self) -> Dict[str, np.ndarray]:
        """The float32 master by layer key (the checkpoint representation),
        whichever executor runs."""
        return self._ckpt_export("master")

    # ------------------------------------------------------------- blocked base API
    def forward(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    def backward(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    def step(self, *args, **kwargs):
        raise PipelineError("Only train_batch() is accessible in pipeline mode.")

    # ------------------------------------------------------------- stage functions
    def _stage_forward(self, s, x):
        """Stage ``s``'s layers on x; with ``activation_checkpoint_interval``
        each run of that many layers recomputes in the backward."""
        pm = self.pipe_module
        lo, hi = pm.parts[s], pm.parts[s + 1]
        interval = pm.activation_checkpoint_interval

        def run(start, end, h):
            for idx in range(start, end):
                h = pm.apply_layer(idx, h)
            return h

        if interval and interval > 0 and torch.is_grad_enabled():
            from ..activation_checkpointing.checkpointing import checkpoint_wrapper
            for start in range(lo, hi, interval):
                x = checkpoint_wrapper(run)(start, min(start + interval, hi), x)
            return x
        return run(lo, hi, x)

    def _stage_backward(self, s, x, g=None, labels=None, rng=None):
        """Recompute stage ``s`` on x with a graph (on ``rng``, the random
        state of the ForwardPass it repeats) and differentiate it: against
        ``g`` (the output's gradient), or, at the last stage, the loss
        scaled by the window's factor. Returns (loss or None, the stage's
        leaf grads {engine index: grad}, the input's grad)."""
        leaves = self._stage_leaves[s]
        params = [self._params[i] for i in leaves]
        draws = rng.replay() if rng is not None else contextlib.nullcontext()
        with torch.enable_grad(), self._gather_scope(), draws:
            xg = x.detach().requires_grad_(s > 0 and x.is_floating_point())
            y = self._stage_forward(s, xg)
            loss = None
            if g is None:
                loss = self.pipe_module.loss_fn(y, labels)
                y, g = self._scaled(loss), torch.ones((), dtype=torch.float32,
                                                      device=loss.device)
            wrt = params + ([xg] if xg.requires_grad else [])
            grads = vjp(y, wrt, g) if wrt else ()
        dparams = {i: gr for i, gr in zip(leaves, grads) if gr is not None}
        dx = grads[len(params)] if xg.requires_grad else None
        return (None if loss is None else loss.detach()), dparams, dx

    # ------------------------------------------------------------- lint / memory
    def lint_programs(self, sample_batch):
        """The per-rank executor: the base engine's programs. The instruction
        executor: each stage's forward and backward, local programs (no
        collective), chained so that a stage's input is the previous
        stage's output."""
        if self._spmd:
            return super().lint_programs(sample_batch)
        from ...utils.op_record import dtype_name
        man = {"compute_dtype": dtype_name(self.compute_dtype), "strict": True,
               "any_reduction": {"max": 0}, "collectives": {},
               "donation": {"check_unusable": True}}
        batch = tuple(self._to_device(b) for b in sample_batch)
        x, labels = batch[0], (batch[1] if len(batch) > 1 else None)
        progs = []
        for s in range(self.num_stages):
            last = s == self.num_stages - 1
            with torch.no_grad(), self._gather_scope():
                y = self._stage_forward(s, x)

            def fwd(xx, _s=s):
                with torch.no_grad(), self._gather_scope():
                    return self._stage_forward(_s, xx)

            progs.append((f"stage{s}_fwd", fwd, (x,), dict(man)))
            if last and self.pipe_module.loss_fn is not None and labels is not None:
                def last_bwd(xx, lab, _s=s):
                    loss, dparams, dx = self._stage_backward(_s, xx, labels=lab)
                    return loss, dparams, dx
                progs.append((f"stage{s}_last_bwd", last_bwd, (x, labels), dict(man)))
            else:
                def bwd(xx, gg, _s=s):
                    _, dparams, dx = self._stage_backward(_s, xx, gg)
                    return dparams, dx
                progs.append((f"stage{s}_bwd", bwd, (x, torch.ones_like(y)), dict(man)))
            x = y
        return progs

    def memory_manifest(self):
        """The base engine's classes and geometry (the instruction executor
        holds every stage on this device; the per-rank executor its
        stage's slices), with the stage count and the largest stage's
        parameter bytes in the geometry."""
        manifest = super().memory_manifest()
        if not self._spmd:
            sizes = [sum(self._params[i].numel() * self._params[i].element_size()
                         for i in leaves) for leaves in self._stage_leaves]
            manifest["geometry"]["stage_param_bytes_max"] = max(sizes, default=0)
        manifest["geometry"]["num_stages"] = int(self.num_stages)
        return manifest

    # ------------------------------------------------------------- train / eval
    def _next_micro_batch(self, data_iter):
        batch = next(data_iter)
        if isinstance(batch, (tuple, list)):
            return tuple(self._to_device(b) for b in batch)
        return (self._to_device(batch),)

    def _stack_window(self, data_iter):
        """The window's micro-batches stacked on a leading M axis."""
        xs, ys = [], []
        for _ in range(self.micro_batches):
            batch = next(data_iter)
            if not (isinstance(batch, (tuple, list)) and len(batch) >= 2):
                raise PipelineError(
                    "the per-rank pipeline expects (inputs, labels) batches; pass "
                    '{"pipeline": {"spmd": false}} for the instruction executor')
            xs.append(self._to_device(torch.as_tensor(batch[0])))
            ys.append(self._to_device(torch.as_tensor(batch[1])))
        return torch.stack(xs), torch.stack(ys)

    def _data_iter(self, data_iter):
        if data_iter is not None:
            return data_iter
        if self.training_dataloader is None:
            raise PipelineError("train_batch() requires a data iterator or training_data")
        if not hasattr(self, "_repeating_iter"):
            from ..dataloader import RepeatingLoader
            self._repeating_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._repeating_iter

    def _train_batch_spmd(self, data_iter):
        """One optimizer step: the whole window in one ``pipeline_apply``
        call through the base engine's forward, backward and step."""
        x, y = self._stack_window(data_iter)
        loss = DeepSpeedEngine.forward(self, x, y)
        DeepSpeedEngine.backward(self, loss)
        DeepSpeedEngine.step(self)
        self.agg_train_loss = loss.detach()
        return self.agg_train_loss

    def train_batch(self, data_iter=None):
        """One window of micro-batches to an optimizer step: the per-rank
        executor when routed there, else the 1F1B instruction stream."""
        data_iter = self._data_iter(data_iter)
        if self._spmd:
            return self._train_batch_spmd(data_iter)
        if self.telemetry is not None:
            self.telemetry.on_step_begin(self.global_steps)
            if self._cluster is not None:
                self._cluster.on_step_begin(self.global_steps)
        self._goodput_close_init()
        tracer = self.pipe_trace
        mb = self.micro_batches
        S = self.num_stages
        scheds = [schedule.TrainSchedule(micro_batches=mb, stages=S, stage_id=s)
                  for s in range(S)]
        streams = [list(iter(sc)) for sc in scheds]
        ring_size = [sc.num_pipe_buffers() for sc in scheds]

        act_in = [dict() for _ in range(S)]    # stage -> buffer_id -> input activation
        act_out = [dict() for _ in range(S)]   # stage -> buffer_id -> (mb, output)
        dx_buf = [dict() for _ in range(S)]    # stage -> buffer_id -> (mb, input grad)
        grad_in = [dict() for _ in range(S)]   # stage -> buffer_id -> received output grad
        # channels keyed by (sending stage, micro-batch id): adjacent stages'
        # buffer rings differ in size, so buffer ids do not line up
        chan_act, chan_grad = {}, {}
        in_mb = [dict() for _ in range(S)]     # stage -> buffer_id -> micro-batch id
        labels_by_mb = {}
        fwd_count = [0] * S
        recv_act_count = [0] * S
        recv_grad_count = [0] * S
        micro_losses = []
        acc: Dict[int, torch.Tensor] = {}
        step_out = {}
        breakdown = self.wall_clock_breakdown()
        if breakdown:
            self.timers("train_batch").start()

        def exec_cmd(s, cmd):
            if isinstance(cmd, schedule.LoadMicroBatch):
                if s == 0:
                    batch = self._next_micro_batch(data_iter)
                    act_in[0][cmd.buffer_id] = batch[0]
                    in_mb[0][cmd.buffer_id] = fwd_count[0]
                    labels_by_mb[fwd_count[0]] = batch[1] if len(batch) > 1 else None
            elif isinstance(cmd, schedule.ForwardPass):
                x = act_in[s].pop(cmd.buffer_id)
                mb_id = in_mb[s][cmd.buffer_id]
                # the input and the random state, for the BackwardPass's recompute
                act_in[s][("saved", cmd.buffer_id)] = (x, RngState(self.device))
                if s < S - 1 or self.pipe_module.loss_fn is None:
                    with torch.no_grad(), self._gather_scope():
                        act_out[s][cmd.buffer_id] = (mb_id, self._stage_forward(s, x))
                fwd_count[s] += 1
            elif isinstance(cmd, schedule.SendActivation):
                mb_id, payload = act_out[s].pop(cmd.buffer_id)
                chan_act[(s, mb_id)] = payload
                _assert_ring_bound(chan_act, s, ring_size[s + 1], "activation")
            elif isinstance(cmd, schedule.RecvActivation):
                mb_id = recv_act_count[s]
                recv_act_count[s] += 1
                act_in[s][cmd.buffer_id] = chan_act.pop((s - 1, mb_id))
                in_mb[s][cmd.buffer_id] = mb_id
            elif isinstance(cmd, schedule.BackwardPass):
                x, rng = act_in[s].pop(("saved", cmd.buffer_id))
                mb_id = in_mb[s].pop(cmd.buffer_id)
                if s == S - 1 and self.pipe_module.loss_fn is not None:
                    loss, dparams, dx = self._stage_backward(s, x, labels=labels_by_mb[mb_id],
                                                             rng=rng)
                    micro_losses.append(loss)
                else:
                    loss, dparams, dx = self._stage_backward(s, x, grad_in[s].pop(cmd.buffer_id),
                                                             rng=rng)
                for i, gr in dparams.items():
                    # tied leaves: every stage's share adds in
                    if i in acc:
                        acc[i].add_(gr.to(self._acc_dtype))
                    else:
                        acc[i] = gr.to(self._acc_dtype)
                if s > 0:
                    dx_buf[s][cmd.buffer_id] = (mb_id, dx)
            elif isinstance(cmd, schedule.SendGrad):
                mb_id, payload = dx_buf[s].pop(cmd.buffer_id)
                chan_grad[(s, mb_id)] = payload
                _assert_ring_bound(chan_grad, s, ring_size[s - 1], "grad")
            elif isinstance(cmd, schedule.RecvGrad):
                mb_id = recv_grad_count[s]
                recv_grad_count[s] += 1
                grad_in[s][cmd.buffer_id] = chan_grad.pop((s + 1, mb_id))
            elif isinstance(cmd, (schedule.ReduceTiedGrads, schedule.ReduceGrads)):
                pass    # tied grads summed in the accumulator; data reduce at the step
            elif isinstance(cmd, schedule.OptimizerStep):
                if s == 0:
                    step_out["overflow"] = self._pipeline_optimizer_step(acc)

        def timed_exec(s, cmd):
            name = _TIMER_BY_CMD.get(type(cmd)) if breakdown else None
            if name is None:
                exec_cmd(s, cmd)
                return
            self.timers(name).start()
            exec_cmd(s, cmd)
            self.timers(name).stop()

        def trace_mb(s, cmd):
            # micro-batch attribution from the live buffer state, read before
            # exec_cmd mutates it
            if isinstance(cmd, schedule.LoadMicroBatch):
                return fwd_count[s]
            if isinstance(cmd, (schedule.ForwardPass, schedule.BackwardPass)):
                return in_mb[s].get(cmd.buffer_id)
            if isinstance(cmd, schedule.SendActivation):
                return (act_out[s].get(cmd.buffer_id) or (None,))[0]
            if isinstance(cmd, schedule.SendGrad):
                return (dx_buf[s].get(cmd.buffer_id) or (None,))[0]
            if isinstance(cmd, schedule.RecvActivation):
                return recv_act_count[s]
            if isinstance(cmd, schedule.RecvGrad):
                return recv_grad_count[s]
            return None

        def traced_exec(s, cmd, step_id):
            if tracer is None:
                timed_exec(s, cmd)
                return
            mb_id = trace_mb(s, cmd)
            t0 = time.perf_counter()
            timed_exec(s, cmd)
            tracer.record(s, step_id, cmd.name, mb_id,
                          getattr(cmd, "buffer_id", None), t0, time.perf_counter())

        if tracer is not None:
            tracer.begin_step(self.global_steps, "TrainSchedule", mb)
        self._run_streams(streams, traced_exec)
        goodput = tracer.end_step() if tracer is not None else None

        self.agg_train_loss = torch.mean(torch.stack(micro_losses)) if micro_losses else None
        self.micro_steps += mb
        self._window_losses = list(micro_losses)
        if breakdown:
            self.timers("step_microstep").start()
        self._finish_step(step_out.get("overflow", False), schedule_goodput=goodput)
        if breakdown:
            self.timers("train_batch").stop()
            if self.global_steps % self.steps_per_print() == 0:
                # per-instruction wall-clock buckets (reference pipe/engine.py:964-984)
                self.timers.log(_PIPE_TIMERS, reset=True)
        return self.agg_train_loss

    def _log_step_timers(self):
        pass        # train_batch logs the pipeline's buckets

    @staticmethod
    def _run_streams(streams, exec_cmd):
        """Execute per-stage instruction streams merged by step index; within
        one merged step every Send / Load runs before any Recv (the
        reference's blocking p2p rendezvous, serialized). ``exec_cmd`` gets
        the merged step index for the tracer."""
        S = len(streams)
        for step_id in range(len(streams[0])):
            for s in range(S):
                for cmd in streams[s][step_id]:
                    if isinstance(cmd, _SEND_CMDS):
                        exec_cmd(s, cmd, step_id)
            for s in range(S):
                for cmd in streams[s][step_id]:
                    if not isinstance(cmd, _SEND_CMDS):
                        exec_cmd(s, cmd, step_id)

    @torch.no_grad()
    def _pipeline_optimizer_step(self, acc) -> bool:
        """The window's grads (zeros for a leaf no stage reached) averaged
        over the data group, then the base update (overflow check, unscale,
        norm, clip, optimizer, re-cast, scaler). Returns the overflow."""
        if self.telemetry is not None:
            self.telemetry.mark_step_dispatched()
        grads = [acc[i] if i in acc else torch.zeros(p.shape, dtype=self._acc_dtype,
                                                     device=self.device)
                 for i, p in enumerate(self._params)]
        if self.dp_size > 1:
            grads = self._exchange(grads, compress=False)
        overflow, self._last_grad_norm, self._pending_sentinel = self._program(
            "apply_update", self._update)(grads)
        return bool(self.fp16_enabled() and overflow)

    def eval_batch(self, data_iter):
        """Forward-only evaluation: the per-rank executor's window loss without
        a graph, or the ``InferenceSchedule`` stream through the stage
        forwards (its two-buffer ring and even/odd send/recv order)."""
        if self._spmd:
            x, y = self._stack_window(data_iter)
            self._goodput_begin_eval()
            with torch.no_grad():
                loss = self._program("eval_loss", self._fwd)(x, y)
            self._goodput_end_eval()
            return loss
        tracer = self.pipe_trace
        self._goodput_begin_eval()
        mb = self.micro_batches
        S = self.num_stages
        scheds = [schedule.InferenceSchedule(micro_batches=mb, stages=S, stage_id=s)
                  for s in range(S)]
        streams = [list(iter(sc)) for sc in scheds]
        ring_size = [sc.num_pipe_buffers() for sc in scheds]
        act_in = [dict() for _ in range(S)]
        act_out = [dict() for _ in range(S)]
        chan_act = {}
        in_mb = [dict() for _ in range(S)]
        labels_by_mb = {}
        load_count = [0] * S
        recv_act_count = [0] * S
        micro_losses = []

        def exec_cmd(s, cmd):
            if isinstance(cmd, schedule.LoadMicroBatch):
                mb_id = load_count[s]
                load_count[s] += 1
                if s == 0:
                    batch = self._next_micro_batch(data_iter)
                    act_in[0][cmd.buffer_id] = batch[0]
                    in_mb[0][cmd.buffer_id] = mb_id
                    labels_by_mb[mb_id] = batch[1] if len(batch) > 1 else None
            elif isinstance(cmd, schedule.ForwardPass):
                x = act_in[s].pop(cmd.buffer_id)
                mb_id = in_mb[s].pop(cmd.buffer_id)
                with torch.no_grad(), self._gather_scope():
                    out = self._stage_forward(s, x)
                    if s == S - 1 and self.pipe_module.loss_fn is not None:
                        micro_losses.append(self.pipe_module.loss_fn(out, labels_by_mb[mb_id]))
                    elif s == S - 1:
                        micro_losses.append(out)
                    else:
                        act_out[s][cmd.buffer_id] = (mb_id, out)
            elif isinstance(cmd, schedule.SendActivation):
                mb_id, payload = act_out[s].pop(cmd.buffer_id)
                chan_act[(s, mb_id)] = payload
                _assert_ring_bound(chan_act, s, ring_size[s + 1], "activation")
            elif isinstance(cmd, schedule.RecvActivation):
                mb_id = recv_act_count[s]
                recv_act_count[s] += 1
                act_in[s][cmd.buffer_id] = chan_act.pop((s - 1, mb_id))
                in_mb[s][cmd.buffer_id] = mb_id

        def trace_mb(s, cmd):
            if isinstance(cmd, schedule.LoadMicroBatch):
                return load_count[s]
            if isinstance(cmd, schedule.ForwardPass):
                return in_mb[s].get(cmd.buffer_id)
            if isinstance(cmd, schedule.SendActivation):
                return (act_out[s].get(cmd.buffer_id) or (None,))[0]
            if isinstance(cmd, schedule.RecvActivation):
                return recv_act_count[s]
            return None

        def traced_exec(s, cmd, step_id):
            if tracer is None:
                exec_cmd(s, cmd)
                return
            mb_id = trace_mb(s, cmd)
            t0 = time.perf_counter()
            exec_cmd(s, cmd)
            tracer.record(s, step_id, cmd.name, mb_id,
                          getattr(cmd, "buffer_id", None), t0, time.perf_counter())

        if tracer is not None:
            tracer.begin_step(self.global_steps, "InferenceSchedule", mb, kind="eval")
        self._run_streams(streams, traced_exec)
        if tracer is not None:
            tracer.end_step()
        self._goodput_end_eval()
        return torch.mean(torch.stack([torch.as_tensor(v).float() for v in micro_losses]))


def params_from_jax(module: PipelineModule, params: List, device=None) -> Dict[str, torch.Tensor]:
    """The JAX ``PipelineModule.init_params`` list (one tree a layer, None
    for a layer without parameters) -> a name -> float32 tensor dict in the
    port module's canonical names (``layer_N.<path>``, ``tied::KEY.<path>``;
    a tied key's first entry), on ``device`` (the card unless ``"cpu"``)."""
    from torch.utils import _pytree as pytree
    from ...device import resolve_device
    dev = resolve_device(device)
    out = {}
    for key, p in zip(module.layer_keys, params):
        if p is None or key is None or any(n.startswith(key + ".") for n in out):
            continue
        for path, leaf in pytree.tree_flatten_with_path(p)[0]:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[f"{key}.{name}"] = torch.from_numpy(np.array(leaf, np.float32)).to(dev)
    return out
