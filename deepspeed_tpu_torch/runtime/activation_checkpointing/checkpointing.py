"""Activation checkpointing (rematerialisation): the configuration layer, the
remat policies and the RNG API.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``.
Each JAX mechanism has a PyTorch one:

- recompute in the backward -> ``torch.utils.checkpoint.checkpoint``
  (non-reentrant); the region's inputs are what it keeps (full remat);
- a named policy -> selective checkpointing
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``): a policy
  that decides for each op reaching the dispatcher whether its outputs are
  kept (``MUST_SAVE``) or recomputed, as a JAX policy decides per primitive;
- ``cpu_checkpointing`` -> full remat with the region's inputs saved in pinned
  host memory (``torch.autograd.graph.save_on_cpu``); it overrides the policy,
  as the JAX offload policy does;
- ``partition_activations`` -> over a model axis of more than one rank, each
  floating input of a region (a block input, replicated across the model
  group) is kept as this rank's 1/tp slice along its largest divisible dim
  (the JAX constraint's rule) and all-gathered over the model group inside
  the region, so the recompute gathers it again; its gradient, the same on
  every rank of the group, is rebuilt whole by an all-gather of the slices.
  The region's saved input is the slice whatever mechanism torch's
  checkpoint keeps its inputs by (the reference's partitioned save,
  checkpointing.py:265-311). A no-op while the model axis is 1, as the JAX
  constraint returns its input there. The mesh is a ``parallel.mesh.Mesh``
  (``configure(mpu_=grid)`` takes the grid's, the engine publishes its own;
  a mapping of axis name -> size becomes a ``Mesh`` with no groups, over
  which a model axis above 1 raises);
- ``profile`` -> a ``torch.profiler.record_function`` range;
- ``contiguous_memory_optimization``, ``number_checkpoints``, ``synchronize``
  -> accepted and stored.

What the policies see. ``"dots"`` saves the products without batch dims
(``aten.mm`` / ``aten.addmm``: what ``dots_with_no_batch_dims_saveable``
saves); ``bmm``, ``baddbmm`` and every other op are recomputed. The names
``attn_out`` and ``attn_lse`` are the flash forward op's two outputs
(``ops/flash_attention.py``: a custom op, so the dispatcher shows it) and any
tensor tagged by ``checkpoint_name`` inside a region whose policy saves that
name (the tag is then an identity op the policy can save). The announcements
``ds_dot:qkv`` / ``ds_dot:proj`` / ``ds_dot:mlp_proj`` go to the region's
policy without an op: the next product whose left operand has the announced
rows is the one announced. JAX keeps a saveable value only where the backward
reads it, and torch's selective checkpoint keeps every output its policy
saves; so a model announces its block's last product (``ds_dot:mlp_proj``:
the MLP's second product, which only the residual sum leaving the block
reads) and no policy keeps it.

Randomness: a replay must draw what the first run drew. The region runs its
function again with the same arguments, and ``preserve_rng_state`` restores
the default generators only, so a caller with an explicit
``torch.Generator`` draws from it outside the region and hands the draws in
(``models/gpt2.py`` does).
"""

import functools
import threading
from typing import Optional

import torch
from torch.utils import checkpoint as _torch_checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ...ops import flash_attention as _flash
from ...parallel.mesh import Mesh, all_gather_cat, fold_tp_seed, gather_from_group, mesh_from_mpu
from ...parallel.topology import PipeModelDataParallelTopology
from ...utils import logger

_ATTN_NAMES = frozenset({"attn_out", "attn_lse"})
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

# module-level config, set by configure() (the JAX module's, and the
# reference's checkpointing.py:654-700)
_config = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,
    "number_checkpoints": None,
    "synchronize": False,
    "profile": False,
    "model_axis": "model",
    "mesh": None,
    "mesh_explicit": False,
    "configured": False,
}

# the policies of the regions now running on this thread, innermost last
# (None for a region without one; a recompute runs on the autograd engine's
# thread)
_regions = threading.local()


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None, mesh=None, model_axis: Optional[str] = None):
    """Configure the module from a ``DeepSpeedConfig`` (its
    ``activation_checkpointing`` block) and/or explicit flags. ``mesh`` is a
    ``parallel.mesh.Mesh`` or a mapping of axis name -> size; ``mpu_`` (a
    ``PipelineParallelGrid``) gives its mesh, with the model group."""
    if deepspeed_config is not None:
        ac = deepspeed_config.activation_checkpointing_config
        _config["partition_activations"] = ac.partition_activations
        _config["cpu_checkpointing"] = ac.cpu_checkpointing
        _config["contiguous_memory_optimization"] = ac.contiguous_memory_optimization
        _config["number_checkpoints"] = ac.number_checkpoints
        _config["synchronize"] = ac.synchronize_checkpoint_boundary
        _config["profile"] = ac.profile
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize", synchronize),
                     ("profile", profile)):
        if val is not None:
            _config[key] = val
    if mesh is None and mpu_ is not None:
        mesh = mesh_from_mpu(mpu_)
    if mesh is not None:
        _config["mesh"] = _own(mesh)
        _config["mesh_explicit"] = True
    if model_axis is not None:
        _config["model_axis"] = model_axis
    _config["configured"] = True
    logger.info(f"[deepspeed_tpu_torch] activation checkpointing configured: "
                f"partition={_config['partition_activations']} "
                f"cpu={_config['cpu_checkpointing']} num={_config['number_checkpoints']}")


def set_default_mesh(mesh, model_axis: Optional[str] = None):
    """Publish the engine's mesh without setting any flag
    or marking the module configured; a mesh given to ``configure`` wins."""
    if not _config["mesh_explicit"]:
        _config["mesh"] = None if mesh is None else _own(mesh)
        if model_axis is not None:
            _config["model_axis"] = model_axis


def is_configured() -> bool:
    return _config["configured"]


def cpu_checkpointing_enabled() -> bool:
    return bool(_config["cpu_checkpointing"])


def reset():
    """Restore the defaults."""
    _config.update(partition_activations=False, cpu_checkpointing=False,
                   contiguous_memory_optimization=False, number_checkpoints=None,
                   synchronize=False, profile=False, mesh=None, model_axis="model",
                   configured=False, mesh_explicit=False)


def _own(mesh):
    """A ``Mesh`` as it is; a mapping of axis sizes as a ``Mesh`` of those
    sizes without process groups."""
    if isinstance(mesh, Mesh):
        return mesh
    topo = PipeModelDataParallelTopology(num_pp=mesh.get("pipe", 1), num_mp=mesh.get("model", 1),
                                         num_dp=mesh.get("data", 1))
    return Mesh(topo, 0)


def _mesh_size(mesh, axis):
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def _partition_plan(x):
    """(dim, group, size) along which a region input is kept as this rank's
    slice, or None: no model axis above 1, a 0-d input, or no dim divisible
    by it (the JAX constraint's rule: the largest divisible dim)."""
    mesh, axis = _config["mesh"], _config["model_axis"]
    size = _mesh_size(mesh, axis)
    if size <= 1 or x.dim() == 0:
        return None
    if mesh.group(axis) is None:
        raise ValueError(
            f"partition_activations over a model axis of {size} needs the model group: "
            "configure(mpu_=grid) or mesh=Mesh (an engine with mpu publishes its mesh)")
    for dim in sorted(range(x.dim()), key=lambda d: -x.shape[d]):
        if x.shape[dim] % size == 0:
            return dim, mesh.group(axis), size
    return None


class _KeepSlice(torch.autograd.Function):
    """This rank's slice of a replicated tensor; backward, the gradient
    (replicated) rebuilt whole from every rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // size
        return x.narrow(dim, torch.distributed.get_rank(group) * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.dim, ctx.group), None, None, None


def _partition(args):
    """The region's inputs with each replicated floating tensor cut to this
    rank's slice; and the plans that gather them back."""
    out, plans = [], []
    for a in args:
        plan = (_partition_plan(a) if torch.is_tensor(a) and a.is_floating_point()
                else None)
        plans.append(plan)
        out.append(a if plan is None else _KeepSlice.apply(a, *plan))
    return out, plans


def _unpartition(args, plans):
    return [a if plan is None else gather_from_group(a, plan[0], plan[1])
            for a, plan in zip(args, plans)]


# ---------------------------------------------------------------------------
# tags
# ---------------------------------------------------------------------------

@torch.library.custom_op("deepspeed_tpu_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    # an op's output may not alias its input: a copy the policy can keep
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))
_TAG = torch.ops.deepspeed_tpu_torch.checkpoint_name.default


def _stack():
    if not hasattr(_regions, "stack"):
        _regions.stack = []
    return _regions.stack


def checkpoint_name(x, name: str):
    """``jax.ad_checkpoint.checkpoint_name``: tag ``x`` for the policy of the
    region it runs in. ``ds_dot:<class>`` announces the next product whose
    left operand has x's rows; another name becomes an identity op the
    policy can save, where the policy saves that name. Outside a region, or
    where the policy reads no such name, ``x`` is returned as it is."""
    stack = _stack()
    policy = stack[-1] if stack else None
    if policy is None:
        return x
    if name.startswith("ds_dot:"):
        policy.announce(name.split(":", 2)[1], _rows(x))
        return x
    return _named(x, name) if policy.reads(name) else x


def _rows(t):
    """(rows, width) of t taken as a matrix over its last dim."""
    width = t.shape[-1] if t.dim() else 1
    return (t.numel() // max(width, 1), width)


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

class _Policy:
    """A selective-checkpoint policy: ``policy(ctx, op, *args, **kwargs)``
    says whether op's outputs are kept for the backward. Built once per
    region call; ``begin`` runs at the start of the forward and of the
    recompute (the announcements arrive in both, and torch may ask the
    policy in both)."""

    def __init__(self, dots=False, names=frozenset()):
        self.dots = dots
        self.names = names
        self.begin()

    def begin(self):
        self.tagged = False
        self.pending = []

    def reads(self, name) -> bool:
        return name in self.names

    def announce(self, cls, rows):
        self.tagged = True
        self.pending.append((cls, rows))

    def _announced(self, lhs):
        """The class announced for this product (its left operand has the
        first pending announcement's rows), or None."""
        if self.pending and self.pending[0][1] == _rows(lhs):
            return self.pending.pop(0)[0]
        return None

    def product(self, lhs, rhs, cls) -> bool:
        return self.dots

    def saves(self, op, args) -> bool:
        if op is _TAG:
            return args[1] in self.names
        if op is _flash.FLASH_FWD_OP:
            return bool(self.names & _ATTN_NAMES)
        if op in _PRODUCTS:
            lhs, rhs = args[-2], args[-1]
            cls = self._announced(lhs)
            # the block's last product: no backward reads its output
            return cls != "mlp_proj" and self.product(lhs, rhs, cls)
        return False

    def __call__(self, ctx, op, *args, **kwargs):
        return _SAVE if self.saves(op, args) else _RECOMPUTE


_SAVE, _RECOMPUTE = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE


class _FlashPolicy(_Policy):
    """Replay-free attention policies (JAX ``_flash_policy``): the flash
    op's (out, lse) and the named attention output kept, every product
    kept except one class: ``exclude="qkv"`` (policy ``"flash"``) drops the
    fused-qkv product (rhs ``[E, 3E]``); ``exclude="square"`` with
    ``keep_qkv`` (``"dots+attn-lean"``) drops the square output projection
    (rhs ``[E, E]``), whose replay is one product from the kept attention
    output.

    Tag first: once a ``ds_dot`` announcement is seen in a run, only
    announced products may be dropped. A model that announces nothing is
    classified by rhs width, which is sound only while each width signature
    is unique among its products: a second distinct shape in one dropped
    class, or a square width other than the qkv-implied embed width, raises
    ``ValueError`` instead of dropping the wrong save."""

    def __init__(self, exclude="qkv", keep_qkv=False):
        super().__init__(dots=True, names=_ATTN_NAMES)
        self.exclude = exclude
        self.keep_qkv = keep_qkv
        self.seen = {"qkv": set(), "square": set()}

    def _record(self, cls, shape, excluding):
        seen = self.seen
        seen[cls].add(shape)
        if excluding and len(seen[cls]) > 1:
            raise ValueError(
                f"remat policy width-signature collision: {sorted(seen[cls])} both "
                f"classify as the '{cls}' exclusion — the shape heuristic cannot "
                f"tell them apart, so one would silently lose its save. Pass an "
                f"explicit selective-checkpoint policy callable (or use 'dots+attn') "
                f"for this model.")
        if self.exclude == "square" and seen["qkv"] and seen["square"]:
            e_widths = {c for c, _ in seen["qkv"]}
            for e_sq, _ in seen["square"]:
                if e_sq not in e_widths:
                    raise ValueError(
                        f"remat policy width-signature collision: square dot "
                        f"[{e_sq}, {e_sq}] does not match the fused-qkv embed "
                        f"width(s) {sorted(e_widths)}, so it is not the attention "
                        f"output projection (an MoE/router square?) and would "
                        f"silently lose its save. Pass an explicit selective-checkpoint "
                        f"policy callable (or use 'dots+attn') for this model.")

    def product(self, lhs, rhs, cls) -> bool:
        if self.tagged:
            if cls == "qkv" and not self.keep_qkv:
                return False        # fused-qkv projection: recompute
            if cls == "proj" and self.exclude == "square":
                return False        # output projection: recompute from attn_out
            return True
        contracted, out_w = rhs.shape
        if out_w == 3 * contracted:
            self._record("qkv", (contracted, out_w), excluding=not self.keep_qkv)
            if not self.keep_qkv:
                return False
        if self.exclude == "square" and out_w == contracted:
            self._record("square", (contracted, out_w), excluding=True)
            return False
        return True


class _CallablePolicy(_Policy):
    """A caller's selective-checkpoint policy ``fn(ctx, op, *args,
    **kwargs)`` (a ``CheckpointPolicy`` or a bool); every name is tagged
    for it, and an announced last product is recomputed whatever it says."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def reads(self, name) -> bool:
        return True

    def __call__(self, ctx, op, *args, **kwargs):
        if op in _PRODUCTS and self._announced(args[-2]) == "mlp_proj":
            return _RECOMPUTE
        decision = self.fn(ctx, op, *args, **kwargs)
        if isinstance(decision, bool):
            return _SAVE if decision else _RECOMPUTE
        return decision


def named_policy(policy):
    """A fresh policy object for ``policy`` (a name, a callable, or None for
    full remat, which is None here too); ``ValueError`` for an unknown name."""
    if policy is None:
        return None
    if callable(policy):
        return _CallablePolicy(policy)
    if policy == "dots":
        return _Policy(dots=True)
    if policy == "attn":
        # the attention outputs only: the backward skips the forward
        # kernel's replay for one [B, T, E] + one [B, H, T] a layer
        return _Policy(names=_ATTN_NAMES)
    if policy == "dots+attn":
        # products and the flash op's (out, lse): the backward replays only
        # elementwise ops, and no attention kernel
        return _Policy(dots=True, names=_ATTN_NAMES)
    if policy == "flash":
        return _FlashPolicy()
    if policy == "dots+attn-lean":
        return _FlashPolicy(exclude="square", keep_qkv=True)
    raise ValueError(f"unknown remat policy {policy!r}: expected None, 'dots', "
                     f"'attn', 'dots+attn', 'dots+attn-lean', 'flash', or a "
                     f"selective-checkpoint policy callable")


def checkpoint_wrapper(fn, policy=None):
    """Wrap ``fn(*args)`` so that its forward is recomputed in the backward,
    keeping what ``policy`` names: None keeps only the inputs (full remat);
    ``"dots"`` also the products without batch dims, so the backward
    replays only elementwise ops and the attention kernels; ``"attn"``,
    ``"dots+attn"``, ``"flash"``, ``"dots+attn-lean"`` as the module notes
    say; a callable is a selective-checkpoint policy. A configured
    ``cpu_checkpointing`` overrides ``policy``: full remat, the inputs in
    pinned host memory."""

    @functools.wraps(fn)
    def inner(*args):
        offload = _config["cpu_checkpointing"]
        pol = None if offload else named_policy(policy)

        args_ = args
        plans = None
        if _config["partition_activations"]:
            args_, plans = _partition(args)

        def placed(*inner_args):
            if plans is not None:
                inner_args = _unpartition(inner_args, plans)
            stack = _stack()
            stack.append(pol)
            if pol is not None:
                pol.begin()
            try:
                return fn(*inner_args)
            finally:
                stack.pop()

        def run():
            if offload:
                with torch.autograd.graph.save_on_cpu(pin_memory=True):
                    return _torch_checkpoint.checkpoint(placed, *args_, use_reentrant=False)
            kw = {}
            if pol is not None:
                kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, pol)
            return _torch_checkpoint.checkpoint(placed, *args_, use_reentrant=False, **kw)

        if _config["profile"]:
            with torch.profiler.record_function("ds_activation_checkpoint"):
                return run()
        return run()

    return inner


def checkpoint(function, *args):
    """Reference-style call: ``checkpoint(run_function, *args)``, full remat."""
    return checkpoint_wrapper(function)(*args)


# ---------------------------------------------------------------------------
# RNG API (the reference's CudaRNGStatesTracker, checkpointing.py:147-262)
# ---------------------------------------------------------------------------

class RNGTracker:
    """Named random streams. ``fork(name)`` returns a fresh
    ``torch.Generator`` each call, seeded from the stream, which it then
    advances: the same seeds give the same sequence of generators, so a
    caller that forks outside a checkpointed region and hands the generator's
    draws in replays them exactly."""

    def __init__(self):
        self._states = {}

    def reset(self):
        self._states = {}

    def get_states(self):
        return dict(self._states)

    def set_states(self, states):
        self._states = dict(states)

    def add(self, name: str, seed: int):
        if name in self._states:
            raise ValueError(f"RNG state {name} already exists")
        self._states[name] = int(seed)

    def fork(self, name: str = "model-parallel-rng", device="cpu") -> torch.Generator:
        if name not in self._states:
            raise KeyError(f"RNG state {name} not added")
        step = torch.Generator().manual_seed(self._states[name])
        self._states[name], sub = torch.randint(0, 2**62, (2,), generator=step).tolist()
        return torch.Generator(device=device).manual_seed(sub)


_RNG_TRACKER = RNGTracker()


def get_rng_tracker() -> RNGTracker:
    return _RNG_TRACKER


# reference alias (checkpointing.py:218)
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed: int, axis: Optional[str] = None, device="cpu") -> torch.Generator:
    """The generator of this rank's position on the model axis (dropout must
    differ across tensor-parallel ranks and stay reproducible): the
    configured mesh's model-axis index folded into ``seed``
    (``parallel/mesh.py`` ``fold_tp_seed``, the flash kernels' fold). Without
    a mesh whose axis is above 1 the base stream, as the JAX function
    returns the base key outside a bound axis."""
    mesh = _config["mesh"]
    axis = axis or _config["model_axis"]
    if _mesh_size(mesh, axis) > 1:
        seed = fold_tp_seed(seed, mesh.axis_index(axis)) & 0xFFFFFFFF
    return torch.Generator(device=device).manual_seed(int(seed))


def model_parallel_cuda_manual_seed(seed: int):
    """Seed the tracker's default streams (reference checkpointing.py:223-262)."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718)
    _RNG_TRACKER.add("data-parallel-rng", seed)
