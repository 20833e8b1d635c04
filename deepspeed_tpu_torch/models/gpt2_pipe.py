"""GPT-2 over a pipe group of ranks (PyTorch port).

Counterpart of ``deepspeed_tpu/models/gpt2_pipe.py`` (``GPT2Pipe`` :33). The
decoder stack splits into S equal stages (``n_layer % num_stages == 0``);
the embedding runs before stage 0 and ``ln_f`` + the tied LM head + the loss
after the last stage, through ``parallel/pipeline_spmd.py``'s per-rank
executor. The JAX tree ``{"io": {wte, wpe, ln_f}, "stages": blocks stacked
[S, L/S, ...]}`` is kept, with the tied table padded to a stage multiple of
rows (``vocab_pad``). The module on pipe rank s holds only its parts of it:
``io.wte`` rows [s V/S, (s+1) V/S) (the vocab-parallel embedding and head),
``io.wpe`` and ``io.ln_f`` whole, and ``stages.*`` its stage's slice
``[1, L/S, ...]`` of every stacked leaf; so ``named_parameters()`` reads
``io.wte``, ``stages.attn.c_attn_w`` and checkpoints key as the JAX
engine's do for this tree. The engine treats ``wte`` and the stacked leaves
as split over the pipe axis (``split_axis``, ``tp_axis`` / ``tp_whole`` /
``tp_slice``, the hooks tensor parallelism uses over the model axis).

The blocks run ``GPT2Model._block`` (``models/gpt2.py``), so the flash
kernels run under ``use_flash_attention``. ``_vp_embed`` and
``_vp_head_loss`` are vocab-parallel over the pipe group: the embedding
looks up the local rows and sums over the group (``psum``); the head's
row max is a ``pmax`` without gradient, and the sum of exponentials and the
target logit one ``psum`` of both, padded columns masked at -1e30. ``ln_f``
runs on the last rank before the broadcast (``_final_norm``, the
executor's ``last_stage_pre_fn``), where the JAX head runs it on every
rank after: the same loss, the one-rank model's rounding. With
``tp > 1`` (pipe x model) the constructor raises: ROADMAP.md item 16b.
"""

import dataclasses
from typing import Any, Dict

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..device import resolve_device
from ..parallel.mesh import PIPE_AXIS, all_gather_cat
from ..parallel.pipeline_spmd import pipeline_apply, pmax, psum
from ..runtime.activation_checkpointing.checkpointing import checkpoint_wrapper
from .gpt2 import GPT2Config, GPT2Model, _TP

def _block_shapes(E):
    """A block's leaf shapes by sub-dict (gpt2.py's ``_Block``)."""
    return {"ln_1": {"scale": (E,), "bias": (E,)},
            "attn": {"c_attn_w": (E, 3 * E), "c_attn_b": (3 * E,),
                     "c_proj_w": (E, E), "c_proj_b": (E,)},
            "ln_2": {"scale": (E,), "bias": (E,)},
            "mlp": {"c_fc_w": (E, 4 * E), "c_fc_b": (4 * E,),
                    "c_proj_w": (4 * E, E), "c_proj_b": (E,)}}


class _Group(nn.Module):
    """Parameters named by a nested dict of shapes."""

    def __init__(self, shapes, device):
        super().__init__()
        for k, v in shapes.items():
            if isinstance(v, dict):
                self.add_module(k, _Group(v, device))
            else:
                self.register_parameter(k, nn.Parameter(torch.zeros(v, device=device)))

    def tree(self):
        return {k: (m.tree() if isinstance(m, _Group) else m)
                for k, m in list(self._modules.items()) + list(self._parameters.items())}


class GPT2Pipe(nn.Module):
    """Pipelined GPT-2: this pipe rank's stage of it (see the module
    docstring). ``mesh`` is a ``parallel.mesh.Mesh`` whose pipe axis has
    ``num_stages`` ranks (None: a world of one process, stage 0, for the
    tree functions). ``init``, ``from_dense`` and ``to_dense`` work on the
    whole JAX-shaped trees; ``load_parameters`` takes this rank's part of
    one; ``stacked_tree`` gathers the whole one back over the group."""

    split_axis = PIPE_AXIS

    def __init__(self, config: GPT2Config, num_stages: int, tp: int = 1, mesh=None,
                 device=None):
        super().__init__()
        if tp > 1:
            raise NotImplementedError(
                "GPT2Pipe with tp > 1 (pipe x model) is not in the PyTorch port yet: "
                "ROADMAP.md item 16b")
        assert config.n_layer % num_stages == 0, "n_layer must divide evenly into stages"
        assert config.moe_experts == 0, \
            "MoE blocks do not compose with the pipeline (heterogeneous block trees)"
        if mesh is not None and mesh.shape[PIPE_AXIS] != num_stages:
            raise ValueError(f"the mesh's pipe axis has {mesh.shape[PIPE_AXIS]} ranks, the "
                             f"model {num_stages} stages")
        self.vocab_pad = (config.vocab_size + num_stages - 1) // num_stages * num_stages
        self.config = config
        self.num_stages = num_stages
        self.layers_per_stage = config.n_layer // num_stages
        self.tp = tp
        self.mesh = mesh
        self.stage = mesh.axis_index(PIPE_AXIS) if mesh is not None else 0
        dev = resolve_device(device)
        E, S, LpS = config.n_embd, num_stages, self.layers_per_stage
        self.io = _Group({"wte": (self.vocab_pad // S, E), "wpe": (config.n_positions, E),
                          "ln_f": {"scale": (E,), "bias": (E,)}}, dev)
        self.stages = _Group(pytree.tree_map(lambda s: (1, LpS) + s, _block_shapes(E),
                                             is_leaf=lambda x: isinstance(x, tuple)), dev)
        # the dense model's layers, without its parameters (kept off the
        # module's parameter list)
        self._layers = (GPT2Model(dataclasses.replace(config, vocab_size=1, n_positions=1,
                                                      n_layer=0), device="cpu"),)
        group = mesh.group(PIPE_AXIS) if mesh is not None else None
        self._tp = _TP(S, self.stage, group) if S > 1 else None

    @property
    def group(self):
        return None if self._tp is None else self._tp.group

    # ------------------------------------------------------------- whole trees
    def _stack(self, flat) -> Dict[str, Any]:
        flat = dict(flat)
        if self.vocab_pad != self.config.vocab_size:
            pad = self.vocab_pad - flat["wte"].shape[0]
            flat["wte"] = torch.nn.functional.pad(flat["wte"], (0, 0, 0, pad))
        blocks = flat.pop("blocks")
        stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *blocks)
        S, LpS = self.num_stages, self.layers_per_stage
        stacked = pytree.tree_map(lambda a: a.reshape((S, LpS) + a.shape[1:]), stacked)
        return {"io": flat, "stages": stacked}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """The JAX package's initialization of the dense model (``GPT2Model.
        init``) stacked; this rank's part loaded. Returns the whole tree."""
        dense = GPT2Model(self.config, device=generator.device)
        dense.init(generator)
        tree = self.from_dense(pytree.tree_map(lambda t: t.detach(), dense.params_tree()))
        self.load_parameters(tree)
        return tree

    def from_dense(self, dense_params) -> Dict[str, Any]:
        """The dense ``GPT2Model`` tree (``params_tree()`` or the JAX
        layout) -> the whole stacked tree."""
        return self._stack(dict(dense_params))

    def to_dense(self, params) -> Dict[str, Any]:
        """Invert ``_stack``: the whole stacked tree -> the dense tree, the
        padding rows stripped (load it into ``GPT2Model``, or ``from_dense``
        it at another stage count)."""
        io = dict(params["io"])
        if self.vocab_pad != self.config.vocab_size:
            io["wte"] = io["wte"][: self.config.vocab_size]
        S, LpS = self.num_stages, self.layers_per_stage
        flat_layers = pytree.tree_map(lambda a: a.reshape((S * LpS,) + a.shape[2:]),
                                      params["stages"])
        blocks = [pytree.tree_map(lambda a: a[i], flat_layers) for i in range(S * LpS)]
        return {**io, "blocks": blocks}

    def params_tree(self) -> Dict[str, Any]:
        """This rank's parameters in the JAX tree's structure."""
        return {"io": self.io.tree(), "stages": self.stages.tree()}

    def tp_axis(self, name):
        """The axis of ``name`` split over the pipe group: 0 for the table
        and the stacked leaves, None for wpe and ln_f."""
        return 0 if (name == "io.wte" or name.startswith("stages.")) and self._tp else None

    def tp_slice(self, name, whole):
        """This rank's part of the whole leaf ``name``."""
        if self.tp_axis(name) is None:
            return whole
        n = whole.shape[0] // self.num_stages
        return whole.narrow(0, self.stage * n, n).clone()

    def tp_whole(self, name, local):
        """The whole leaf ``name`` from every pipe rank's part (an all-gather
        over the pipe group, no grad)."""
        if self.tp_axis(name) is None:
            return local
        with torch.no_grad():
            return all_gather_cat(local.detach(), 0, self.group)

    @property
    def tp_size(self) -> int:
        return 1 if self._tp is None else self._tp.size

    @torch.no_grad()
    def load_parameters(self, params) -> None:
        """Copy this rank's part of a whole stacked tree (nested dicts, or a
        name -> tensor dict in ``named_parameters()``'s names)."""
        if "io" in params and isinstance(params["io"], dict):
            flat = {}
            for path, leaf in pytree.tree_flatten_with_path(params)[0]:
                flat[".".join(str(getattr(p, "key", p)) for p in path)] = leaf
            params = flat
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise ValueError(f"parameter names differ: {sorted(set(own) ^ set(params))[:5]}")
        for name, p in own.items():
            t = torch.as_tensor(params[name])
            p.copy_(self.tp_slice(name, t.to(p.device, p.dtype)))

    @torch.no_grad()
    def stacked_tree(self) -> Dict[str, Any]:
        """The whole stacked tree, every pipe rank's part gathered (every rank
        of the group calls it)."""
        flat = {n: self.tp_whole(n, p) for n, p in self.named_parameters()}
        out: Dict[str, Any] = {}
        for name, t in flat.items():
            node = out
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t
        return out

    def param_shardings(self, mesh=None):
        """The layout over the pipe axis, in ``params_tree()``'s structure: the
        table's rows and every stacked leaf's stage axis split
        (``("pipe", None, ...)``), wpe and ln_f replicated (``()``)."""
        stages = pytree.tree_map(lambda s: (PIPE_AXIS,) + (None,) * (len(s) + 1),
                                 _block_shapes(self.config.n_embd),
                                 is_leaf=lambda x: isinstance(x, tuple))
        return {"io": {"wte": (PIPE_AXIS, None), "wpe": (), "ln_f": {"scale": (), "bias": ()}},
                "stages": stages}

    # ------------------------------------------------------------- stage functions
    def _stage_fn(self, stage_params, x):
        """This rank's L/S blocks (``[1, L/S, ...]`` leaves) on x."""
        dense = self._layers[0]
        c = self.config
        blk = checkpoint_wrapper(dense._block, policy=c.remat_policy) if c.remat else dense._block
        for i in range(self.layers_per_stage):
            x = blk(x, pytree.tree_map(lambda a: a[0, i], stage_params))
        return x

    def _vp_embed(self, tokens, io):
        """Vocab-parallel embedding over the pipe group: this rank's rows
        looked up, the others zero, summed over the group; plus wpe."""
        c = self.config
        wte = io["wte"]
        v_local = wte.shape[0]
        local = tokens.long() - self.stage * v_local
        ok = (local >= 0) & (local < v_local)
        emb = wte[local.clamp(0, v_local - 1)].to(c.compute_dtype)
        emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
        emb = psum(emb, self.group)
        T = tokens.shape[-1]
        return emb + io["wpe"][:T].to(c.compute_dtype)

    def _final_norm(self, y, io, labels_mb):
        """ln_f on the last stage's output, widened to float32 (exactly): what
        the last rank broadcasts to the head, so that the head's input
        gradient is summed over the ranks in float32 and rounded once, where
        the one-rank model rounds it."""
        c = self.config
        return self._layers[0]._layer_norm(y, io["ln_f"], c.layer_norm_epsilon).float()

    def _vp_head_loss(self, z, io, labels_mb, mb):
        """Vocab-parallel tied head and cross-entropy over the pipe group for
        micro-batch ``mb``, on every rank against the last stage's normalized
        output ``z`` (``_final_norm``, float32): float32 logits for this
        rank's rows (the one-rank head's product), the padded columns at
        -1e30, the row max over the group without gradient, the sum of
        exponentials and the target logit summed over the group in one
        all-reduce; the mean over the positions."""
        c = self.config
        wte = io["wte"]
        v_local = wte.shape[0]
        labels = labels_mb[mb].long()
        logits = torch.matmul(z, wte.to(c.compute_dtype).float().t())   # [B, T, V/S] f32
        if self.vocab_pad != c.vocab_size:
            col = self.stage * v_local + torch.arange(v_local, device=logits.device)
            logits = torch.where(col < c.vocab_size, logits,
                                 torch.full((), -1e30, device=logits.device))
        m = pmax(logits.max(dim=-1).values, self.group)                  # [B, T]
        local = labels - self.stage * v_local
        ok = (local >= 0) & (local < v_local)
        picked = torch.gather(logits, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
        stats = psum(torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                                  torch.where(ok, picked, torch.zeros_like(picked))]),
                     self.group)
        return torch.mean(m + torch.log(stats[0]) - stats[1])

    # ------------------------------------------------------------- training loss
    def loss(self, tokens_mb, labels_mb, max_microbatches_per_flush=None,
             stream_segments=True):
        """Mean LM loss over [M, B, T] micro-batches through the pipe group
        (the segmentation knobs pass to ``pipeline_apply``)."""
        if self.mesh is None and self.num_stages > 1:
            raise ValueError("GPT2Pipe.loss needs the mesh of its pipe group")
        io = self.io.tree()
        io_specs = {k: ("pipe" if k == "wte" else pytree.tree_map(lambda _: "rep", v))
                    for k, v in io.items()}
        mesh = self.mesh
        if mesh is None:
            from ..parallel.mesh import build_mesh
            mesh = build_mesh()
        return pipeline_apply(
            self._stage_fn, self.stages.tree(), tokens_mb, mesh=mesh,
            first_stage_fn=self._vp_embed, first_stage_args=(io,),
            first_stage_args_specs=(io_specs,),
            last_stage_fn=self._vp_head_loss, last_stage_collective=True,
            last_stage_pre_fn=self._final_norm,
            last_stage_args=(io, labels_mb), last_stage_args_specs=(io_specs, "mb"),
            max_microbatches_per_flush=max_microbatches_per_flush,
            stream_segments=stream_segments)

    def forward(self, tokens_mb, labels_mb):
        return self.loss(tokens_mb, labels_mb)


def params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The JAX ``GPT2Pipe`` tree ``{"io", "stages"}`` (leaves numpy-like)
    -> the same tree of float32 tensors on ``device`` (the card unless
    ``"cpu"``), whole; ``GPT2Pipe.load_parameters`` takes each rank's part."""
    import numpy as np
    dev = resolve_device(device)
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), tree)
