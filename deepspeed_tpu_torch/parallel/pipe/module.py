"""Declarative pipeline model description (PyTorch port).

Counterpart of ``deepspeed_tpu/parallel/pipe/module.py`` (``LayerSpec`` :22,
``TiedLayerSpec`` :42, ``PipelineModule`` :54). A ``PipelineModule`` is a list
of layer constructors; ``parts`` balances them across stages
(``partition_balanced``, ``runtime/utils.py``). The JAX layers are pure
``init`` / ``apply`` pairs whose parameters live in a per-layer list; here a
layer is an ``nn.Module`` built from its spec (or a bare callable without
parameters), and the module registers each under its canonical key, the JAX
engine's parameter-dict key: ``layer_N`` for layer N, ``tied::KEY`` for every
``TiedLayerSpec`` of one key (one module, built once, its gradient the sum of
its uses). So ``named_parameters()`` reads ``layer_3.w``, ``tied::emb.w``,
and checkpoints key by ``layer_3/w``, as the JAX engine's do.

``forward(*batch)`` runs every layer in order and, given labels and a
``loss_fn``, returns the loss: the whole model on one device, the JAX engine's
``_whole_model_fn``. The pipeline engine (``runtime/pipe/engine.py``) runs
the stages.
"""

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ...runtime.utils import partition_balanced, partition_uniform
from ...utils import logger
from ..topology import PipeDataParallelTopology, PipelineParallelGrid, ProcessTopology


def _call_to_str(base, *args, **kwargs) -> str:
    items = [str(a) for a in args] + [f"{k}={v}" for k, v in kwargs.items()]
    return f"{base}({', '.join(items)})"


class LayerSpec:
    """Delays construction of a layer: stores the class and its arguments,
    builds on demand."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not issubclass(type(typename), type):
            raise RuntimeError("LayerSpec only supports classes (callables built at build())")

    def build(self, log=False):
        if log:
            logger.info(f"Building layer {self.typename.__name__}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        return _call_to_str(self.typename.__name__, *self.module_args, **self.module_kwargs)


class TiedLayerSpec(LayerSpec):
    """A LayerSpec whose module is shared with every other TiedLayerSpec of
    the same key (tied embeddings). ``forward_fn(layer, x)``, when given,
    replaces ``layer(x)`` at this position (the JAX ``forward_fn(layer,
    params, x)``: the parameters are the module's own here)."""

    def __init__(self, key, typename, *module_args, forward_fn=None, tied_weight_attr="embedding",
                 **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def _nest(named) -> Dict:
    """A name -> tensor iterable as the nested dict its dotted names spell."""
    out: Dict = {}
    for name, t in named:
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


class PipelineModule(nn.Module):
    """Declarative layer list -> stage partitioning.

    ``layers`` holds ``LayerSpec`` / ``TiedLayerSpec`` entries (each built
    here into an ``nn.Module``), ``nn.Module`` instances, or bare callables
    without parameters. ``partition_method`` is ``parameters`` (the default:
    balanced by each layer's parameter count, uniform when none has any),
    ``uniform``, or ``type:REGEX`` (balanced over the layers whose class
    name matches); ``profile`` raises, as in the JAX package.
    ``activation_checkpoint_interval`` > 0 recomputes each run of that many
    layers of a stage in its backward. ``seed_layers`` builds layer N under
    ``torch.manual_seed(base_seed + N)``."""

    def __init__(self,
                 layers: Sequence,
                 num_stages: Optional[int] = None,
                 topology: Optional[ProcessTopology] = None,
                 loss_fn: Optional[Callable] = None,
                 seed_layers: bool = False,
                 base_seed: int = 1234,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0):
        super().__init__()
        if num_stages is None and topology is None:
            raise RuntimeError("must provide num_stages or topology")
        self._layer_specs = list(layers)
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self._partition_method = partition_method
        if topology is None:
            topology = PipeDataParallelTopology(num_pp=num_stages, num_dp=1)
        self._topo = topology
        self.num_stages = self._topo.get_dim("pipe")
        self._grid = None

        self.tied_modules: Dict[str, nn.Module] = {}
        self.tied_specs: Dict[str, TiedLayerSpec] = {}
        self._built_layers: List = []
        # each layer's canonical key (None: a layer without parameters)
        self.layer_keys: List[Optional[str]] = []
        for idx, spec in enumerate(self._layer_specs):
            with torch.random.fork_rng(enabled=seed_layers, devices=[]):
                if seed_layers:
                    torch.manual_seed(self.base_seed + idx)
                if isinstance(spec, TiedLayerSpec):
                    if spec.key not in self.tied_modules:
                        self.tied_modules[spec.key] = spec.build()
                        self.tied_specs[spec.key] = spec
                    layer, key = self.tied_modules[spec.key], f"tied::{spec.key}"
                elif isinstance(spec, LayerSpec):
                    layer, key = spec.build(), f"layer_{idx}"
                elif isinstance(spec, nn.Module):
                    layer, key = spec, f"layer_{idx}"
                elif callable(spec):
                    layer, key = spec, None
                else:
                    raise TypeError(f"Layer spec {spec} is not callable or a LayerSpec")
            if isinstance(layer, nn.Module):
                if key not in self._modules:
                    self.add_module(key, layer)
                if not any(True for _ in layer.parameters()):
                    key = None
            self._built_layers.append(layer)
            self.layer_keys.append(key)
        self.parts = self._partition_layers(method=self._partition_method)

    # ---------------- partitioning ----------------
    def _count_layer_params(self) -> List[int]:
        """Each layer's parameter count, for the 'parameters' balancing."""
        return [sum(p.numel() for p in layer.parameters()) if isinstance(layer, nn.Module)
                else 0 for layer in self._built_layers]

    def _partition_layers(self, method="uniform") -> List[int]:
        num_stages = self.num_stages
        num_layers = len(self._built_layers)
        method = method.lower()
        if method == "uniform":
            parts = partition_uniform(num_items=num_layers, num_parts=num_stages)
        elif method == "parameters":
            param_counts = self._count_layer_params()
            if sum(param_counts) == 0:
                parts = partition_uniform(num_items=num_layers, num_parts=num_stages)
            else:
                parts = partition_balanced(weights=param_counts, num_parts=num_stages)
        elif method.startswith("type:"):
            layertype = method.split(":", 1)[1]
            binary_weights = [0] * num_layers
            for idx, layer in enumerate(self._built_layers):
                if re.search(layertype, type(layer).__name__, re.IGNORECASE):
                    binary_weights[idx] = 1
            parts = partition_balanced(weights=binary_weights, num_parts=num_stages)
        elif method == "profile":
            raise NotImplementedError("Partitioning method 'profile' not implemented")
        else:
            raise NotImplementedError(f"Partitioning method {method} not implemented")
        return parts

    def stage_layers(self, stage_id: int) -> List:
        return self._built_layers[self.parts[stage_id]:self.parts[stage_id + 1]]

    def stage_owner(self, layer_idx: int) -> int:
        for stage in range(self.num_stages):
            if self.parts[stage] <= layer_idx < self.parts[stage + 1]:
                return stage
        raise ValueError(f"layer {layer_idx} out of range")

    def topology(self) -> ProcessTopology:
        return self._topo

    def mpu(self) -> PipelineParallelGrid:
        """The grid of the topology, seen from rank 0 (the JAX module's);
        built at first call, so that making a module creates no process
        group."""
        if self._grid is None:
            self._grid = PipelineParallelGrid(topology=self._topo, global_rank=0)
        return self._grid

    def num_layers(self) -> int:
        return len(self._built_layers)

    # ---------------- execution ----------------
    def apply_layer(self, idx: int, x):
        """Layer ``idx`` on ``x`` (a tied position through its ``forward_fn``)."""
        spec = self._layer_specs[idx]
        layer = self._built_layers[idx]
        if isinstance(spec, TiedLayerSpec) and spec.forward_fn is not None:
            return spec.forward_fn(layer, x)
        return layer(x)

    def forward(self, *batch):
        """Every layer in order on ``batch[0]``; with labels (``batch[1]``) and
        a ``loss_fn``, the loss."""
        x = batch[0]
        for idx in range(self.num_layers()):
            x = self.apply_layer(idx, x)
        if self.loss_fn is not None and len(batch) > 1:
            return self.loss_fn(x, batch[1])
        return x

    def params_tree(self) -> Dict:
        """The JAX engine's canonical parameter dict over this module's own
        parameters: ``{"layer_N" | "tied::KEY": the layer's nested dict}``."""
        return _nest(self.named_parameters())
