"""The port's ``parallel/pipe/module.py`` against the JAX package's: the
same layer lists give the same stage boundaries for every partition method
(``parameters`` through ``partition_balanced``), the same stage owners,
topology and grid, and the canonical keys the engines key their
parameters and checkpoints by."""

import pytest
import torch
from torch import nn

from deepspeed_tpu_torch.parallel.pipe import LayerSpec as TLayerSpec
from deepspeed_tpu_torch.parallel.pipe import PipelineModule as TPipelineModule
from deepspeed_tpu_torch.parallel.pipe import TiedLayerSpec as TTiedLayerSpec


# ---- matching layer classes: the JAX ones declare their parameter shapes,
# the torch ones hold parameters of those shapes; the class names are the
# same, for the type:REGEX method
class _JaxLayer:
    def __init__(self, shapes):
        self.shapes = shapes

    def init(self, rng, x):
        return None

    def apply(self, params, x):
        return x

    def param_shapes(self):
        return self.shapes


class _TorchLayer(nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for i, s in enumerate(shapes):
            self.register_parameter(f"p{i}", nn.Parameter(torch.zeros(s)))

    def forward(self, x):
        return x


def _pair(name):
    return (type(name, (_JaxLayer,), {}), type(name, (_TorchLayer,), {}))


Embed, TEmbed = _pair("Embed")
Block, TBlock = _pair("Block")
Head, THead = _pair("Head")

E = 16
# (class name, shapes): an embedding, blocks of two sizes, a head
LAYERS = ([("Embed", [(64, E)])]
          + [("Block", [(E, 4 * E), (4 * E,), (4 * E, E)])] * 5
          + [("Block", [(E, E)])] * 2
          + [("Head", [(E,), (E, 64)])])
CLASSES = {"Embed": (Embed, TEmbed), "Block": (Block, TBlock), "Head": (Head, THead)}


def _modules(layers, stages, method, tied=False):
    from deepspeed_tpu.parallel.pipe import LayerSpec, PipelineModule, TiedLayerSpec
    jspecs, tspecs = [], []
    for i, (cls, shapes) in enumerate(layers):
        jc, tc = CLASSES[cls]
        if tied and cls in ("Embed", "Head"):
            jspecs.append(TiedLayerSpec("emb", jc, [(64, E)]))
            tspecs.append(TTiedLayerSpec("emb", tc, [(64, E)]))
        else:
            jspecs.append(LayerSpec(jc, shapes))
            tspecs.append(TLayerSpec(tc, shapes))
    return (PipelineModule(jspecs, num_stages=stages, partition_method=method),
            TPipelineModule(tspecs, num_stages=stages, partition_method=method))


METHODS = ["uniform", "parameters", "type:Block", "type:embed|head"]


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tied", [False, True])
def test_partition_matches_jax(stages, method, tied):
    jm, tm = _modules(LAYERS, stages, method, tied)
    assert tm.parts == jm.parts
    assert tm.num_layers() == jm.num_layers()
    for s in range(stages):
        assert [type(l).__name__ for l in tm.stage_layers(s)] == \
            [type(l).__name__ for l in jm.stage_layers(s)]
    for idx in range(len(LAYERS)):
        assert tm.stage_owner(idx) == jm.stage_owner(idx)
    with pytest.raises(ValueError):
        tm.stage_owner(len(LAYERS))


def test_partition_balanced_by_parameters():
    # 4 equal layers over 2 stages -> a 2 + 2 split (the JAX package's test)
    layers = [("Block", [(8, 8), (8,)])] * 4
    jm, tm = _modules(layers, 2, "parameters")
    assert tm.parts == jm.parts == [0, 2, 4]


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_topology_and_grid_match_jax(stages):
    jm, tm = _modules(LAYERS, stages, "parameters")
    jt, tt = jm.topology(), tm.topology()
    assert tt.get_axis_names() == jt.get_axis_names()
    assert tt.world_size() == jt.world_size()
    assert [tt.get_coord(r) for r in range(tt.world_size())] == \
        [jt.get_coord(r) for r in range(jt.world_size())]
    jg, tg = jm.mpu(), tm.mpu()
    for name in ("get_stage_id", "get_pipe_parallel_world_size", "get_pipe_parallel_group",
                 "get_data_parallel_world_size", "get_data_parallel_group"):
        assert getattr(tg, name)() == getattr(jg, name)(), name


def test_canonical_keys_and_tied_layers():
    """Each layer registers under the JAX engine's key (layer_N, tied::KEY);
    a tied key is one module, its parameters once."""
    jm, tm = _modules(LAYERS, 2, "parameters", tied=True)
    assert tm.layer_keys[0] == tm.layer_keys[-1] == "tied::emb"
    assert tm.layer_keys[1:-1] == [f"layer_{i}" for i in range(1, len(LAYERS) - 1)]
    assert tm._built_layers[0] is tm._built_layers[-1]
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(set(names))
    assert sorted(tm.params_tree()) == sorted(set(tm.layer_keys))


def test_profile_and_unknown_methods_raise_as_in_jax():
    for method in ("profile", "nonsense"):
        for build in (lambda: _modules(LAYERS, 2, method)[0],
                      lambda: _modules(LAYERS, 2, method)[1]):
            with pytest.raises(NotImplementedError):
                build()
    with pytest.raises(RuntimeError, match="num_stages or topology"):
        TPipelineModule([TLayerSpec(TBlock, [(4,)])])


def test_forward_is_the_whole_model():
    """``forward`` runs every layer in order, and the loss with labels."""
    torch.manual_seed(0)
    lin = [nn.Linear(4, 4) for _ in range(3)]
    tm = TPipelineModule(lin + [torch.tanh], num_stages=2,
                         loss_fn=lambda out, y: torch.mean((out - y) ** 2))
    x = torch.randn(2, 4)
    want = torch.tanh(lin[2](lin[1](lin[0](x))))
    torch.testing.assert_close(tm(x), want)
    torch.testing.assert_close(tm(x, torch.zeros(2, 4)), torch.mean(want ** 2))
    assert tm.layer_keys == ["layer_0", "layer_1", "layer_2", None]
