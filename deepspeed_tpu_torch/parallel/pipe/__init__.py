from .module import LayerSpec, TiedLayerSpec, PipelineModule
