from .topology import (ProcessTopology, PipeDataParallelTopology, PipeModelDataParallelTopology,
                       PipelineParallelGrid)
from .mesh import Mesh, build_mesh, mesh_from_mpu, DATA_AXIS, MODEL_AXIS, PIPE_AXIS
