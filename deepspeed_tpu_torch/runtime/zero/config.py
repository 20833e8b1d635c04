"""ZeRO config object (mirrors deepspeed/runtime/zero/config.py: DeepSpeedZeroConfig l.11)."""

from ..config_utils import get_scalar_param
from ...utils import logger
from .constants import *


class DeepSpeedZeroConfig:

    def __init__(self, param_dict):
        self.stage = None
        self.contiguous_gradients = None
        self.reduce_scatter = None
        self.reduce_bucket_size = None
        self.allgather_partitions = None
        self.allgather_bucket_size = None
        self.overlap_comm = None
        self.cpu_offload = None
        self.elastic_checkpoint = None
        self.offload_device = None
        self.offload_pipeline = None
        self.offload_pipeline_depth = None
        self.offload_max_region_elements = None

        user_configured = ZERO_OPTIMIZATION in param_dict
        if user_configured:
            zero_config_dict = param_dict[ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                zero_config_dict = self.read_zero_config_deprecated(param_dict)
        else:
            zero_config_dict = ZERO_OPTIMIZATION_DEFAULT

        self._initialize(zero_config_dict, user_configured)

    def read_zero_config_deprecated(self, param_dict):
        zero_config_dict = {}
        zero_config_dict[ZERO_OPTIMIZATION_STAGE] = 1 if param_dict[ZERO_OPTIMIZATION] else 0
        if (zero_config_dict[ZERO_OPTIMIZATION_STAGE] > 0
                and ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED in param_dict):
            # only when the user actually set the companion key — inserting the
            # default here would trip the explicit-tuning-key warning spuriously
            zero_config_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE] = param_dict[
                ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED]
        logger.warning("DeepSpeedConfig: this format of ZeRO optimization setup is deprecated: '{}'".format(
            ZERO_FORMAT))
        return zero_config_dict

    def _initialize(self, zero_config_dict, user_configured=True):
        # Buffer/bucket tuning keys steer the reference's hand-written collectives
        # (stage2.py bucketed allreduce); XLA/GSPMD schedules collectives here, so
        # they cannot act. Record which ones the user EXPLICITLY set (not the
        # defaults dict) so DeepSpeedConfig can warn instead of silently ignoring.
        _tuning_keys = (ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS, ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                        ZERO_OPTIMIZATION_REDUCE_SCATTER, ZERO_OPTIMIZATION_OVERLAP_COMM,
                        ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS, ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE)
        if user_configured:
            _acting_keys = _tuning_keys + (ZERO_OPTIMIZATION_STAGE, ZERO_OPTIMIZATION_CPU_OFFLOAD,
                                           ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                                           ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER)
            self.explicit_tuning_keys = tuple(k for k in _tuning_keys if k in zero_config_dict)
            self.unknown_keys = tuple(k for k in zero_config_dict if k not in _acting_keys)
        else:
            self.explicit_tuning_keys = self.unknown_keys = ()
        self.stage = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_STAGE, ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.contiguous_gradients = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
                                                     ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                                                   ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT)
        self.reduce_scatter = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_REDUCE_SCATTER,
                                               ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_OVERLAP_COMM,
                                             ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)
        self.allgather_partitions = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
                                                     ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
                                                      ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.cpu_offload = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_CPU_OFFLOAD,
                                            ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.elastic_checkpoint = get_scalar_param(zero_config_dict, ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                                                   ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT)
        self._init_offload_optimizer(zero_config_dict)

    def _init_offload_optimizer(self, zero_config_dict):
        """Parse the ``offload_optimizer`` sub-config (device + host-step pipeline
        knobs). Presence of the block implies ``cpu_offload: true`` — unless the user
        ALSO set ``cpu_offload: false`` explicitly, which wins with a warning (the
        legacy boolean is the enable switch; the block only configures the step)."""
        off = zero_config_dict.get(ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER)
        if off is not None and not isinstance(off, dict):
            raise ValueError(
                f"zero_optimization.{ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER} must be a dict "
                f"of {VALID_OFFLOAD_OPTIMIZER_KEYS}, got {type(off).__name__}")
        user_set = off is not None
        off = off or {}
        for k in off:
            if k not in VALID_OFFLOAD_OPTIMIZER_KEYS:
                # same discipline as DeepSpeedConfig's unknown-key warning: an accepted
                # key must act, warn, or error — never silently no-op
                logger.warning(
                    f"DeepSpeedZeroConfig: unknown {ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER} "
                    f"key '{k}' is IGNORED (valid: {VALID_OFFLOAD_OPTIMIZER_KEYS})")
        self.offload_device = get_scalar_param(off, OFFLOAD_OPTIMIZER_DEVICE,
                                               OFFLOAD_OPTIMIZER_DEVICE_DEFAULT)
        if self.offload_device not in VALID_OFFLOAD_OPTIMIZER_DEVICES:
            raise ValueError(
                f"{ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER}.{OFFLOAD_OPTIMIZER_DEVICE} "
                f"'{self.offload_device}' is not supported: the offload tier is the "
                f"host memory of the GPU machine (valid: {VALID_OFFLOAD_OPTIMIZER_DEVICES})")
        self.offload_pipeline = bool(get_scalar_param(off, OFFLOAD_OPTIMIZER_PIPELINE,
                                                      OFFLOAD_OPTIMIZER_PIPELINE_DEFAULT))
        depth = get_scalar_param(off, OFFLOAD_OPTIMIZER_PIPELINE_DEPTH,
                                 OFFLOAD_OPTIMIZER_PIPELINE_DEPTH_DEFAULT)
        if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
            raise ValueError(
                f"{ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER}.{OFFLOAD_OPTIMIZER_PIPELINE_DEPTH} "
                f"must be an integer >= 1, got {depth!r}")
        self.offload_pipeline_depth = depth
        cap = get_scalar_param(off, OFFLOAD_OPTIMIZER_MAX_REGION_ELEMENTS,
                               OFFLOAD_OPTIMIZER_MAX_REGION_ELEMENTS_DEFAULT)
        if not (cap == OFFLOAD_OPTIMIZER_MAX_REGION_ELEMENTS_DEFAULT
                or (isinstance(cap, int) and not isinstance(cap, bool) and cap >= 0)):
            raise ValueError(
                f"{ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER}.{OFFLOAD_OPTIMIZER_MAX_REGION_ELEMENTS} "
                f"must be 'auto' or a non-negative integer (0 = auto), got {cap!r}")
        self.offload_max_region_elements = cap
        if user_set:
            if (ZERO_OPTIMIZATION_CPU_OFFLOAD in zero_config_dict
                    and not zero_config_dict[ZERO_OPTIMIZATION_CPU_OFFLOAD]):
                logger.warning(
                    f"DeepSpeedZeroConfig: '{ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER}' is "
                    f"configured but '{ZERO_OPTIMIZATION_CPU_OFFLOAD}' is explicitly "
                    "false — offload stays DISABLED (the explicit boolean wins); the "
                    "pipeline knobs are kept for when it is enabled")
            else:
                self.cpu_offload = True

    def repr(self):
        return self.__dict__

    def __repr__(self):
        import json
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
