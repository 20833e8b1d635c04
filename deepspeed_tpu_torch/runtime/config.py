"""JSON config system.

Copy of ``deepspeed_tpu/runtime/config.py`` for the PyTorch port: same JSON keys and
semantics — batch triple inference (reference config.py:562-608), the
``train_batch = micro_batch * grad_acc * world_size`` assertion (config.py:542-560),
duplicate-key rejection (config.py:455-457), bfloat16 as the default low-precision
policy. The world size and rank come from ``torch.distributed`` when a process group
is initialized, else 1 and 0. Warning texts that name TPU mechanisms are kept as the
JAX package words them, so both packages resolve a config the same way.
"""

import json
from typing import Optional

import torch.distributed as dist

from ..utils import logger
from .config_utils import dict_raise_error_on_duplicate_keys, get_scalar_param
from .constants import *
from .zero.config import DeepSpeedZeroConfig
from .zero.constants import (MAX_STAGE_ZERO_OPTIMIZATION, ZERO_OPTIMIZATION_GRADIENTS,
                             ZERO_OPTIMIZATION_WEIGHTS)
from .activation_checkpointing.config import DeepSpeedActivationCheckpointingConfig

TENSOR_CORE_ALIGN_SIZE = 8  # MXU lane alignment hint (reference used tensor-core 8)


class SparseAttentionConfig:
    """Typed view of the ``sparse_attention`` block (reference config.py:156-324)."""

    def __init__(self, sparsity_dict):
        self.mode = get_scalar_param(sparsity_dict, SPARSE_MODE, SPARSE_MODE_DEFAULT)
        self.block = get_scalar_param(sparsity_dict, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT)
        self.different_layout_per_head = get_scalar_param(sparsity_dict, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
                                                          SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT)
        self.num_local_blocks = get_scalar_param(sparsity_dict, SPARSE_NUM_LOCAL_BLOCKS,
                                                 SPARSE_NUM_LOCAL_BLOCKS_DEFAULT)
        self.num_global_blocks = get_scalar_param(sparsity_dict, SPARSE_NUM_GLOBAL_BLOCKS,
                                                  SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT)
        self.attention = get_scalar_param(sparsity_dict, SPARSE_ATTENTION_TYPE, SPARSE_ATTENTION_TYPE_DEFAULT)
        self.horizontal_global_attention = get_scalar_param(sparsity_dict, SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
                                                            SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT)
        self.num_different_global_patterns = get_scalar_param(sparsity_dict, SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
                                                              SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT)
        self.num_random_blocks = get_scalar_param(sparsity_dict, SPARSE_NUM_RANDOM_BLOCKS,
                                                  SPARSE_NUM_RANDOM_BLOCKS_DEFAULT)
        self.local_window_blocks = get_scalar_param(sparsity_dict, SPARSE_LOCAL_WINDOW_BLOCKS,
                                                    SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT)
        self.global_block_indices = get_scalar_param(sparsity_dict, SPARSE_GLOBAL_BLOCK_INDICES,
                                                     SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT)
        self.global_block_end_indices = get_scalar_param(sparsity_dict, SPARSE_GLOBAL_BLOCK_END_INDICES,
                                                         SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT)
        self.num_sliding_window_blocks = get_scalar_param(sparsity_dict, SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                                                          SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT)

    def repr(self):
        return self.__dict__


def get_pipeline_config(param_dict):
    """Engine-level pipeline block (reference config.py:340-360)."""
    default_pipeline = {
        PIPELINE_STAGES: PIPELINE_STAGES_DEFAULT,
        PIPELINE_PARTITION: PIPELINE_PARTITION_DEFAULT,
        PIPELINE_SEED_LAYERS: PIPELINE_SEED_LAYERS_DEFAULT,
        PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL: PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT,
    }
    config = default_pipeline.copy()
    for key, val in param_dict.get(PIPELINE, {}).items():
        config[key] = val
    return config


class DeepSpeedConfig:
    """Typed view over the DeepSpeed-style JSON config.

    ``world_size`` is the *data-parallel* world size used for batch inference — by default
    the number of addressable JAX devices divided by any model/pipe parallel degrees the
    caller's mesh/mpu implies (reference: dp world from mpu, config.py:470-480).
    """

    def __init__(self, json_file_or_dict, mpu=None, param_dict: Optional[dict] = None, world_size: Optional[int] = None):
        if param_dict is None:
            if isinstance(json_file_or_dict, dict):
                self._param_dict = json_file_or_dict
            else:
                with open(json_file_or_dict, "r") as f:
                    self._param_dict = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        else:
            self._param_dict = param_dict

        dist_up = dist.is_available() and dist.is_initialized()
        if world_size is not None:
            self.world_size = world_size
        elif mpu is not None:
            self.world_size = mpu.get_data_parallel_world_size()
        else:
            self.world_size = dist.get_world_size() if dist_up else 1
        self.global_rank = dist.get_rank() if dist_up else 0

        # warn about unrecognized keys BEFORE batch inference/error checks: a typo'd
        # batch key would otherwise abort on the missing-batch assertion without the
        # user ever seeing which key went unrecognized
        unknown = sorted(k for k in self._param_dict if k not in TOP_LEVEL_CONFIG_KEYS)
        if unknown:
            logger.warning(f"DeepSpeedConfig: unknown top-level config key(s) {unknown} "
                           "— ignored. Known keys: see docs/config-json.md.")
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    @staticmethod
    def _warn_unknown_nested(block, block_dict, known_keys):
        """Same unknown-key diagnostic as the top-level sweep, for a nested
        block — a typo'd "enable" must not silently leave a subsystem off."""
        if not isinstance(block_dict, dict):
            return
        unknown = sorted(k for k in block_dict if k not in known_keys)
        if unknown:
            logger.warning(f"DeepSpeedConfig: unknown {block} config key(s) "
                           f"{unknown} — ignored. Known keys: {sorted(known_keys)}.")

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_scalar_param(param_dict, TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT)
        micro = get_scalar_param(param_dict, TRAIN_MICRO_BATCH_SIZE_PER_GPU, TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        if micro is None:
            micro = get_scalar_param(param_dict, TRAIN_MICRO_BATCH_SIZE_PER_DEVICE,
                                     TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = get_scalar_param(param_dict, GRADIENT_ACCUMULATION_STEPS,
                                                            GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(param_dict, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)
        self.dump_state = get_scalar_param(param_dict, DUMP_STATE, DUMP_STATE_DEFAULT)

        self.disable_allgather = get_scalar_param(param_dict, DISABLE_ALLGATHER, DISABLE_ALLGATHER_DEFAULT)
        self.allreduce_always_fp32 = get_scalar_param(param_dict, ALLREDUCE_ALWAYS_FP32,
                                                      ALLREDUCE_ALWAYS_FP32_DEFAULT)
        if get_scalar_param(param_dict, FP32_ALLREDUCE, FP32_ALLREDUCE_DEFAULT):
            # deprecated alias from the reference constants (constants.py:191-196):
            # fold into allreduce_always_fp32 rather than silently dropping it
            logger.warning(f"DeepSpeedConfig: '{FP32_ALLREDUCE}' is deprecated; it is "
                           f"honored as '{ALLREDUCE_ALWAYS_FP32}'.")
            self.allreduce_always_fp32 = True
        self.communication_data_type = get_scalar_param(param_dict, COMMUNICATION_DATA_TYPE,
                                                        COMMUNICATION_DATA_TYPE_DEFAULT)
        if self.communication_data_type is not None:
            allowed = ("fp32", "fp16", "bf16")
            if self.communication_data_type not in allowed:
                raise ValueError(f"DeepSpeedConfig: {COMMUNICATION_DATA_TYPE} must be one of "
                                 f"{allowed} (got {self.communication_data_type!r})")
        self.prescale_gradients = get_scalar_param(param_dict, PRESCALE_GRADIENTS, PRESCALE_GRADIENTS_DEFAULT)
        self.fused_step = get_scalar_param(param_dict, FUSED_STEP, FUSED_STEP_DEFAULT)
        self.compilation_cache_dir = get_scalar_param(param_dict, COMPILATION_CACHE_DIR,
                                                      COMPILATION_CACHE_DIR_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(param_dict, GRADIENT_PREDIVIDE_FACTOR,
                                                          GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = get_scalar_param(param_dict, SPARSE_GRADIENTS, SPARSE_GRADIENTS_DEFAULT)

        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        self.activation_checkpointing_config = DeepSpeedActivationCheckpointingConfig(param_dict)

        self.gradient_clipping = get_scalar_param(param_dict, GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)

        # Mixed-precision policy. fp16 block keeps reference semantics (loss scaling);
        # bf16 (TPU-native, no scaling) is the default compute dtype when neither is set.
        fp16_dict = param_dict.get(FP16, {})
        self.fp16_enabled = get_scalar_param(fp16_dict, FP16_ENABLED, FP16_ENABLED_DEFAULT)
        self.loss_scale = get_scalar_param(fp16_dict, FP16_LOSS_SCALE, FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = get_scalar_param(fp16_dict, FP16_INITIAL_SCALE_POWER,
                                                    FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = get_scalar_param(fp16_dict, FP16_LOSS_SCALE_WINDOW, FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = get_scalar_param(fp16_dict, FP16_HYSTERESIS, FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = get_scalar_param(fp16_dict, FP16_MIN_LOSS_SCALE, FP16_MIN_LOSS_SCALE_DEFAULT)

        bf16_dict = param_dict.get(BF16, {})
        self.bf16_enabled = get_scalar_param(bf16_dict, BF16_ENABLED, not self.fp16_enabled)

        amp_dict = param_dict.get(AMP, {})
        self.amp_enabled = get_scalar_param(amp_dict, AMP_ENABLED, AMP_ENABLED_DEFAULT)
        self.amp_params = {k: v for k, v in amp_dict.items() if k != AMP_ENABLED}
        if self.amp_enabled:
            # apex.amp is CUDA-only; its O1/O2 mixed precision maps to the TPU-native
            # bf16 policy (low-precision compute, fp32 master/optimizer state). Act,
            # don't no-op: enable the bf16 policy and say so. fp16+amp is rejected in
            # _do_error_check (reference engine.py:530-531).
            logger.warning("DeepSpeedConfig: 'amp' maps to the TPU-native bf16 mixed-"
                           "precision policy (apex is CUDA-only); amp opt-level params "
                           f"{self.amp_params or '{}'} are ignored. Prefer the 'bf16' "
                           "block (docs/config-json.md).")
            if not self.fp16_enabled:
                self.bf16_enabled = True

        self.zero_allow_untested_optimizer = get_scalar_param(
            param_dict, ZERO_ALLOW_UNTESTED_OPTIMIZER, ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)

        optimizer_dict = param_dict.get(OPTIMIZER, None)
        self.optimizer_name = None
        self.optimizer_params = None
        self.optimizer_legacy_fusion = False
        if optimizer_dict is not None:
            self.optimizer_name = optimizer_dict.get(TYPE, OPTIMIZER_TYPE_DEFAULT)
            if self.optimizer_name is not None:
                self.optimizer_name = self.optimizer_name.lower()
            self.optimizer_params = optimizer_dict.get(OPTIMIZER_PARAMS, None)
            self.optimizer_legacy_fusion = optimizer_dict.get(LEGACY_FUSION, LEGACY_FUSION_DEFAULT)

        scheduler_dict = param_dict.get(SCHEDULER, None)
        self.scheduler_name = None
        self.scheduler_params = None
        if scheduler_dict is not None:
            self.scheduler_name = scheduler_dict.get(TYPE, SCHEDULER_TYPE_DEFAULT)
            self.scheduler_params = scheduler_dict.get(SCHEDULER_PARAMS, None)

        self.wall_clock_breakdown = get_scalar_param(param_dict, WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get_scalar_param(param_dict, MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT)

        tb_dict = param_dict.get(TENSORBOARD, {})
        self.tensorboard_enabled = get_scalar_param(tb_dict, TENSORBOARD_ENABLED, TENSORBOARD_ENABLED_DEFAULT)
        self.tensorboard_output_path = get_scalar_param(tb_dict, TENSORBOARD_OUTPUT_PATH,
                                                        TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = get_scalar_param(tb_dict, TENSORBOARD_JOB_NAME, TENSORBOARD_JOB_NAME_DEFAULT)

        tel_dict = param_dict.get(TELEMETRY, {})
        self._warn_unknown_nested(TELEMETRY, tel_dict, TELEMETRY_CONFIG_KEYS)
        self.telemetry_enabled = get_scalar_param(tel_dict, TELEMETRY_ENABLED, TELEMETRY_ENABLED_DEFAULT)
        self.telemetry_trace_dir = get_scalar_param(tel_dict, TELEMETRY_TRACE_DIR, TELEMETRY_TRACE_DIR_DEFAULT)
        self.telemetry_trace_steps = get_scalar_param(tel_dict, TELEMETRY_TRACE_STEPS,
                                                      TELEMETRY_TRACE_STEPS_DEFAULT)
        if self.telemetry_trace_steps is not None:
            ts = self.telemetry_trace_steps
            if (not isinstance(ts, (list, tuple)) or len(ts) != 2
                    or not all(isinstance(v, int) and not isinstance(v, bool) and v >= 0 for v in ts)
                    or ts[1] <= ts[0]):
                raise ValueError(
                    "DeepSpeedConfig: telemetry.trace_steps must be a [start, stop] "
                    f"pair of non-negative ints with start < stop, got {ts!r}")
            self.telemetry_trace_steps = (int(ts[0]), int(ts[1]))
        self.telemetry_perturbing_breakdown = get_scalar_param(tel_dict, TELEMETRY_PERTURBING_BREAKDOWN,
                                                               TELEMETRY_PERTURBING_BREAKDOWN_DEFAULT)
        self.telemetry_peak_tflops = float(
            get_scalar_param(tel_dict, TELEMETRY_PEAK_TFLOPS, TELEMETRY_PEAK_TFLOPS_DEFAULT) or 0.0)
        self.telemetry_mfu_window = get_scalar_param(tel_dict, TELEMETRY_MFU_WINDOW,
                                                     TELEMETRY_MFU_WINDOW_DEFAULT)
        self.telemetry_recompile_warn = get_scalar_param(tel_dict, TELEMETRY_RECOMPILE_WARN,
                                                         TELEMETRY_RECOMPILE_WARN_DEFAULT)
        self.telemetry_output_path = get_scalar_param(tel_dict, TELEMETRY_OUTPUT_PATH,
                                                      TELEMETRY_OUTPUT_PATH_DEFAULT)
        self.telemetry_job_name = get_scalar_param(tel_dict, TELEMETRY_JOB_NAME, TELEMETRY_JOB_NAME_DEFAULT)
        pt_dict = tel_dict.get(TELEMETRY_PIPELINE_TRACE, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_PIPELINE_TRACE}",
                                  pt_dict, PIPELINE_TRACE_CONFIG_KEYS)
        self.pipeline_trace_enabled = get_scalar_param(pt_dict, PIPELINE_TRACE_ENABLED,
                                                       PIPELINE_TRACE_ENABLED_DEFAULT)
        self.pipeline_trace_capacity = get_scalar_param(pt_dict, PIPELINE_TRACE_CAPACITY,
                                                        PIPELINE_TRACE_CAPACITY_DEFAULT)
        cap = self.pipeline_trace_capacity
        if isinstance(cap, bool) or not isinstance(cap, int) or cap < 1:
            raise ValueError(
                "DeepSpeedConfig: telemetry.pipeline_trace.capacity must be an "
                f"int >= 1, got {cap!r}")
        self.pipeline_trace_dump_dir = get_scalar_param(pt_dict, PIPELINE_TRACE_DUMP_DIR,
                                                        PIPELINE_TRACE_DUMP_DIR_DEFAULT)
        an_dict = tel_dict.get(TELEMETRY_ANATOMY, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_ANATOMY}",
                                  an_dict, ANATOMY_CONFIG_KEYS)
        self.telemetry_anatomy_enabled = get_scalar_param(an_dict, ANATOMY_ENABLED,
                                                          ANATOMY_ENABLED_DEFAULT)
        self.telemetry_anatomy_chip = get_scalar_param(an_dict, ANATOMY_CHIP, ANATOMY_CHIP_DEFAULT)
        for attr, key, default in (("telemetry_anatomy_peak_tflops", ANATOMY_PEAK_TFLOPS,
                                    ANATOMY_PEAK_TFLOPS_DEFAULT),
                                   ("telemetry_anatomy_hbm_gbps", ANATOMY_HBM_GBPS,
                                    ANATOMY_HBM_GBPS_DEFAULT),
                                   ("telemetry_anatomy_ici_gbps", ANATOMY_ICI_GBPS,
                                    ANATOMY_ICI_GBPS_DEFAULT),
                                   ("telemetry_anatomy_dcn_gbps", ANATOMY_DCN_GBPS,
                                    ANATOMY_DCN_GBPS_DEFAULT)):
            val = get_scalar_param(an_dict, key, default)
            if isinstance(val, bool) or not isinstance(val, (int, float)) or val < 0:
                raise ValueError(
                    f"DeepSpeedConfig: telemetry.anatomy.{key} must be a "
                    f"number >= 0 (0 = use the chip table value), got {val!r}")
            setattr(self, attr, float(val))

        cl_dict = tel_dict.get(TELEMETRY_CLUSTER, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_CLUSTER}",
                                  cl_dict, CLUSTER_CONFIG_KEYS)
        self.telemetry_cluster_enabled = get_scalar_param(cl_dict, CLUSTER_ENABLED,
                                                          CLUSTER_ENABLED_DEFAULT)
        if self.telemetry_cluster_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.cluster.enabled requires "
                "telemetry.enabled — the heartbeat rides the end_step record "
                "the telemetry session produces")
        self.telemetry_cluster_heartbeat_interval = get_scalar_param(
            cl_dict, CLUSTER_HEARTBEAT_INTERVAL, CLUSTER_HEARTBEAT_INTERVAL_DEFAULT)
        hb = self.telemetry_cluster_heartbeat_interval
        if isinstance(hb, bool) or not isinstance(hb, int) or hb < 1:
            raise ValueError(
                "DeepSpeedConfig: telemetry.cluster.heartbeat_interval must be "
                f"an int >= 1, got {hb!r}")
        self.telemetry_cluster_hang_deadline_s = get_scalar_param(
            cl_dict, CLUSTER_HANG_DEADLINE_S, CLUSTER_HANG_DEADLINE_S_DEFAULT)
        dl = self.telemetry_cluster_hang_deadline_s
        if isinstance(dl, bool) or not isinstance(dl, (int, float)) or dl < 0:
            raise ValueError(
                "DeepSpeedConfig: telemetry.cluster.hang_deadline_s must be a "
                f"number >= 0 (0 = watchdog off), got {dl!r}")
        self.telemetry_cluster_hang_deadline_s = float(dl)
        self.telemetry_cluster_dump_dir = get_scalar_param(
            cl_dict, CLUSTER_DUMP_DIR, CLUSTER_DUMP_DIR_DEFAULT)
        self.telemetry_cluster_straggler_threshold = get_scalar_param(
            cl_dict, CLUSTER_STRAGGLER_THRESHOLD, CLUSTER_STRAGGLER_THRESHOLD_DEFAULT)
        st = self.telemetry_cluster_straggler_threshold
        if isinstance(st, bool) or not isinstance(st, (int, float)) or st <= 1:
            raise ValueError(
                "DeepSpeedConfig: telemetry.cluster.straggler_threshold must be "
                f"a number > 1, got {st!r}")
        self.telemetry_cluster_straggler_threshold = float(st)
        self.telemetry_cluster_signal_peers = get_scalar_param(
            cl_dict, CLUSTER_SIGNAL_PEERS, CLUSTER_SIGNAL_PEERS_DEFAULT)
        self.telemetry_cluster_warmup_steps = get_scalar_param(
            cl_dict, CLUSTER_WARMUP_STEPS, CLUSTER_WARMUP_STEPS_DEFAULT)
        wu = self.telemetry_cluster_warmup_steps
        if isinstance(wu, bool) or not isinstance(wu, int) or wu < 0:
            raise ValueError(
                "DeepSpeedConfig: telemetry.cluster.warmup_steps must be an "
                f"int >= 0 (steps before the watchdog arms / stragglers are "
                f"named — the compile steps), got {wu!r}")

        gp_dict = tel_dict.get(TELEMETRY_GOODPUT, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_GOODPUT}",
                                  gp_dict, GOODPUT_CONFIG_KEYS)
        self.telemetry_goodput_enabled = get_scalar_param(gp_dict, GOODPUT_ENABLED,
                                                          GOODPUT_ENABLED_DEFAULT)
        if self.telemetry_goodput_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.goodput.enabled requires "
                "telemetry.enabled — the ledger closes its step intervals on "
                "the end_step record the telemetry session produces")
        self.telemetry_goodput_ledger_dir = get_scalar_param(
            gp_dict, GOODPUT_LEDGER_DIR, GOODPUT_LEDGER_DIR_DEFAULT)
        if not isinstance(self.telemetry_goodput_ledger_dir, str):
            raise ValueError(
                "DeepSpeedConfig: telemetry.goodput.ledger_dir must be a string "
                f"path (\"\" = beside the flight-recorder dumps), got "
                f"{self.telemetry_goodput_ledger_dir!r}")
        self.telemetry_goodput_emit_scalars = get_scalar_param(
            gp_dict, GOODPUT_EMIT_SCALARS, GOODPUT_EMIT_SCALARS_DEFAULT)
        if not isinstance(self.telemetry_goodput_emit_scalars, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.goodput.emit_scalars must be a "
                f"bool, got {self.telemetry_goodput_emit_scalars!r}")
        self.telemetry_goodput_eval_tag = get_scalar_param(
            gp_dict, GOODPUT_EVAL_TAG, GOODPUT_EVAL_TAG_DEFAULT)
        if (not isinstance(self.telemetry_goodput_eval_tag, str)
                or not self.telemetry_goodput_eval_tag):
            raise ValueError(
                "DeepSpeedConfig: telemetry.goodput.eval_tag must be a "
                f"non-empty string, got {self.telemetry_goodput_eval_tag!r}")

        hbm_dict = tel_dict.get(TELEMETRY_HBM, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_HBM}",
                                  hbm_dict, HBM_CONFIG_KEYS)
        self.telemetry_hbm_enabled = get_scalar_param(hbm_dict, HBM_ENABLED,
                                                      HBM_ENABLED_DEFAULT)
        if self.telemetry_hbm_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.hbm.enabled requires "
                "telemetry.enabled — the Memory/* scalars ride the end_step "
                "record the telemetry session produces")
        if not isinstance(self.telemetry_hbm_enabled, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.hbm.enabled must be a bool, got "
                f"{self.telemetry_hbm_enabled!r}")

        prof_dict = tel_dict.get(TELEMETRY_PROFILE, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_PROFILE}",
                                  prof_dict, PROFILE_CONFIG_KEYS)
        self.telemetry_profile_enabled = get_scalar_param(
            prof_dict, PROFILE_ENABLED, PROFILE_ENABLED_DEFAULT)
        if not isinstance(self.telemetry_profile_enabled, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.profile.enabled must be a bool, "
                f"got {self.telemetry_profile_enabled!r}")
        if self.telemetry_profile_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.profile.enabled requires "
                "telemetry.enabled — the observatory ingests the trace window "
                "the telemetry session writes")
        self.telemetry_profile_reconcile_tolerance = get_scalar_param(
            prof_dict, PROFILE_RECONCILE_TOLERANCE,
            PROFILE_RECONCILE_TOLERANCE_DEFAULT)
        tol = self.telemetry_profile_reconcile_tolerance
        if isinstance(tol, bool) or not isinstance(tol, (int, float)) \
                or tol <= 0:
            raise ValueError(
                "DeepSpeedConfig: telemetry.profile.reconcile_tolerance must "
                f"be a number > 0, got {tol!r}")
        self.telemetry_profile_reconcile_tolerance = float(tol)
        self.telemetry_profile_emit_scalars = get_scalar_param(
            prof_dict, PROFILE_EMIT_SCALARS, PROFILE_EMIT_SCALARS_DEFAULT)
        if not isinstance(self.telemetry_profile_emit_scalars, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.profile.emit_scalars must be a "
                f"bool, got {self.telemetry_profile_emit_scalars!r}")

        met_dict = tel_dict.get(TELEMETRY_METRICS, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_METRICS}",
                                  met_dict, METRICS_CONFIG_KEYS)
        self.telemetry_metrics_enabled = get_scalar_param(
            met_dict, METRICS_ENABLED, METRICS_ENABLED_DEFAULT)
        if not isinstance(self.telemetry_metrics_enabled, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.metrics.enabled must be a bool, "
                f"got {self.telemetry_metrics_enabled!r}")
        if self.telemetry_metrics_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.metrics.enabled requires "
                "telemetry.enabled — the catalog router rides the "
                "SummaryMonitor the telemetry session owns")
        self.telemetry_metrics_ring_len = get_scalar_param(
            met_dict, METRICS_RING_LEN, METRICS_RING_LEN_DEFAULT)
        rl = self.telemetry_metrics_ring_len
        if isinstance(rl, bool) or not isinstance(rl, int) or rl < 1:
            raise ValueError(
                "DeepSpeedConfig: telemetry.metrics.ring_len must be an "
                f"int >= 1, got {rl!r}")
        self.telemetry_metrics_strict_catalog = get_scalar_param(
            met_dict, METRICS_STRICT_CATALOG, METRICS_STRICT_CATALOG_DEFAULT)
        if not isinstance(self.telemetry_metrics_strict_catalog, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.metrics.strict_catalog must be a "
                f"bool, got {self.telemetry_metrics_strict_catalog!r}")
        self.telemetry_metrics_export_path = get_scalar_param(
            met_dict, METRICS_EXPORT_PATH, METRICS_EXPORT_PATH_DEFAULT)
        if not isinstance(self.telemetry_metrics_export_path, str):
            raise ValueError(
                "DeepSpeedConfig: telemetry.metrics.export_path must be a "
                f"string, got {self.telemetry_metrics_export_path!r}")

        al_dict = tel_dict.get(TELEMETRY_ALERTS, {}) or {}
        self._warn_unknown_nested(f"{TELEMETRY}.{TELEMETRY_ALERTS}",
                                  al_dict, ALERTS_CONFIG_KEYS)
        self.telemetry_alerts_enabled = get_scalar_param(
            al_dict, ALERTS_ENABLED, ALERTS_ENABLED_DEFAULT)
        if not isinstance(self.telemetry_alerts_enabled, bool):
            raise ValueError(
                "DeepSpeedConfig: telemetry.alerts.enabled must be a bool, "
                f"got {self.telemetry_alerts_enabled!r}")
        if self.telemetry_alerts_enabled and not self.telemetry_enabled:
            raise ValueError(
                "DeepSpeedConfig: telemetry.alerts.enabled requires "
                "telemetry.enabled — the rules evaluate on the end_step "
                "boundary the telemetry session drives")
        rules = get_scalar_param(al_dict, ALERTS_RULES, ALERTS_RULES_DEFAULT)
        if rules is not None:
            if not isinstance(rules, (list, tuple)):
                raise ValueError(
                    "DeepSpeedConfig: telemetry.alerts.rules must be a list "
                    f"of rule dicts (or null for the default ruleset), got "
                    f"{rules!r}")
            from ..utils.alerts import validate_rules
            from ..utils.metrics import default_catalog
            try:
                rules = validate_rules(list(rules), default_catalog())
            except ValueError as e:
                raise ValueError(
                    f"DeepSpeedConfig: telemetry.alerts.rules: {e}")
        self.telemetry_alerts_rules = rules

        num_dict = param_dict.get(NUMERICS, {})
        self._warn_unknown_nested(NUMERICS, num_dict, NUMERICS_CONFIG_KEYS)
        self.numerics_enabled = get_scalar_param(num_dict, NUMERICS_ENABLED, NUMERICS_ENABLED_DEFAULT)
        self.numerics_subtree_depth = get_scalar_param(num_dict, NUMERICS_SUBTREE_DEPTH,
                                                       NUMERICS_SUBTREE_DEPTH_DEFAULT)
        self.numerics_audit_interval = get_scalar_param(num_dict, NUMERICS_AUDIT_INTERVAL,
                                                        NUMERICS_AUDIT_INTERVAL_DEFAULT)
        self.numerics_dump_dir = get_scalar_param(num_dict, NUMERICS_DUMP_DIR, NUMERICS_DUMP_DIR_DEFAULT)
        self.numerics_ring_size = get_scalar_param(num_dict, NUMERICS_RING_SIZE, NUMERICS_RING_SIZE_DEFAULT)
        self.numerics_consecutive_skip_trigger = get_scalar_param(
            num_dict, NUMERICS_CONSECUTIVE_SKIP_TRIGGER, NUMERICS_CONSECUTIVE_SKIP_TRIGGER_DEFAULT)
        self.numerics_trigger_on_nonfinite_loss = get_scalar_param(
            num_dict, NUMERICS_TRIGGER_ON_NONFINITE_LOSS, NUMERICS_TRIGGER_ON_NONFINITE_LOSS_DEFAULT)
        self.numerics_install_signal_handlers = get_scalar_param(
            num_dict, NUMERICS_INSTALL_SIGNAL_HANDLERS, NUMERICS_INSTALL_SIGNAL_HANDLERS_DEFAULT)
        for attr, minimum in ((("numerics_subtree_depth"), 1),
                              (("numerics_audit_interval"), 0),
                              (("numerics_ring_size"), 1),
                              (("numerics_consecutive_skip_trigger"), 0)):
            val = getattr(self, attr)
            if isinstance(val, bool) or not isinstance(val, int) or val < minimum:
                raise ValueError(
                    f"DeepSpeedConfig: numerics.{attr[len('numerics_'):]} must be an "
                    f"int >= {minimum}, got {val!r}")

        sv_dict = param_dict.get(SERVING, {})
        self._warn_unknown_nested(SERVING, sv_dict, SERVING_CONFIG_KEYS)
        self.serving_enabled = get_scalar_param(sv_dict, SERVING_ENABLED, SERVING_ENABLED_DEFAULT)
        self.serving_block_size = get_scalar_param(sv_dict, SERVING_BLOCK_SIZE, SERVING_BLOCK_SIZE_DEFAULT)
        self.serving_num_blocks = get_scalar_param(sv_dict, SERVING_NUM_BLOCKS, SERVING_NUM_BLOCKS_DEFAULT)
        self.serving_max_seqs = get_scalar_param(sv_dict, SERVING_MAX_SEQS, SERVING_MAX_SEQS_DEFAULT)
        self.serving_max_model_len = get_scalar_param(sv_dict, SERVING_MAX_MODEL_LEN,
                                                      SERVING_MAX_MODEL_LEN_DEFAULT)
        self.serving_prefill_chunk = get_scalar_param(sv_dict, SERVING_PREFILL_CHUNK,
                                                      SERVING_PREFILL_CHUNK_DEFAULT)
        self.serving_use_pallas_decode = get_scalar_param(sv_dict, SERVING_USE_PALLAS_DECODE,
                                                          SERVING_USE_PALLAS_DECODE_DEFAULT)
        for attr, minimum in (("serving_block_size", 1),
                              ("serving_num_blocks", 2),  # block 0 is the reserved null page
                              ("serving_max_seqs", 1),
                              ("serving_max_model_len", 1),
                              ("serving_prefill_chunk", 1)):
            val = getattr(self, attr)
            if isinstance(val, bool) or not isinstance(val, int) or val < minimum:
                raise ValueError(
                    f"DeepSpeedConfig: serving.{attr[len('serving_'):]} must be an "
                    f"int >= {minimum}, got {val!r}")
        if self.serving_max_model_len % self.serving_block_size != 0:
            # the paged gather reconstructs a [max_blocks * block_size] dense view;
            # it bit-matches the dense decode oracle only when the tiling is exact
            raise ValueError(
                "DeepSpeedConfig: serving.max_model_len must be a multiple of "
                f"serving.block_size, got {self.serving_max_model_len} % "
                f"{self.serving_block_size} != 0")

        rt_dict = sv_dict.get(SERVING_REQUEST_TRACE, {}) or {}
        self._warn_unknown_nested(f"{SERVING}.{SERVING_REQUEST_TRACE}",
                                  rt_dict, SERVING_REQUEST_TRACE_CONFIG_KEYS)
        self.serving_request_trace_enabled = get_scalar_param(
            rt_dict, SERVING_REQUEST_TRACE_ENABLED,
            SERVING_REQUEST_TRACE_ENABLED_DEFAULT)
        self.serving_request_trace_capacity = get_scalar_param(
            rt_dict, SERVING_REQUEST_TRACE_CAPACITY,
            SERVING_REQUEST_TRACE_CAPACITY_DEFAULT)
        self.serving_request_trace_iteration_capacity = get_scalar_param(
            rt_dict, SERVING_REQUEST_TRACE_ITERATION_CAPACITY,
            SERVING_REQUEST_TRACE_ITERATION_CAPACITY_DEFAULT)
        self.serving_request_trace_dump_dir = get_scalar_param(
            rt_dict, SERVING_REQUEST_TRACE_DUMP_DIR,
            SERVING_REQUEST_TRACE_DUMP_DIR_DEFAULT)
        for attr, minimum in (("serving_request_trace_capacity", 1),
                              ("serving_request_trace_iteration_capacity", 1)):
            val = getattr(self, attr)
            if isinstance(val, bool) or not isinstance(val, int) or val < minimum:
                raise ValueError(
                    f"DeepSpeedConfig: serving.request_trace."
                    f"{attr[len('serving_request_trace_'):]} must be an "
                    f"int >= {minimum}, got {val!r}")
        slo_dict = rt_dict.get(SERVING_REQUEST_TRACE_SLO, {}) or {}
        self._warn_unknown_nested(
            f"{SERVING}.{SERVING_REQUEST_TRACE}.{SERVING_REQUEST_TRACE_SLO}",
            slo_dict, SERVING_SLO_CONFIG_KEYS)
        self.serving_slo_ttft_ms = get_scalar_param(
            slo_dict, SERVING_SLO_TTFT_MS, SERVING_SLO_TTFT_MS_DEFAULT)
        self.serving_slo_tpot_ms = get_scalar_param(
            slo_dict, SERVING_SLO_TPOT_MS, SERVING_SLO_TPOT_MS_DEFAULT)
        for attr in ("serving_slo_ttft_ms", "serving_slo_tpot_ms"):
            val = getattr(self, attr)
            if isinstance(val, bool) or not isinstance(val, (int, float)) or val < 0:
                raise ValueError(
                    f"DeepSpeedConfig: serving.request_trace.slo."
                    f"{attr[len('serving_slo_'):]} must be a number >= 0 "
                    f"(0 = not gated), got {val!r}")

        sh_dict = sv_dict.get(SERVING_SHARDING, {}) or {}
        self._warn_unknown_nested(f"{SERVING}.{SERVING_SHARDING}",
                                  sh_dict, SERVING_SHARDING_CONFIG_KEYS)
        self.serving_sharding_model = get_scalar_param(
            sh_dict, SERVING_SHARDING_MODEL, SERVING_SHARDING_MODEL_DEFAULT)
        val = self.serving_sharding_model
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(
                "DeepSpeedConfig: serving.sharding.model must be an int >= 1 "
                f"(1 = single-chip), got {val!r}")

        pc_dict = sv_dict.get(SERVING_PREFIX_CACHE, {}) or {}
        self._warn_unknown_nested(f"{SERVING}.{SERVING_PREFIX_CACHE}",
                                  pc_dict, SERVING_PREFIX_CACHE_CONFIG_KEYS)
        self.serving_prefix_cache_enabled = get_scalar_param(
            pc_dict, SERVING_PREFIX_CACHE_ENABLED,
            SERVING_PREFIX_CACHE_ENABLED_DEFAULT)

        sp_dict = sv_dict.get(SERVING_SPECULATION, {}) or {}
        self._warn_unknown_nested(f"{SERVING}.{SERVING_SPECULATION}",
                                  sp_dict, SERVING_SPECULATION_CONFIG_KEYS)
        self.serving_speculation_enabled = get_scalar_param(
            sp_dict, SERVING_SPECULATION_ENABLED,
            SERVING_SPECULATION_ENABLED_DEFAULT)
        self.serving_speculation_draft_model = get_scalar_param(
            sp_dict, SERVING_SPECULATION_DRAFT_MODEL,
            SERVING_SPECULATION_DRAFT_MODEL_DEFAULT)
        self.serving_speculation_max_draft_tokens = get_scalar_param(
            sp_dict, SERVING_SPECULATION_MAX_DRAFT_TOKENS,
            SERVING_SPECULATION_MAX_DRAFT_TOKENS_DEFAULT)
        self.serving_speculation_draft_pool_blocks = get_scalar_param(
            sp_dict, SERVING_SPECULATION_DRAFT_POOL_BLOCKS,
            SERVING_SPECULATION_DRAFT_POOL_BLOCKS_DEFAULT)
        val = self.serving_speculation_max_draft_tokens
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(
                "DeepSpeedConfig: serving.speculation.max_draft_tokens must "
                f"be an int >= 1, got {val!r}")
        val = self.serving_speculation_draft_pool_blocks
        if isinstance(val, bool) or not isinstance(val, int) or (
                val != 0 and val < 2):  # block 0 is the reserved null page
            raise ValueError(
                "DeepSpeedConfig: serving.speculation.draft_pool_blocks must "
                "be 0 (inherit serving.num_blocks) or an int >= 2, "
                f"got {val!r}")

        fl_dict = sv_dict.get(SERVING_FLEET, {}) or {}
        self._warn_unknown_nested(f"{SERVING}.{SERVING_FLEET}",
                                  fl_dict, SERVING_FLEET_CONFIG_KEYS)
        self.serving_fleet_replicas = get_scalar_param(
            fl_dict, SERVING_FLEET_REPLICAS, SERVING_FLEET_REPLICAS_DEFAULT)
        self.serving_fleet_policy = get_scalar_param(
            fl_dict, SERVING_FLEET_POLICY, SERVING_FLEET_POLICY_DEFAULT)
        self.serving_fleet_affinity_weight = get_scalar_param(
            fl_dict, SERVING_FLEET_AFFINITY_WEIGHT,
            SERVING_FLEET_AFFINITY_WEIGHT_DEFAULT)
        self.serving_fleet_max_queue_depth = get_scalar_param(
            fl_dict, SERVING_FLEET_MAX_QUEUE_DEPTH,
            SERVING_FLEET_MAX_QUEUE_DEPTH_DEFAULT)
        self.serving_fleet_occupancy_cap = get_scalar_param(
            fl_dict, SERVING_FLEET_OCCUPANCY_CAP,
            SERVING_FLEET_OCCUPANCY_CAP_DEFAULT)
        self.serving_fleet_goodput_floor = get_scalar_param(
            fl_dict, SERVING_FLEET_GOODPUT_FLOOR,
            SERVING_FLEET_GOODPUT_FLOOR_DEFAULT)
        val = self.serving_fleet_replicas
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(
                "DeepSpeedConfig: serving.fleet.replicas must be an int >= 1 "
                f"(1 = no fleet, a single replica), got {val!r}")
        if self.serving_fleet_policy not in SERVING_FLEET_POLICIES:
            raise ValueError(
                f"DeepSpeedConfig: serving.fleet.policy must be one of "
                f"{SERVING_FLEET_POLICIES}, got "
                f"{self.serving_fleet_policy!r}")
        val = self.serving_fleet_affinity_weight
        if isinstance(val, bool) or not isinstance(val, (int, float)) or val < 0:
            raise ValueError(
                "DeepSpeedConfig: serving.fleet.affinity_weight must be a "
                f"number >= 0 (0 = pure least-loaded), got {val!r}")
        val = self.serving_fleet_max_queue_depth
        if isinstance(val, bool) or not isinstance(val, int) or val < 0:
            raise ValueError(
                "DeepSpeedConfig: serving.fleet.max_queue_depth must be an "
                f"int >= 0 (0 = unbounded), got {val!r}")
        val = self.serving_fleet_occupancy_cap
        if isinstance(val, bool) or not isinstance(val, (int, float)) or (
                not 0.0 < val <= 1.0):
            raise ValueError(
                "DeepSpeedConfig: serving.fleet.occupancy_cap must be a "
                f"number in (0, 1] (1 = occupancy shedding off), got {val!r}")
        val = self.serving_fleet_goodput_floor
        if isinstance(val, bool) or not isinstance(val, (int, float)) or (
                not 0.0 <= val <= 1.0):
            raise ValueError(
                "DeepSpeedConfig: serving.fleet.goodput_floor must be a "
                f"number in [0, 1] (0 = not gated), got {val!r}")

        cm_dict = param_dict.get(COMM, {})
        self._warn_unknown_nested(COMM, cm_dict, COMM_CONFIG_KEYS)
        self.comm_mode = get_scalar_param(cm_dict, COMM_MODE, COMM_MODE_DEFAULT)
        self.comm_dcn_slices = get_scalar_param(cm_dict, COMM_DCN_SLICES, COMM_DCN_SLICES_DEFAULT)
        self.comm_compress_start_step = get_scalar_param(cm_dict, COMM_COMPRESS_START_STEP,
                                                         COMM_COMPRESS_START_STEP_DEFAULT)
        if self.comm_mode not in COMM_MODES:
            raise ValueError(
                f"DeepSpeedConfig: comm.mode must be one of {COMM_MODES}, "
                f"got {self.comm_mode!r}")
        for attr in ("comm_dcn_slices", "comm_compress_start_step"):
            val = getattr(self, attr)
            if isinstance(val, bool) or not isinstance(val, int) or val < 0:
                raise ValueError(
                    f"DeepSpeedConfig: comm.{attr[len('comm_'):]} must be an "
                    f"int >= 0, got {val!r}")
        ov_dict = cm_dict.get(COMM_OVERLAP, {}) or {}
        self._warn_unknown_nested(f"{COMM}.{COMM_OVERLAP}", ov_dict,
                                  COMM_OVERLAP_CONFIG_KEYS)
        self.comm_overlap_mode = get_scalar_param(
            ov_dict, COMM_OVERLAP_MODE, COMM_OVERLAP_MODE_DEFAULT)
        self.comm_overlap_bucket_mb = get_scalar_param(
            ov_dict, COMM_OVERLAP_BUCKET_MB, COMM_OVERLAP_BUCKET_MB_DEFAULT)
        if self.comm_overlap_mode not in COMM_OVERLAP_MODES:
            raise ValueError(
                f"DeepSpeedConfig: comm.overlap.mode must be one of "
                f"{COMM_OVERLAP_MODES}, got {self.comm_overlap_mode!r}")
        bmb = self.comm_overlap_bucket_mb
        if isinstance(bmb, bool) or not isinstance(bmb, (int, float)) or bmb <= 0:
            raise ValueError(
                "DeepSpeedConfig: comm.overlap.bucket_mb must be a number > 0, "
                f"got {bmb!r}")
        self.comm_overlap_bucket_mb = float(bmb)

        rs_dict = param_dict.get(RESILIENCE, {})
        self._warn_unknown_nested(RESILIENCE, rs_dict, RESILIENCE_CONFIG_KEYS)
        self.resilience_enabled = get_scalar_param(rs_dict, RESILIENCE_ENABLED,
                                                   RESILIENCE_ENABLED_DEFAULT)
        self.resilience_save_dir = get_scalar_param(rs_dict, RESILIENCE_SAVE_DIR,
                                                    RESILIENCE_SAVE_DIR_DEFAULT)
        self.resilience_save_interval = get_scalar_param(rs_dict, RESILIENCE_SAVE_INTERVAL,
                                                         RESILIENCE_SAVE_INTERVAL_DEFAULT)
        self.resilience_async_save = get_scalar_param(rs_dict, RESILIENCE_ASYNC_SAVE,
                                                      RESILIENCE_ASYNC_SAVE_DEFAULT)
        self.resilience_auto_resume = get_scalar_param(rs_dict, RESILIENCE_AUTO_RESUME,
                                                       RESILIENCE_AUTO_RESUME_DEFAULT)
        val = self.resilience_save_interval
        if isinstance(val, bool) or not isinstance(val, int) or val < 0:
            raise ValueError(
                "DeepSpeedConfig: resilience.save_interval must be an int >= 0 "
                f"(0 = no periodic saves), got {val!r}")
        if self.resilience_enabled and self.resilience_save_interval > 0 \
                and not self.resilience_save_dir:
            raise ValueError(
                "DeepSpeedConfig: resilience.save_interval > 0 requires "
                "resilience.save_dir to be set")

        self.sparse_attention = None
        if SPARSE_ATTENTION in param_dict:
            self.sparse_attention = SparseAttentionConfig(param_dict[SPARSE_ATTENTION])

        sp_dict = param_dict.get(SEQUENCE_PARALLEL, {})
        self.sequence_parallel_enabled = get_scalar_param(sp_dict, SEQUENCE_PARALLEL_ENABLED,
                                                          SEQUENCE_PARALLEL_ENABLED_DEFAULT)
        self.sequence_parallel_axis = get_scalar_param(sp_dict, SEQUENCE_PARALLEL_AXIS,
                                                       SEQUENCE_PARALLEL_AXIS_DEFAULT)
        self.sequence_parallel_schedule = get_scalar_param(sp_dict, SEQUENCE_PARALLEL_SCHEDULE,
                                                           SEQUENCE_PARALLEL_SCHEDULE_DEFAULT)

        self.pipeline = get_pipeline_config(param_dict)

    # ---- batch triple inference (reference config.py:562-608) ----
    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per device: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            "Check batch related parameters. train_batch_size is not equal"
            " to micro_batch_per_device * gradient_acc_step * world_size: "
            f"{train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps

        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            return
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= self.world_size
            self.gradient_accumulation_steps = grad_acc
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // self.world_size
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise AssertionError("Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _do_sanity_check(self):
        self._do_error_check()
        self._do_warning_check()
        self._do_compat_check()

    def _do_compat_check(self):
        """Every accepted key must act, warn, or error — never silently no-op
        (reference: config.py:633-670 runs error/warning checks; this adds the
        TPU-migration diagnostics for keys whose CUDA mechanism has no GSPMD
        analog)."""
        if (ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED in self._param_dict
                and not isinstance(self._param_dict.get(ZERO_OPTIMIZATION), bool)):
            logger.warning(f"DeepSpeedConfig: '{ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED}' "
                           "is the deprecated companion of the boolean zero_optimization form and "
                           "is only honored there — ignored (use the zero_optimization block).")
        if self.disable_allgather:
            logger.warning(f"DeepSpeedConfig: '{DISABLE_ALLGATHER}' selects the reference's "
                           "allreduce-instead-of-allgather fallback for its hand-written ZeRO "
                           "collectives; XLA GSPMD chooses collectives from the sharding "
                           "layout here, so the key has no effect.")
        if self.optimizer_legacy_fusion:
            logger.warning(f"DeepSpeedConfig: optimizer '{LEGACY_FUSION}' switches the "
                           "reference's CUDA fused-kernel variant; the TPU optimizer update "
                           "is one XLA-fused jit either way, so the key has no effect.")
        zc = self.zero_config
        if getattr(zc, "explicit_tuning_keys", ()):
            logger.warning("DeepSpeedConfig: zero_optimization buffer-tuning key(s) "
                           f"{list(zc.explicit_tuning_keys)} tune the reference's bucketed "
                           "collectives; GSPMD schedules collectives from shardings here, "
                           "so they have no effect.")
        if getattr(zc, "unknown_keys", ()):
            logger.warning(f"DeepSpeedConfig: unknown zero_optimization key(s) "
                           f"{list(zc.unknown_keys)} — ignored.")
        if zc.elastic_checkpoint is False:
            logger.warning("DeepSpeedConfig: zero_optimization.elastic_checkpoint=false has "
                           "no effect — checkpoints are always elastic-loadable here (the "
                           "loader merges/repartitions optimizer shards across DP sizes).")

    def _do_error_check(self):
        assert self.train_micro_batch_size_per_gpu, (
            f"DeepSpeedConfig: {TRAIN_MICRO_BATCH_SIZE_PER_GPU} is not defined")
        assert self.gradient_accumulation_steps, (
            f"DeepSpeedConfig: {GRADIENT_ACCUMULATION_STEPS} is not defined")
        if self.amp_enabled:
            # reference engine.py:530-531: amp and legacy fp16 are mutually exclusive
            assert not self.fp16_enabled, (
                "DeepSpeedConfig: cannot enable both amp and the fp16 block — pick one "
                "mixed-precision policy (on TPU, prefer the default bf16)")
        if self.zero_enabled:
            # Reference requires fp16 for ZeRO; on TPU any low-precision policy (bf16 default)
            # satisfies the same "mixed precision master weights" contract.
            assert self.fp16_enabled or self.bf16_enabled, (
                "DeepSpeedConfig: ZeRO is only supported if fp16 or bf16 is enabled")
            assert self.zero_optimization_stage <= MAX_STAGE_ZERO_OPTIMIZATION, (
                f"DeepSpeedConfig: Maximum supported ZeRO stage is {MAX_STAGE_ZERO_OPTIMIZATION}")
            if self.zero_config.cpu_offload is True:
                # stage 2 is reference parity; stage 3 + offload (sharded compute
                # params AND host-tier master/moments) composes here because the
                # offload tier is partitioned by the same master layout
                assert self.zero_optimization_stage in (
                    ZERO_OPTIMIZATION_GRADIENTS, ZERO_OPTIMIZATION_WEIGHTS), (
                    "DeepSpeedConfig: cpu-offload requires ZeRO stage "
                    f"{ZERO_OPTIMIZATION_GRADIENTS} or {ZERO_OPTIMIZATION_WEIGHTS}")

    def _do_warning_check(self):
        # Unlike the reference (zero implied fp16), bf16 ZeRO is first-class here: only an
        # actual fp16 wrapper takes over max_grad_norm; bf16/fp32 use engine clipping.
        fp16_enabled = self.fp16_enabled
        if self.communication_data_type == "fp16" and not fp16_enabled:
            # grads are PRODUCED in this dtype (the psum then rides it), so fp16
            # without the loss-scaling block risks overflow even at dp=1
            logger.warning(f"DeepSpeedConfig: {COMMUNICATION_DATA_TYPE}='fp16' without "
                           "the fp16 loss-scaling block: gradients are cast to fp16 "
                           "before reduction and may overflow (|g| > 65504). Prefer "
                           "'bf16', or enable the fp16 block.")
        if (self.allreduce_always_fp32 and self.communication_data_type is not None
                and self.communication_data_type != "fp32"):
            # engine.py resolves the comm dtype with communication_data_type LAST
            # (explicit dtype overrides the blanket fp32 switch) — say so instead of
            # letting the two keys silently disagree
            logger.warning(
                f"DeepSpeedConfig: both '{ALLREDUCE_ALWAYS_FP32}' and "
                f"'{COMMUNICATION_DATA_TYPE}'='{self.communication_data_type}' are set "
                f"with conflicting dtypes; the explicit {COMMUNICATION_DATA_TYPE} wins "
                f"and gradients reduce in {self.communication_data_type}.")
        vocabulary_size = self._param_dict.get(VOCABULARY_SIZE, VOCABULARY_SIZE_DEFAULT)
        if vocabulary_size and vocabulary_size % TENSOR_CORE_ALIGN_SIZE != 0:
            logger.warning("DeepSpeedConfig: vocabulary size {} is not aligned to {}, "
                           "may impact MXU utilization.".format(vocabulary_size, TENSOR_CORE_ALIGN_SIZE))
        if (self.optimizer_params is not None and MAX_GRAD_NORM in self.optimizer_params.keys()
                and self.optimizer_params[MAX_GRAD_NORM] > 0):
            if fp16_enabled:
                logger.warning("DeepSpeedConfig: In FP16 mode, DeepSpeed will pass {}:{} to FP16 wrapper".format(
                    MAX_GRAD_NORM, self.optimizer_params[MAX_GRAD_NORM]))
            elif self.bf16_enabled:
                logger.warning("DeepSpeedConfig: In BF16 mode, {}:{} is applied as engine gradient clipping".format(
                    MAX_GRAD_NORM, self.optimizer_params[MAX_GRAD_NORM]))
                if not self.gradient_clipping:
                    self.gradient_clipping = float(self.optimizer_params[MAX_GRAD_NORM])
                self.optimizer_params[MAX_GRAD_NORM] = 0.0
            else:
                logger.warning("DeepSpeedConfig: In FP32 mode, DeepSpeed does not permit MAX_GRAD_NORM ({}) > 0, "
                               "setting to zero".format(self.optimizer_params[MAX_GRAD_NORM]))
                self.optimizer_params[MAX_GRAD_NORM] = 0.0

    def print(self, name):
        logger.info("{}:".format(name))
        for arg in sorted(vars(self)):
            if arg != "_param_dict":
                dots = "." * (29 - len(arg))
                logger.info("  {} {} {}".format(arg, dots, getattr(self, arg)))
        logger.info("  json = {}".format(
            json.dumps(self._param_dict, sort_keys=True, indent=4, separators=(",", ":"), default=repr)))
