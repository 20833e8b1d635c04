from .loss_scaler import LossScaleState, init_state, update
from .fused_optimizer import FP16_Optimizer, FP16_UnfusedOptimizer
