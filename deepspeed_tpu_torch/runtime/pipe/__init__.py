"""The pipeline schedules (``schedule.py``) and the pipeline engine
(``engine.py``: ``PipelineEngine``, imported from there, so that importing the
schedules does not load the training engine)."""

from .schedule import (PipeSchedule, InferenceSchedule, TrainSchedule, DataParallelSchedule,
                       PipeInstruction, OptimizerStep, ReduceGrads, ReduceTiedGrads,
                       LoadMicroBatch, ForwardPass, BackwardPass, SendActivation,
                       RecvActivation, SendGrad, RecvGrad)
