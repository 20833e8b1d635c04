from .schedule import (PipeSchedule, InferenceSchedule, TrainSchedule, DataParallelSchedule,
                       PipeInstruction, OptimizerStep, ReduceGrads, ReduceTiedGrads,
                       LoadMicroBatch, ForwardPass, BackwardPass, SendActivation,
                       RecvActivation, SendGrad, RecvGrad)
