"""PyTorch port: a copy of ``deepspeed_tpu/runtime/pipe/schedule.py`` (lines
1-275), pure Python, which ``utils/pipeline_trace.py`` replays and
``runtime/pipe/engine.py``'s instruction executor runs.

Pipeline instruction schedules.

Mirrors ``deepspeed/runtime/pipe/schedule.py`` exactly at the instruction-stream level:
``TrainSchedule`` produces the PipeDream-flush (1F1B) interleave via the even/odd
step-to-micro-batch mapping (reference schedule.py:249-289), ``InferenceSchedule`` the
two-buffer forward stream, and the instruction classes are the atomic vocabulary the
engine executes. Streams are pure Python and deterministic — they are also what the SPMD
executor lowers into its in-graph loop structure, and what the schedule-parity unit tests
assert against.
"""

from abc import ABC, abstractmethod



def call_to_str(base, *args, **kwargs) -> str:
    """Construct a string representation of a call: call_to_str('f', 1, b=2) == 'f(1, b=2)'
    (deepspeed_tpu/runtime/utils.py:36-46)."""
    name = f"{base}("
    if args:
        name += ", ".join(str(arg) for arg in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join(f"{key}={arg}" for key, arg in kwargs.items())
    name += ")"
    return name


def _is_even(x):
    return x % 2 == 0


def _is_odd(x):
    return x % 2 != 0


class PipeSchedule(ABC):
    """Generates sequences of PipeInstruction lists; each yielded list is one atomic step
    (barrier-safe between steps)."""

    def __init__(self, micro_batches, stages, stage_id):
        super().__init__()
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield one list of PipeInstruction per schedule step."""
        raise NotImplementedError()

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        self.it = None
        return self

    def __next__(self):
        if self.it is None:
            self.it = self.steps()
        return next(self.it)


class InferenceSchedule(PipeSchedule):
    """Forward-only stream with two alternating buffers; even/odd stages order their
    send/recv oppositely so the blocking p2p pairs rendezvous without deadlock."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id

            if _is_even(self.stage_id):
                recv_buf = step_id % 2
                send_buf = (step_id + 1) % 2
            else:
                recv_buf = (step_id + 1) % 2
                send_buf = step_id % 2

            if self.is_first_stage or self.is_last_stage:
                if self._valid_micro_batch(micro_batch_id):
                    cmds.append(LoadMicroBatch(recv_buf))

            if _is_even(self.stage_id):
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
            else:
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))

            if self._valid_micro_batch(micro_batch_id):
                cmds.append(ForwardPass(recv_buf))

            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B training stream: forwards and backwards interleave once the pipe fills, so
    at most ``stages - stage_id + 1`` activations are live per stage.

    The whole schedule follows from two latencies (see ``_step_to_micro_batch``):
    micro-batch 0's forward reaches stage s at step s, and its backward returns to
    stage s at step ``2*stages - s - 1``; every stage then alternates F/B locally.
    Stream-level behavior is pinned to the reference's
    (deepspeed/runtime/pipe/schedule.py TrainSchedule) by the schedule parity tests.
    """

    def steps(self):
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        last_mb = -1  # micro-batch this stage touched on the previous step
        for step_id in range(total_steps):
            mb, fwd = self._step_to_micro_batch(step_id)
            live = self._valid_micro_batch(mb)
            retiring = self._valid_micro_batch(last_mb)
            cmds = []

            # Boundary traffic first, pairing this step's recv with the LAST
            # micro-batch's opposite-direction send: both sides of a stage boundary
            # then issue their matching transfer within the same merged step, which
            # is what lets blocking pairwise exchanges rendezvous.
            if fwd and self._valid_stage(self.prev_stage):
                if live:
                    cmds.append(RecvActivation(self._buffer_idx(mb)))
                if retiring:
                    cmds.append(SendGrad(self._buffer_idx(last_mb)))
            elif not fwd and self._valid_stage(self.next_stage):
                if retiring:
                    cmds.append(SendActivation(self._buffer_idx(last_mb)))
                if live:
                    cmds.append(RecvGrad(self._buffer_idx(mb)))

            if live:
                # only the pipe endpoints touch the dataloader (inputs at stage 0,
                # labels at the loss stage)
                if fwd and (self.is_first_stage or self.is_last_stage):
                    cmds.append(LoadMicroBatch(self._buffer_idx(mb)))
                cmds.append((ForwardPass if fwd else BackwardPass)(self._buffer_idx(mb)))

            if step_id == total_steps - 1:  # whole batch drained: reduce + step
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            last_mb = mb
            yield cmds

    def num_pipe_buffers(self):
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        """(micro_batch_id, is_forward) for this stage at a global step.

        Two closed forms cover the whole interleave. Forwards: micro-batch f's
        activation reaches stage s at step ``s + 2f`` (one step of fill latency per
        stage, one F and one B per micro-batch thereafter), so on steps with the
        stage's own parity ``f = (step - s) / 2``. Backwards: micro-batch 0's
        gradient returns to stage s at step ``2*stages - s - 1`` (down the pipe and
        back), so on opposite-parity steps ``b = (step - (2*stages - s - 1)) / 2``.
        Out-of-range ids simply mean the stage idles that step.
        """
        offset = step_id - self.stage_id
        if offset % 2 == 0:
            return offset // 2, True
        return (step_id - (2 * self.stages - self.stage_id - 1)) // 2, False


class DataParallelSchedule(PipeSchedule):
    """Plain DP with gradient accumulation, expressed as a pipeline schedule."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


class PipeInstruction:
    """Atomic engine instruction; kwargs become attributes (namedtuple-style)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        # sorted kwargs: two equal instructions built with different keyword
        # orders must print identically (schedule goldens / lint diffs)
        return call_to_str(self.name, **{k: self.kwargs[k] for k in sorted(self.kwargs)})

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass
