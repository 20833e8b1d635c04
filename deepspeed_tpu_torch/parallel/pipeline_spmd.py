"""The per-rank pipeline executor (PyTorch port).

Counterpart of ``deepspeed_tpu/parallel/pipeline_spmd.py``. The JAX executor
is one program over the mesh: the stage weights stacked on a leading axis
sharded over ``pipe``, the micro-batches streamed through a ``lax.scan``
whose hand-off is one ``ppermute``, and the backward pipeline derived by
``jax.grad``. Here each rank of the pipe group runs its own stage: it holds
only its stage's parameters, and activations move to the next rank by
point-to-point send / receive (paired ``isend`` / ``irecv``, each waited
before its tensor is used, so two ranks that both send and receive never
deadlock; over gloo a CUDA tensor is staged through the host).

``pipeline_apply`` is one ``torch.autograd.Function``. Its forward runs the
GPipe order without a graph: at lockstep step t rank s runs micro-batch
t - s. Only real micro-batches run: the warm-up and drain steps, where the
JAX scan runs ``stage_fn`` on a buffer it then masks, are skipped, so each
rank runs its stage M times a window. The forward keeps each step's stage
input (GPipe with the stage body recomputed, as the JAX executor's
``jax.checkpoint``). Its backward is an explicit loop over the steps in
reverse: each real step recomputes its stage with a graph, differentiates it
with ``torch.autograd.grad`` against the gradient received from the next
rank, and sends the input gradient to the previous one. The collectives run
in the same order on every rank: a step's head (the collective last stage),
then its ingest (the first stage), then the step's exchange. The head and
the ingest take their collectives through ``psum`` (sum all-reduce forward
and backward, the transpose of JAX's ``psum``) and ``pmax`` (no gradient).
A rank therefore launches each layer of its stage's forward twice and its
backward once for every micro-batch of the window.

Gradient convention (JAX's under ``shard_map``): a loss the last stage
broadcasts counts once; a collective head runs on every rank and each rank's
share of the loss's gradient enters it scaled by 1 / S, so that ``psum``'s
backward sums it back; the gradients of arguments replicated over ``pipe``
are summed over the pipe group at the end (``shard_map``'s transpose of an
unmapped input). The data axis is not this function's: it returns this
data replica's loss and gradient, and the engine averages over the data
group.

At M > ``max_microbatches_per_flush`` (default 4 S) the window splits into
segments of ``cap`` micro-batches (the largest divisor of M not above the
cap): streamed (the default) keeps one pipeline fill for the whole window
and stores only each segment's arriving activation, replaying one segment's
forward (its exchanges and ingests too) before stepping back through it;
``stream_segments=False`` runs each segment as a pipeline of its own, filled
and drained (``_flushed_apply``'s schedule). Both give the unsplit loss and
gradients; ``flush_schedule`` counts their lockstep steps.

Argument specs: ``last_stage_args`` need explicit ``last_stage_args_specs``
whenever there are any: the port refuses to guess, as JAX's
``_flushed_apply`` does (JAX's ``_infer_specs`` guesses from the leading
dimension when the window is not split). A spec is ``"mb"`` (micro-batched:
the leading dimension is the micro-batch index), ``"rep"`` (replicated over
the pipe group) or ``"pipe"`` (this rank's slice), given for a whole
argument or as a tree matching it; ``first_stage_args`` default to ``"rep"``.
"""

import contextlib
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import PIPE_AXIS

SPECS = ("mb", "rep", "pipe")


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage trees into leaves with a leading stage axis."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def flush_schedule(M: int, S: int, cap: int, streamed: bool = True):
    """Lockstep-step accounting for an M-micro-batch window on an S-stage pipe
    with segments of ``cap`` micro-batches (a copy of
    deepspeed_tpu/parallel/pipeline_spmd.py:73-90).

    ``ideal_steps`` is the single-fill optimum ``M + S - 1``. The streamed
    schedule achieves it; the per-flush one drains every flush:
    ``(M / cap) * (cap + S - 1)`` steps. Returns ``{steps, ideal_steps,
    n_segments, bubble_fraction}``, bubble_fraction = 1 - M / steps."""
    assert M % cap == 0, f"window M={M} must divide into segments of {cap}"
    n = M // cap
    steps = (M + S - 1) if streamed else n * (cap + S - 1)
    return {"steps": steps, "ideal_steps": M + S - 1, "n_segments": n,
            "bubble_fraction": 1.0 - M / steps}


# ---------------------------------------------------------------------------
# collectives over the pipe group
# ---------------------------------------------------------------------------

def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    out = t.contiguous().clone()
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient summed over it too (JAX's
    ``psum`` and its transpose). ``group`` None: one rank, the identity."""
    return x if group is None else _PSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group``, without gradient."""
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def _staged(t, group):
    """Whether ``t`` crosses ``group`` through the host (gloo takes CPU
    tensors for point-to-point)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def exchange(send, dst, recv_like, src, group):
    """Send ``send`` to pipe rank ``dst`` and receive a tensor shaped like
    ``recv_like`` from pipe rank ``src`` (either side None: nothing), the two
    posted together and both waited. Returns the received tensor or None."""
    if group is None or (send is None and recv_like is None):
        return None
    works, host_in = [], None
    if send is not None:
        buf = send.detach().contiguous()
        if _staged(buf, group):
            buf = buf.cpu()
        works.append(dist.isend(buf, dist.get_global_rank(group, dst), group=group))
    if recv_like is not None:
        host_in = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                              device="cpu" if _staged(recv_like, group) else recv_like.device)
        works.append(dist.irecv(host_in, dist.get_global_rank(group, src), group=group))
    for w in works:
        w.wait()
    if host_in is None:
        return None
    return host_in.to(recv_like.device)


class RngState:
    """torch's global random state at one moment (the CPU generator's and, on
    a CUDA device, that device's), to run a stage again on the same draws:
    a recompute sees the dropout masks of the forward it repeats, as
    ``torch.utils.checkpoint`` arranges."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cpu = torch.get_rng_state()
        self.cuda = (torch.cuda.get_rng_state(self.device) if self.device.type == "cuda"
                     else None)

    @contextlib.contextmanager
    def replay(self):
        """The recorded state while open; the state before it after."""
        with torch.random.fork_rng(devices=[self.device] if self.cuda is not None else []):
            torch.set_rng_state(self.cpu)
            if self.cuda is not None:
                torch.cuda.set_rng_state(self.cuda, self.device)
            yield


def _drawn(rngs, key, device, fn, *args):
    """``fn(*args)`` on the random state recorded under ``key`` in ``rngs``;
    the first call records it."""
    snap = rngs.get(key)
    if snap is None:
        rngs[key] = RngState(device)
        return fn(*args)
    with snap.replay():
        return fn(*args)


def vjp(output, inputs, cotangent):
    """``torch.autograd.grad(output, inputs, cotangent, allow_unused=True)``,
    taken as the gradient of ``sum(output * cotangent)``: the same values
    (the product's backward multiplies ``cotangent`` by one), without torch's
    explicit-gradient path, whose first call in a process imports
    ``torch.fx.experimental.symbolic_shapes`` and, where triton is
    installed, ``torch._dynamo`` with it (14-29 s on the card's host)."""
    return torch.autograd.grad((output * cotangent).sum(), inputs, allow_unused=True)


def _specs_for(args, specs, default):
    """Each leaf's spec: ``specs`` broadcast over ``args`` (a spec string
    covers its whole subtree), or ``default`` everywhere."""
    out = []
    for i, arg in enumerate(args):
        spec = default if specs is None else specs[i]
        if isinstance(spec, str):
            if spec not in SPECS:
                raise ValueError(f"pipeline_apply: spec {spec!r} is not one of {SPECS}")
            out.extend([spec] * len(pytree.tree_leaves(arg)))
        else:
            leaves = pytree.tree_leaves(spec)
            if len(leaves) != len(pytree.tree_leaves(arg)) or any(s not in SPECS for s in leaves):
                raise ValueError(f"pipeline_apply: spec tree {spec!r} does not match its "
                                 f"argument or names a spec outside {SPECS}")
            out.extend(leaves)
    return out


def _wants_grad(t):
    return isinstance(t, torch.Tensor) and t.requires_grad


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class _Runner:
    """The window's schedule on this rank: ``runs`` is a list of (lo, hi,
    cap, replay) — micro-batches [lo, hi) through one pipeline fill and
    drain, in segments of ``cap``; with ``replay`` the forward keeps only
    each segment's arriving activation and the backward replays the
    segment, else it keeps every step's input."""

    def __init__(self, stage_fn, M, S, s, group, runs, first_stage_fn, first_args,
                 last_stage_fn, last_args, last_collective, last_pre=None):
        self.stage_fn, self.M, self.S, self.s, self.group = stage_fn, M, S, s, group
        self.runs = runs
        self.first_stage_fn, self.first_args = first_stage_fn, first_args
        self.last_stage_fn, self.last_args = last_stage_fn, last_args
        self.last_collective = last_collective
        self.last_pre = last_pre
        self._head_like = None

    # -- per-step pieces -------------------------------------------------
    def valid(self, lo, hi, t, s):
        j = lo + t - s
        return lo <= j < hi

    def ingest(self, x_mb, j, rngs=None):
        x0 = x_mb[j]
        if self.first_stage_fn is not None:
            x0 = (self.first_stage_fn(x0, *self.first_args) if rngs is None else
                  _drawn(rngs, ("in", j), x_mb.device, self.first_stage_fn, x0,
                         *self.first_args))
        return x0

    def head(self, y, j):
        return self.last_stage_fn(y, *self.last_args, j)

    def pre(self, y):
        """The collective head's rank-local prefix, on the last stage only."""
        return y if self.last_pre is None else self.last_pre(y, *self.last_args)

    def head_like(self, like):
        """A tensor shaped as what the last stage broadcasts to the head."""
        if self._head_like is None:
            with torch.no_grad():
                self._head_like = torch.zeros_like(self.pre(like))
        return self._head_like

    def step_input(self, x_mb, lo, hi, t, buf, rngs):
        """(ingest output or None, this rank's stage input at step t or
        None). Every rank ingests on a step that loads a micro-batch (the
        first stage may hold collectives); only stage 0 keeps it."""
        x0 = self.ingest(x_mb, lo + t, rngs) if lo + t < hi and (
            self.first_stage_fn is not None or self.s == 0) else None
        if not self.valid(lo, hi, t, self.s):
            return x0, None
        return x0, (x0 if self.s == 0 else buf)

    def forward_exchange(self, lo, hi, t, y, like):
        """Send this step's output on, receive the previous stage's."""
        s, S = self.s, self.S
        send = y if s < S - 1 and self.valid(lo, hi, t, s) else None
        recv = like if s > 0 and self.valid(lo, hi, t, s - 1) else None
        return exchange(send, s + 1, recv, s - 1, self.group)

    def backward_exchange(self, lo, hi, t, dx, like):
        """Send this step's input gradient back, receive the next stage's."""
        s, S = self.s, self.S
        send = dx if s > 0 and self.valid(lo, hi, t, s) else None
        recv = like if s < S - 1 and self.valid(lo, hi, t, s + 1) else None
        return exchange(send, s - 1, recv, s + 1, self.group)

    def broadcast_last(self, y, like):
        """The last stage's output on every rank (a sum over the pipe group
        of it and zeros)."""
        mine = y if self.s == self.S - 1 else torch.zeros_like(like)
        return _all_reduce(mine, self.group)

    # -- forward ---------------------------------------------------------
    def forward(self, x_mb):
        """The window's loss (float32, this rank's copy) and what the
        backward needs: per run, the stored stage inputs by step (every step
        of an unsegmented run; of a segmented one, each segment's arriving
        activation and the drain's inputs) and the random state of each of
        its draws (``RngState``: the recomputes repeat them)."""
        dev = x_mb.device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        saved = []
        for lo, hi, cap, segmented in self.runs:
            n = hi - lo
            inputs, carries, rngs, buf, like = {}, {}, {}, None, None
            for t in range(n + self.S - 1):
                if segmented and t < n and t % cap == 0:
                    carries[t] = buf
                x0, x_in = self.step_input(x_mb, lo, hi, t, buf, rngs)
                if like is None:
                    like = x0 if x0 is not None else self.ingest(x_mb, lo)
                y = None
                if x_in is not None:
                    if not segmented or t >= n:
                        inputs[t] = x_in
                    y = _drawn(rngs, ("stage", t), dev, self.stage_fn, x_in)
                j = lo + t - (self.S - 1)
                if lo <= j < hi:
                    if self.last_collective:
                        h = (_drawn(rngs, ("pre", t), dev, self.pre, y)
                             if self.s == self.S - 1 else None)
                        loss = loss + _drawn(rngs, ("head", t), dev, self.head,
                                             self.broadcast_last(h, self.head_like(like)),
                                             j).float()
                    elif self.s == self.S - 1:
                        loss = loss + _drawn(rngs, ("head", t), dev, self.head, y, j).float()
                buf = self.forward_exchange(lo, hi, t, y, like)
            saved.append((inputs, carries, rngs, like))
        return loss, saved

    def replay(self, x_mb, lo, hi, t0, t1, buf, like, inputs, rngs):
        """The forward of steps [t0, t1) again from ``buf`` (the activation
        arriving at t0) on the recorded draws, keeping each step's stage
        input in ``inputs``."""
        for t in range(t0, t1):
            _, x_in = self.step_input(x_mb, lo, hi, t, buf, rngs)
            y = None
            if x_in is not None:
                inputs[t] = x_in
                y = _drawn(rngs, ("stage", t), x_mb.device, self.stage_fn, x_in)
            buf = self.forward_exchange(lo, hi, t, y, like)

    # -- backward --------------------------------------------------------
    def backward(self, x_mb, saved, g, params, first_leaves, last_leaves, x_grad):
        """The window's gradients: {position: grad} over ``params``,
        ``first_leaves`` and ``last_leaves`` (lists of (position, tensor)
        for the leaves that require grad), and the gradient of ``x_mb`` when
        ``x_grad``."""
        S, M = self.S, self.M
        acc = {}

        def add(picked, gs):
            # each leaf's window sum in float32, rounded once at the end
            for (i, _), gr in zip(picked, gs):
                if gr is not None:
                    acc[i] = gr.float() if i not in acc else acc[i].add_(gr.float())

        dx_mb = torch.zeros_like(x_mb) if x_grad else None
        # the loss's gradient as it enters each head: a collective head runs
        # on every rank and psum's backward sums its shares
        ct = g / M / (S if self.last_collective else 1)
        for (lo, hi, cap, segmented), (inputs, carries, rngs, like) in zip(
                reversed(self.runs), reversed(saved)):
            n = hi - lo
            segs = [(n, n + S - 1)]
            if segmented:
                segs += [(f, f + cap) for f in range(n - cap, -1, -cap)]
            else:
                segs.append((0, n))
            dy = None
            for t0, t1 in segs:
                if t0 in carries:
                    self.replay(x_mb, lo, hi, t0, t1, carries[t0], like, inputs, rngs)
                for t in range(t1 - 1, t0 - 1, -1):
                    dy = self.backward_step(x_mb, lo, hi, t, inputs, rngs, dy, like, ct,
                                            params, first_leaves, last_leaves, add, dx_mb)
                    inputs.pop(t, None)
        return acc, dx_mb

    def backward_step(self, x_mb, lo, hi, t, inputs, rngs, dy, like, ct, params,
                      first_leaves, last_leaves, add, dx_mb):
        S, s = self.S, self.s
        dev = x_mb.device
        last_ts = [t_ for _, t_ in last_leaves]
        real = self.valid(lo, hi, t, s)
        x_in = inputs.get(t) if real else None
        y = xg = None
        with torch.enable_grad():
            if real:
                xg = x_in.detach().requires_grad_(x_in.is_floating_point())
                y = _drawn(rngs, ("stage", t), dev, self.stage_fn, xg)
            j = lo + t - (S - 1)
            if lo <= j < hi:
                if self.last_collective:
                    hy = _drawn(rngs, ("pre", t), dev, self.pre, y) if s == S - 1 else None
                    yb = self.broadcast_last(None if hy is None else hy.detach(),
                                             self.head_like(like))
                    yb.requires_grad_(True)
                    h = _drawn(rngs, ("head", t), dev, self.head, yb, j).float()
                    grads = vjp(h, [yb] + last_ts, ct)
                    add(last_leaves, grads[1:])
                    # the ranks' shares of the head's input gradient, summed
                    d_yb = _all_reduce(grads[0], self.group)
                    if s == S - 1 and self.last_pre is None:
                        dy = d_yb
                    elif s == S - 1:
                        grads = vjp(hy, [y] + last_ts, d_yb)
                        add(last_leaves, grads[1:])
                        dy = grads[0]
                elif s == S - 1:
                    h = _drawn(rngs, ("head", t), dev, self.head, y, j).float()
                    grads = vjp(h, [y] + last_ts, ct)
                    add(last_leaves, grads[1:])
                    dy = grads[0]
            dx = None
            if real:
                inputs_ = [t_ for _, t_ in params] + ([xg] if xg.requires_grad else [])
                grads = vjp(y, inputs_, dy)
                add(params, grads[:len(params)])
                dx = grads[len(params)] if xg.requires_grad else None
            if lo + t < hi and (first_leaves or dx_mb is not None):
                # the ingest of micro-batch lo + t, stage 0's input at step t:
                # its gradient is stage 0's, zeros elsewhere
                xj = x_mb[lo + t].detach().requires_grad_(dx_mb is not None)
                x0 = (_drawn(rngs, ("in", lo + t), dev, self.first_stage_fn, xj,
                             *self.first_args) if self.first_stage_fn is not None else xj)
                cot = dx if s == 0 and dx is not None else torch.zeros_like(x0)
                wrt = [t_ for _, t_ in first_leaves] + ([xj] if dx_mb is not None else [])
                if x0.requires_grad:
                    grads = vjp(x0, wrt, cot)
                    add(first_leaves, grads[:len(first_leaves)])
                    if dx_mb is not None and grads[-1] is not None:
                        dx_mb[lo + t] += grads[-1]
        return self.backward_exchange(lo, hi, t, dx, like)


class _PipelineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, runner, n_params, n_first, n_last, x_mb, *leaves):
        ctx.runner = runner
        ctx.split = (n_params, n_first, n_last)
        ctx.x_mb = x_mb
        ctx.leaves = leaves
        loss, ctx.saved = runner.forward(x_mb)
        if not runner.last_collective:
            mine = loss if runner.s == runner.S - 1 else torch.zeros_like(loss)
            loss = _all_reduce(mine, runner.group)
        return loss / runner.M

    @staticmethod
    def backward(ctx, g):
        r = ctx.runner
        n_params, n_first, n_last = ctx.split
        leaves = list(ctx.leaves)

        def pick(lo, hi):
            return [(i, leaves[i]) for i in range(lo, hi) if _wants_grad(leaves[i])]

        x_grad = _wants_grad(ctx.x_mb)
        acc, dx_mb = r.backward(ctx.x_mb, ctx.saved, g.float(), pick(0, n_params),
                                pick(n_params, n_params + n_first),
                                pick(n_params + n_first, len(leaves)), x_grad)
        ctx.saved = None
        # replicated arguments: their gradient is the sum over the pipe group
        # (every rank issues these all-reduces, in argument order, in float32:
        # a rank that never used the argument adds zeros)
        out = []
        for i, t in enumerate(leaves):
            gr = acc.get(i)
            if _wants_grad(t) and r.replicated[i]:
                gr = _all_reduce(gr if gr is not None else torch.zeros(
                    t.shape, dtype=torch.float32, device=t.device), r.group)
            out.append(None if gr is None else gr.to(t.dtype))
        if dx_mb is not None:
            dx_mb = _all_reduce(dx_mb, r.group)
        return (None, None, None, None, dx_mb, *out)


def pipeline_apply(stage_fn: Callable,
                   stage_params,
                   x_microbatches,
                   *,
                   mesh,
                   last_stage_fn: Callable = None,
                   last_stage_args=(),
                   first_stage_fn: Callable = None,
                   first_stage_args=(),
                   last_stage_args_specs=None,
                   first_stage_args_specs=None,
                   last_stage_collective: bool = False,
                   last_stage_pre_fn: Callable = None,
                   max_microbatches_per_flush: int = None,
                   stream_segments: bool = True):
    """Run micro-batches through this rank's stage of the pipe group.

    Args:
      stage_fn: homogeneous per-stage function ``(stage_params, x) -> y``
        (y shaped as x), applied by every pipe rank to its own parameters.
      stage_params: this rank's stage parameters (a tree of tensors; the
        JAX executor's slice of the stacked tree).
      x_microbatches: [M, ...] micro-batches entering stage 0, the same on
        every rank of the pipe group.
      mesh: a ``parallel.mesh.Mesh`` (its pipe axis: the group, this rank's
        stage, S).
      last_stage_fn: ``(y, *last_stage_args, mb) -> scalar`` on each
        micro-batch's final activation (head + loss). Returns the mean over
        the micro-batches, the same on every rank. None: the [M, ...]
        outputs on every rank, without gradient.
      first_stage_fn: ``(x_mb[j], *first_stage_args) -> activation`` before
        stage 0 (the embedding); it runs on every rank, so it may use pipe
        collectives (``psum``) over pipe-sharded arguments.
      last_stage_collective: when True, ``last_stage_fn`` runs on every rank
        against the last stage's output broadcast over the group and may
        use pipe collectives (the vocab-parallel head and loss).
      last_stage_pre_fn: with ``last_stage_collective``, ``(y,
        *last_stage_args) -> h`` on the last rank alone before the broadcast
        (the head's rank-local prefix, e.g. ``ln_f``); ``last_stage_fn``
        then takes h. Its backward runs once, on the sum of the ranks'
        shares of h's gradient (in h's dtype): the head's rounding is the
        one-rank model's. The JAX executor broadcasts y and runs the whole
        head on every rank; the loss is the same function.
      max_microbatches_per_flush / stream_segments: the segmentation (see
        the module docstring); 0 disables it.

    Differentiable in ``stage_params``, floating ``x_microbatches`` and the
    floating leaves of the stage arguments that require grad."""
    M = x_microbatches.shape[0]
    S = mesh.shape[PIPE_AXIS]
    s = mesh.axis_index(PIPE_AXIS)
    group = mesh.group(PIPE_AXIS)
    if last_stage_args and last_stage_args_specs is None:
        raise ValueError(
            "pipeline_apply: last_stage_args need explicit last_stage_args_specs ('mb' for a "
            "micro-batched leaf, 'rep' for one replicated over pipe, 'pipe' for this rank's "
            "slice): a leading dimension equal to M does not tell labels from a weight")
    first_specs = _specs_for(first_stage_args, first_stage_args_specs, "rep")
    last_specs = _specs_for(last_stage_args, last_stage_args_specs, "rep")

    if last_stage_fn is None:
        if torch.is_grad_enabled() and (_wants_grad(x_microbatches) or any(
                _wants_grad(t) for t in pytree.tree_leaves(stage_params))):
            raise NotImplementedError(
                "pipeline_apply without last_stage_fn returns the outputs without gradient")
        return _outputs(stage_fn, stage_params, x_microbatches, S, s, group,
                        first_stage_fn, first_stage_args)

    cap = 4 * S if max_microbatches_per_flush is None else max_microbatches_per_flush
    runs = [(0, M, M, False)]
    if cap > 0 and M > cap:
        cap_eff = max(d for d in range(1, cap + 1) if M % d == 0)
        if cap_eff < max(2, cap // 2):
            import logging
            logging.getLogger("DeepSpeedTPU").warning(
                f"pipeline flush split: window M={M} has no divisor near the cap "
                f"{cap} (best {cap_eff}); %s. Choose M a multiple of a value <= "
                f"{cap} for the documented memory bound.",
                "running a SINGLE unsplit flush (memory grows with M)"
                if cap_eff < 2 else f"running {M // cap_eff} flushes of {cap_eff}")
        if cap_eff >= 2:
            runs = ([(0, M, cap_eff, True)] if stream_segments else
                    [(lo, lo + cap_eff, cap_eff, True) for lo in range(0, M, cap_eff)])

    params = pytree.tree_leaves(stage_params)
    first_leaves = pytree.tree_leaves(first_stage_args)
    last_leaves = pytree.tree_leaves(last_stage_args)

    def body(x):
        return stage_fn(stage_params, x)

    runner = _Runner(body, M, S, s, group, runs, first_stage_fn, first_stage_args,
                     last_stage_fn, last_stage_args, last_stage_collective,
                     last_stage_pre_fn if last_stage_collective else None)
    runner.replicated = ([False] * len(params) + [sp != "pipe" for sp in first_specs]
                         + [sp != "pipe" for sp in last_specs])
    return _PipelineFn.apply(runner, len(params), len(first_leaves), len(last_leaves),
                             x_microbatches, *params, *first_leaves, *last_leaves)


@torch.no_grad()
def _outputs(stage_fn, stage_params, x_mb, S, s, group, first_stage_fn, first_args):
    """The forward-only form: every micro-batch's last-stage output, [M, ...],
    on every rank."""
    M = x_mb.shape[0]
    runner = _Runner(lambda x: stage_fn(stage_params, x), M, S, s, group, [(0, M, M, False)],
                     first_stage_fn, first_args, None, (), False)
    outs, buf, like = None, None, None
    for t in range(M + S - 1):
        x0, x_in = runner.step_input(x_mb, 0, M, t, buf, None)
        if like is None:
            like = x0 if x0 is not None else runner.ingest(x_mb, 0)
            outs = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype, device=like.device)
        y = stage_fn(stage_params, x_in) if x_in is not None else None
        j = t - (S - 1)
        if s == S - 1 and 0 <= j < M:
            outs[j] = y
        buf = runner.forward_exchange(0, M, t, y, like)
    return _all_reduce(outs, group)
