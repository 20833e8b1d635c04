"""DeepSpeedCPUAdam: host-memory Adam for ZeRO-Offload (PyTorch port).

Counterpart of ``deepspeed_tpu/ops/cpu_adam.py`` over the port's own copy of
the native kernel, ``csrc/cpu_adam.cpp`` (built by g++ at first use,
``ops/_build.py``; a failed build raises). The float32 master and both Adam
moments live in the host's memory as one flat buffer each, over this rank's
ZeRO slices: the engine hands one float32 leaf per parameter (its ``zero_spec``
slice), so each leaf is one region of the flat buffers and the JAX package's
device-index map has no counterpart.

``adam_step_native`` is the kernel's wrapper: its inputs always lie in host
memory, so it always runs the native kernel and counts its launches;
``cpu_adam_plain`` is its plain PyTorch version (the same operations in the
same order, on CPU tensors), for the tests and the chip check.

The pipelined step (``begin_grad_fetch`` + ``step_regions``, the JAX
package's K-deep pipeline; the reference's async D2H grad copies and
``ds_adam_step_plus_copy`` H2D push, stage2.py:750-907): each region larger
than the chunk cap is cut into chunks (``chunk_spans``), and three lanes
overlap. On the card:

- fetch: a chunk's D2H runs on a side stream into a pinned ring of K chunk
  buffers, with an event per chunk; the side stream first waits on an event
  the compute stream records once the grads are final;
- host Adam: the caller's thread waits on the chunk's event and runs the
  native step, which reads the grads in the dtype the card keeps them in and
  writes the compute-dtype copy of the updated master into a pinned staging
  ring of K slots;
- push: the H2D ``copy_(..., non_blocking=True)`` of a staging slot into the
  device parameter's flat slice runs on a second stream (which also waited on
  the grads); a slot is reused only after its own event has fired, and the
  compute stream waits on the push stream before the next forward.

Only the rings are pinned: pinning tens of GB of master and moments would
cost ``cudaHostAlloc`` time and can hit ``RLIMIT_MEMLOCK``. CPU tensors (the
tests) take plain copies through the same executors; there are no streams.
The executors are the JAX package's: serial (every transfer inline when its
future is read, no chunking) and pipelined (one fetch and one push thread;
the ctypes kernel, ``copy_`` and the event waits release the GIL). The chunk
cap is autotuned once from the first pipelined step's rates unless pinned by
``max_region_elements``.
"""

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..runtime.zero.sharding import chunk_spans
from . import _build

#: pre-autotune pipeline chunk cap (elements): small enough that even the first
#: step of a 400M-element region pipelines, large enough to amortize dispatch
_DEFAULT_REGION_CAP = 8 << 20

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def load_cpu_adam() -> ctypes.CDLL:
    """The native CPU Adam, built for this host at first use; raises on a
    failed build or load."""
    lib = _build.load_host("cpu_adam")
    if not hasattr(lib, "_ds_bound"):
        ptr = ctypes.c_void_p
        common = [ctypes.c_int64, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                  ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                  ctypes.c_int32, ctypes.c_int32]
        lib.ds_adam_step.argtypes = [ptr] * 4 + common
        lib.ds_adam_step.restype = None
        for g in ("f32", "bf16", "f16"):
            for o in ("bf16", "f16"):
                fn = getattr(lib, f"ds_adam_step_{g}_copy_{o}")
                fn.argtypes = [ptr] * 5 + common
                fn.restype = None
        lib.ds_adam_step_copy.argtypes = [ptr] * 5 + common
        lib.ds_adam_step_copy.restype = None
        lib.ds_adam_threads.argtypes = []
        lib.ds_adam_threads.restype = ctypes.c_int32
        lib.ds_adam_set_threads.argtypes = [ctypes.c_int32]
        lib.ds_adam_set_threads.restype = None
        lib._ds_bound = True
    return lib


def _check_host(name, t, dtypes, n):
    if t.device.type != "cpu" or not t.is_contiguous() or t.dtype not in dtypes \
            or t.numel() != n:
        raise ValueError(f"cpu_adam: {name} must be a contiguous CPU tensor of {n} "
                         f"elements in {[str(d) for d in dtypes]}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def adam_step_native(p, g, m, v, out=None, *, step, lr, beta1, beta2, eps, weight_decay,
                     grad_scale=1.0, adamw=True, bias_correction=True):
    """One Adam step of the native kernel over flat host tensors, in place:
    ``p``, ``m``, ``v`` float32; ``g`` float32 (or bf16 / fp16 with ``out``);
    ``out`` None or the bf16 / fp16 copy of the updated ``p``."""
    n = p.numel()
    for name, t in (("p", p), ("m", m), ("v", v)):
        _check_host(name, t, (torch.float32,), n)
    lib = load_cpu_adam()
    if out is None:
        _check_host("g", g, (torch.float32,), n)
        fn, ptrs = lib.ds_adam_step, (p, g, m, v)
    else:
        _check_host("g", g, tuple(_SUFFIX), n)
        _check_host("out", out, (torch.bfloat16, torch.float16), n)
        fn = getattr(lib, f"ds_adam_step_{_SUFFIX[g.dtype]}_copy_{_SUFFIX[out.dtype]}")
        ptrs = (p, g, m, v, out)
    adam_step_native.launches += 1
    fn(*(t.data_ptr() for t in ptrs), n, int(step), float(lr), float(beta1), float(beta2),
       float(eps), float(weight_decay), float(grad_scale), int(bool(adamw)),
       int(bool(bias_correction)))


adam_step_native.launches = 0


@torch.no_grad()
def cpu_adam_plain(p, g, m, v, out=None, *, step, lr, beta1, beta2, eps, weight_decay,
                   grad_scale=1.0, adamw=True, bias_correction=True):
    """The plain version of ``adam_step_native``: the kernel's operations in
    its order, in float32 on CPU tensors, in place."""
    f32 = np.float32
    bc1 = bc2 = f32(1.0)
    if bias_correction:
        bc1 = f32(1.0) - np.power(f32(beta1), f32(step))
        bc2 = f32(1.0) - np.power(f32(beta2), f32(step))
    inv_bc1 = float(f32(1.0) / bc1)
    inv_sqrt_bc2 = float(f32(1.0) / np.sqrt(bc2))
    omb1, omb2 = float(f32(1.0) - f32(beta1)), float(f32(1.0) - f32(beta2))
    l2 = 0.0 if adamw else float(f32(weight_decay))
    wdf = float(f32(lr) * f32(weight_decay)) if adamw else 0.0
    grad = g.float() * float(f32(grad_scale)) + p * l2
    m.copy_(m * float(f32(beta1)) + grad * omb1)
    v.copy_(v * float(f32(beta2)) + grad * omb2 * grad)
    update = (m * inv_bc1) / (torch.sqrt(v) * inv_sqrt_bc2 + float(f32(eps)))
    p.copy_(p - update * float(f32(lr)) - p * wdf)
    if out is not None:
        out.copy_(p)


def _blocking_event(stream):
    """An event recorded on ``stream`` whose host wait sleeps instead of
    spinning a core that the host Adam's threads need."""
    event = torch.cuda.Event(blocking=True)
    event.record(stream)
    return event


class _LazyFuture:
    """Future-alike that runs its work on the caller thread at first ``result()``."""

    __slots__ = ("_fn", "_args", "_done", "_result", "_exc")

    def __init__(self, fn, args):
        self._fn, self._args = fn, args
        self._done = False
        self._result = self._exc = None

    def result(self, timeout=None):
        if not self._done:
            try:
                self._result = self._fn(*self._args)
            except BaseException as e:  # re-raised on every result() like a real Future
                self._exc = e
            self._done = True
        if self._exc is not None:
            raise self._exc
        return self._result


class SerialTransferExecutor:
    """Non-overlapped transfers: every fetch/push runs inline on the caller
    thread when its future is first read — wall-clock ≈ Σfetch + Σadam + Σpush.
    Used when the pipeline is off and as the reference of the bit-equality
    tests."""

    pipelined = False

    def submit_fetch(self, fn, *args):
        return _LazyFuture(fn, args)

    def submit_push(self, fn, *args):
        return _LazyFuture(fn, args)

    def shutdown(self):
        pass


class PipelinedTransferExecutor:
    """One fetch and one push thread beside the caller's host Adam: on the
    card each enqueues its copies on its own stream and waits on their events,
    which release the GIL, as do ``copy_`` and the ctypes kernel."""

    pipelined = True

    def __init__(self):
        self._fetch = ThreadPoolExecutor(1, thread_name_prefix="offload-fetch")
        self._push = ThreadPoolExecutor(1, thread_name_prefix="offload-push")

    def submit_fetch(self, fn, *args):
        return self._fetch.submit(fn, *args)

    def submit_push(self, fn, *args):
        return self._push.submit(fn, *args)

    def shutdown(self):
        self._fetch.shutdown(wait=False)
        self._push.shutdown(wait=False)


class _Region:
    """One leaf (this rank's slice of one parameter): a segment of the flat
    host buffers, and the slice's ``starts`` / ``stops`` per axis within the
    full parameter (the offload checkpoint's region manifest)."""

    __slots__ = ("leaf", "shape", "size", "offset", "starts", "stops")

    def __init__(self, leaf, shape, size, offset, starts, stops):
        self.leaf, self.shape, self.size, self.offset = leaf, shape, size, offset
        self.starts, self.stops = list(starts), list(stops)


class WorkItem(NamedTuple):
    """One chunk of the pipelined step: [lo, hi) of ``region`` (a span of
    ``chunk_spans``; a torch slice needs no fixed-width window); ``grad`` is
    the region's flat grad tensor."""
    grad: torch.Tensor
    region: _Region
    lo: int
    hi: int


class DeepSpeedCPUAdam:
    """Adam over flat host-resident float32 buffers with pytree views.

    Flat mode::

        opt = DeepSpeedCPUAdam(params_tree)          # copies the leaves to the host
        opt.step(opt.flatten_grads(g), step=1, lr=1e-3)
        tree = opt.params_tree()                     # float32 views of the buffer

    Engine mode: ``begin_grad_fetch(grads_tree)`` then ``step_regions``.
    ``params_tree`` leaves may lie on the card, in any float dtype: each is
    copied to the host buffer on its own, so no float32 copy of the whole
    model is made on the card. Pipeline knobs (config block
    ``zero_optimization.offload_optimizer``): ``pipeline`` (threaded lanes, or
    the serial walk), ``pipeline_depth`` K (chunks in flight, the rings' slots)
    and ``max_region_elements`` (the chunk cap; "auto" autotunes it). Tests may
    inject an executor as ``transfer_executor``. ``leaf_slices``: per leaf the
    (starts, stops) of the slice it holds within its full parameter (the
    engine's ZeRO slices; default each leaf whole).
    """

    def __init__(self, params_tree, adamw: bool = True, bias_correction: bool = True,
                 pipeline: bool = True, pipeline_depth: int = 2,
                 max_region_elements="auto", leaf_slices=None):
        leaves, self._treedef = pytree.tree_flatten(params_tree)
        if leaf_slices is None:
            leaf_slices = [([0] * leaf.dim(), list(leaf.shape)) for leaf in leaves]
        self._regions = []
        offset = 0
        for li, (leaf, (starts, stops)) in enumerate(zip(leaves, leaf_slices)):
            self._regions.append(_Region(li, tuple(leaf.shape), leaf.numel(), offset,
                                         starts, stops))
            offset += leaf.numel()
        self.numel = offset
        self.fp32 = torch.empty(self.numel, dtype=torch.float32)
        with torch.no_grad():
            for r, leaf in zip(self._regions, leaves):
                self.fp32[r.offset:r.offset + r.size].copy_(leaf.detach().reshape(-1))
        self.exp_avg = torch.zeros(self.numel, dtype=torch.float32)
        self.exp_avg_sq = torch.zeros(self.numel, dtype=torch.float32)
        self.adamw = adamw
        self.bias_correction = bias_correction
        load_cpu_adam()   # build (or raise) at construction, not at the first step
        # aggregate + per-region breakdown; see step_regions for the schema
        self.last_step_timing = None

        self.pipeline = bool(pipeline)
        self.pipeline_depth = max(1, int(pipeline_depth))
        if max_region_elements in (None, 0, "auto"):
            self._cap_fixed = None
        else:
            cap = int(max_region_elements)
            if cap <= 0:
                raise ValueError(
                    f"offload_optimizer.max_region_elements must be 'auto' or a positive "
                    f"integer, got {max_region_elements!r}")
            self._cap_fixed = cap
        self._auto_cap = _DEFAULT_REGION_CAP
        self._autotuned = False
        self.transfer_executor = None  # injectable; None -> built from `pipeline`
        self._default_ex = None
        self._streams = {}   # device -> (d2h, h2d)
        self._rings = {}     # "grad" / "stage" -> K byte buffers
        self._started = None  # (handles, first fetch futures) of begin_grad_fetch

    # ------------------------------------------------------------- pipeline plumbing
    def _get_executor(self):
        if self.transfer_executor is not None:
            return self.transfer_executor
        if self._default_ex is None:
            self._default_ex = (PipelinedTransferExecutor() if self.pipeline
                                else SerialTransferExecutor())
        return self._default_ex

    def region_cap(self) -> Optional[int]:
        """Current per-chunk element cap, or None when stepping serially (unsplit)."""
        if not getattr(self._get_executor(), "pipelined", False):
            return None
        return self._cap_fixed if self._cap_fixed is not None else self._auto_cap

    def _depth(self, ex):
        # the serial walk keeps one item in flight; more would only reorder it
        return self.pipeline_depth if getattr(ex, "pipelined", False) else 1

    def close(self):
        self._started = None
        if self._default_ex is not None:
            self._default_ex.shutdown()
            self._default_ex = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _ring(self, kind, slot, dtype, n):
        """Slot ``slot`` of the ``kind`` ring as ``n`` elements of ``dtype``."""
        return self._rings[kind][slot][:n * dtype.itemsize].view(dtype)

    def _ensure_ring(self, kind, k, nbytes, pinned):
        ring = self._rings.get(kind)
        if ring is None or len(ring) != k or ring[0].numel() < nbytes \
                or ring[0].is_pinned() != pinned:
            self._rings[kind] = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
                                 for _ in range(k)]

    def _cuda_streams(self, device):
        if device not in self._streams:
            self._streams[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        return self._streams[device]

    # ------------------------------------------------------------- tree views
    def _assemble(self, flat):
        return pytree.tree_unflatten(
            [flat[r.offset:r.offset + r.size].view(r.shape) for r in self._regions],
            self._treedef)

    def params_tree(self):
        return self._assemble(self.fp32)

    def exp_avg_tree(self):
        return self._assemble(self.exp_avg)

    def exp_avg_sq_tree(self):
        return self._assemble(self.exp_avg_sq)

    def load_trees(self, master_tree=None, exp_avg_tree=None, exp_avg_sq_tree=None):
        """Copy full trees into the flat buffers."""
        with torch.no_grad():
            for buf, tree in ((self.fp32, master_tree), (self.exp_avg, exp_avg_tree),
                              (self.exp_avg_sq, exp_avg_sq_tree)):
                if tree is None:
                    continue
                for r, leaf in zip(self._regions, pytree.tree_leaves(tree)):
                    buf[r.offset:r.offset + r.size].copy_(
                        torch.as_tensor(leaf).detach().reshape(-1))

    def flatten_grads(self, grads_tree) -> torch.Tensor:
        """A flat float32 host tensor of the grads, in region order."""
        out = torch.empty(self.numel, dtype=torch.float32)
        for r, g in zip(self._regions, pytree.tree_leaves(grads_tree)):
            out[r.offset:r.offset + r.size].copy_(torch.as_tensor(g).detach().reshape(-1))
        return out

    # ------------------------------------------------------------- flat-buffer update
    def _kernel_step(self, lo, hi, g, step, lr, beta1, beta2, eps, weight_decay,
                     grad_scale, out=None):
        """One Adam step of the native kernel over buffer range [lo, hi)."""
        adam_step_native(self.fp32[lo:hi], g, self.exp_avg[lo:hi], self.exp_avg_sq[lo:hi],
                         out, step=step, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                         weight_decay=weight_decay, grad_scale=grad_scale,
                         adamw=self.adamw, bias_correction=self.bias_correction)

    def step(self, grads_flat, step: int, lr: float, beta1: float = 0.9,
             beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
             grad_scale: float = 1.0):
        """One in-place Adam step over the whole flat master buffer."""
        g = torch.as_tensor(grads_flat).reshape(-1).to(torch.float32).contiguous()
        self._kernel_step(0, self.numel, g, step, lr, beta1, beta2, eps, weight_decay,
                          grad_scale)

    # ------------------------------------------------------------- pipelined engine path
    def begin_grad_fetch(self, grads_tree):
        """The work items of one pipelined step over ``grads_tree`` (one
        tensor per region, on the card or the CPU), each region cut at the
        current chunk cap. On the card the transfer streams wait on an event
        of the current stream (the grads are final), and the pipelined walk's
        first K fetches start at once, overlapping what the caller runs next
        (the norm pass)."""
        self._drain_started()
        cap = self.region_cap()
        grads = [g.detach().reshape(-1) for g in pytree.tree_leaves(grads_tree)]
        if len(grads) != len(self._regions):
            raise ValueError(f"{len(grads)} grad leaves for {len(self._regions)} regions")
        handles = []
        for r, g in zip(self._regions, grads):
            if g.numel() != r.size:
                raise ValueError(f"grad leaf {r.leaf} has {g.numel()} elements, "
                                 f"its region {r.size}")
            for lo, hi, _ in chunk_spans(r.size, cap):
                handles.append(WorkItem(g, r, lo, hi))
        if not handles:
            return handles
        device = grads[0].device
        if device.type == "cuda":
            d2h, h2d = self._cuda_streams(device)
            ready = torch.cuda.current_stream(device).record_event()
            d2h.wait_event(ready)
            h2d.wait_event(ready)
            for g in grads:
                g.record_stream(d2h)   # the allocator keeps them until the D2H is done
        self._started = (handles, self._start_fetches(handles))
        return handles

    def _start_fetches(self, handles):
        """Size the grad ring for ``handles`` and submit their first K fetches."""
        ex = self._get_executor()
        k = self._depth(ex)
        nbytes = max((it.hi - it.lo) * it.grad.element_size() for it in handles)
        self._ensure_ring("grad", k, nbytes, handles[0].grad.is_cuda)
        return [ex.submit_fetch(self._fetch_item, handles[j], j % k)
                for j in range(min(k, len(handles)))]

    def _drain_started(self):
        """Wait for the fetches of a walk that never ran (a skipped step):
        its ring slots are reused next. A serial walk's never started."""
        if self._started is not None:
            for f in self._started[1]:
                if not isinstance(f, _LazyFuture):
                    f.result()
            self._started = None

    def _fetch_item(self, item, slot):
        """Land one item's grads in ring slot ``slot`` (fetch-lane work).
        Returns (the slot's grads, busy seconds: the copy and its wait)."""
        t0 = time.perf_counter()
        n = item.hi - item.lo
        src = item.grad[item.lo:item.hi]
        dst = self._ring("grad", slot, src.dtype, n)
        if src.is_cuda:
            d2h = self._cuda_streams(src.device)[0]
            with torch.cuda.stream(d2h):
                dst.copy_(src, non_blocking=True)
            done = _blocking_event(d2h)
            done.synchronize()
        else:
            dst.copy_(src)
        return dst, time.perf_counter() - t0

    def _push_item(self, src, dst):
        """Copy one staging slot into its device slice (push-lane work).
        Returns (the copy's event on the card or None, busy seconds)."""
        t0 = time.perf_counter()
        done = None
        if dst.is_cuda:
            h2d = self._cuda_streams(dst.device)[1]
            with torch.cuda.stream(h2d):
                dst.copy_(src, non_blocking=True)
            done = _blocking_event(h2d)
        else:
            dst.copy_(src)
        return done, time.perf_counter() - t0

    def step_regions(self, handles, step: int, lr: float, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                     grad_scale: float = 1.0, out_dtype=torch.float32, leaf_hypers=None,
                     out=None):
        """The pipelined step over ``handles`` (``begin_grad_fetch``): K items
        in flight — the fetch lane lands chunk i+K while the caller runs Adam
        on chunk i and the push lane copies finished chunks to their device
        slices. ``out`` is a tree (one tensor per region, contiguous, on the
        grads' device) that receives the updated master in its dtype; without
        it one is made in ``out_dtype``. Returns the ``out`` tree.

        ``leaf_hypers``: optional per-leaf {lr, beta1, beta2, eps, weight_decay}
        dicts overriding the scalar args (the engine's param groups).

        ``last_step_timing`` afterwards holds the lanes as the caller saw them
        (``fetch_wait``: stalls on the fetch lane; ``host_adam``; ``push``:
        waits for a staging slot's earlier push, then the final drain;
        ``total``), the lane busy sums (``fetch_busy``, ``push_busy``), the
        pipeline shape (``pipeline_depth``, ``region_cap``, ``n_work_items``) and
        ``regions``, one {leaf, size, chunks, fetch_wait, fetch, adam, push}
        record per region."""
        t0 = time.perf_counter()
        ex = self._get_executor()
        k = self._depth(ex)
        n = len(handles)
        if self._started is not None and self._started[0] is handles:
            futs = self._started[1]
            self._started = None
        else:   # handles this object did not start: start them
            self._drain_started()
            futs = self._start_fetches(handles) if handles else []
        fetch_futs = futs + [None] * (n - len(futs))
        if out is None:
            dev = handles[0].grad.device if handles else torch.device("cpu")
            out = pytree.tree_unflatten(
                [torch.empty(r.shape, dtype=out_dtype, device=dev) for r in self._regions],
                self._treedef)
        outs = pytree.tree_leaves(out)
        for r, t in zip(self._regions, outs):
            if t.numel() != r.size or not t.is_contiguous():
                raise ValueError(f"out leaf {r.leaf} must be a contiguous tensor of "
                                 f"{r.size} elements")
        dsts = [t.view(-1) for t in outs]
        cuda = bool(handles) and dsts[0].is_cuda
        if handles:
            nbytes = max(it.hi - it.lo for it in handles) * max(d.element_size() for d in dsts)
            self._ensure_ring("stage", k, nbytes, cuda)
        rec, region_order = {}, []
        t_fetch_wait = t_adam = t_push = fetch_busy = push_busy = 0.0
        push_futs = [None] * n
        for i, it in enumerate(handles):
            r = it.region
            t = time.perf_counter()
            grad, busy = fetch_futs[i].result()
            fetch_futs[i] = None
            stall = time.perf_counter() - t
            rr = rec.get(r.leaf)
            if rr is None:
                region_order.append(r.leaf)
                rr = rec[r.leaf] = {"leaf": r.leaf, "size": r.size, "chunks": 0,
                                    "fetch_wait": 0.0, "fetch": 0.0, "adam": 0.0,
                                    "push": 0.0}
            rr["chunks"] += 1
            rr["fetch_wait"] += stall
            rr["fetch"] += busy
            t_fetch_wait += stall
            fetch_busy += busy

            # the staging slot is free once its previous push has landed
            slot = i % k
            t = time.perf_counter()
            if i >= k:
                push_busy += self._wait_push(push_futs[i - k], rec)
                push_futs[i - k] = None
            t_push += time.perf_counter() - t

            t = time.perf_counter()
            hy = (leaf_hypers[r.leaf] if leaf_hypers is not None else
                  dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))
            m = it.hi - it.lo
            dst = dsts[r.leaf][it.lo:it.hi]
            stage = self._ring("stage", slot, dst.dtype, m)
            lo, hi = r.offset + it.lo, r.offset + it.hi
            if dst.dtype in (torch.bfloat16, torch.float16):
                self._kernel_step(lo, hi, grad, step, hy["lr"], hy["beta1"], hy["beta2"],
                                  hy["eps"], hy["weight_decay"], grad_scale, out=stage)
            else:
                self._kernel_step(lo, hi, grad.float(), step, hy["lr"], hy["beta1"],
                                  hy["beta2"], hy["eps"], hy["weight_decay"], grad_scale)
                stage.copy_(self.fp32[lo:hi])
            dt = time.perf_counter() - t
            rr["adam"] += dt
            t_adam += dt
            # the grad slot is consumed: its next chunk may land
            if i + k < n:
                fetch_futs[i + k] = ex.submit_fetch(self._fetch_item, handles[i + k], slot)
            push_futs[i] = (r.leaf, ex.submit_push(self._push_item, stage, dst))

        t = time.perf_counter()
        for pf in push_futs:
            if pf is not None:
                push_busy += self._wait_push(pf, rec)
        if cuda:
            torch.cuda.current_stream(dsts[0].device).wait_stream(
                self._cuda_streams(dsts[0].device)[1])
        t_push += time.perf_counter() - t
        self.last_step_timing = {
            "fetch_wait": t_fetch_wait, "host_adam": t_adam, "push": t_push,
            "total": time.perf_counter() - t0,
            "fetch_busy": fetch_busy, "push_busy": push_busy,
            "pipeline_depth": k, "region_cap": self.region_cap() or 0,
            "n_work_items": n,
            "regions": [rec[li] for li in region_order],
        }
        self._maybe_autotune_cap(ex, fetch_busy, t_adam)
        return out

    @staticmethod
    def _wait_push(pf, rec):
        """Wait for one push (its enqueue, then its copy); returns its busy seconds."""
        leaf, fut = pf
        done, busy = fut.result()
        if done is not None:
            done.synchronize()
        rec[leaf]["push"] += busy
        return busy

    def _maybe_autotune_cap(self, ex, fetch_busy: float, adam_busy: float):
        """Set the chunk cap from the first pipelined step's measured rates: about
        50 ms of the slower of the fetch/Adam lanes per chunk — deep enough that a
        hundreds-of-MB region pipelines, coarse enough to amortize per-chunk
        dispatch. A user-pinned ``max_region_elements`` disables this; the new cap
        takes effect at the next ``begin_grad_fetch``."""
        if (self._cap_fixed is not None or self._autotuned
                or not getattr(ex, "pipelined", False)
                or fetch_busy <= 0.0 or adam_busy <= 0.0 or self.numel <= 0):
            return
        slower_rate = self.numel / max(fetch_busy, adam_busy)
        cap = int(0.05 * slower_rate)
        self._auto_cap = max(1 << 20, min(cap, 64 << 20))
        self._autotuned = True
