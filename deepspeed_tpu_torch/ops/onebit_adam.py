"""1-bit Adam: error-compensated momentum compression for data parallelism.

Counterpart of ``deepspeed_tpu/ops/onebit_adam.py`` (the reference's
``deepspeed/runtime/fp16/onebit_adam.py``):

- **Warmup** (step <= ``freeze_step``, the step 1-based): Adam-style moments
  over the mean gradient (an all-reduce of this rank's local gradient), with
  no bias correction.
- **Frozen** (step > ``freeze_step``): each rank updates its momentum with
  its *local* gradient, the momenta are averaged with the two-phase
  sign-compressed allreduce (``runtime/custom_collectives.py``, or the
  two-level schedule of ``comm/hierarchical.py`` on a hierarchical
  topology), and the variance is frozen. The update is ``m / (sqrt(v) +
  eps) + wd * p``, with no bias correction.

The parameters are one float32 vector in the JAX package's leaf order
(``order``: the engine's leaf indices in that order), padded so that each of
the dp server chunks is a multiple of 128 elements (``padded_size``); each
leaf is a scale segment of its own, the padded tail another, and a segment is
a contiguous run of the vector. State, this rank's part:

  exp_avg / exp_avg_sq : (n_pad,)
  worker_error         : (n_pad // slice_size,)   its row of the JAX (dp, ...)
  server_error         : (n_pad // dp,)

``apply`` takes this rank's unreduced gradients (the engine keeps them local
under 1-bit Adam) and updates master and state in place. With one rank the
collectives are the identity and the compression runs all the same.
``elastic_adapt`` is the JAX function (numpy), for a checkpoint saved at
another world size.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..comm.hierarchical import leaf_segments, two_level_compressed
from ..comm.topology import CommGroups, CommTopology
from ..runtime.custom_collectives import padded_size


class OneBitAdamState(NamedTuple):
    exp_avg: torch.Tensor       # (n_pad,) float32
    exp_avg_sq: torch.Tensor    # (n_pad,) float32
    worker_error: torch.Tensor  # (n_pad // slice_size,) this rank's row
    server_error: torch.Tensor  # (n_pad // dp,) this rank's row


def _f32(x) -> float:
    return float(np.float32(x))


class OneBitAdam:
    """``init`` / ``apply`` pair with 1-bit compressed momentum averaging.

    ``groups`` is the ``CommGroups`` of the exchange (a flat topology unless
    the engine's ``comm.mode`` is hierarchical); ``order`` the engine's leaf
    indices in the JAX leaf order (the flat vector's layout)."""

    def __init__(self, freeze_step: int, dp_size: int, groups: Optional[CommGroups] = None,
                 order: Optional[Sequence[int]] = None):
        self.freeze_step = int(freeze_step)
        self.dp_size = int(dp_size)
        self.groups = groups if groups is not None else CommGroups(CommTopology(dp_size, 1))
        topo = self.groups.topo
        if topo.dp != self.dp_size:
            raise ValueError(f"topology dp={topo.dp} != optimizer dp={self.dp_size}")
        # a hierarchical topology routes the frozen phase's exchange over the
        # two-level schedule; otherwise the flat compressed allreduce, the
        # two-level one with every rank a slice of its own
        self._exchange_groups = (self.groups if topo.is_hierarchical
                                 else CommGroups(CommTopology(dp_size, dp_size)))
        self.order = None if order is None else list(order)
        self._segs = None

    def _ordered(self, leaves):
        return leaves if self.order is None else [leaves[i] for i in self.order]

    def _flat(self, leaves, n_pad):
        flat = torch.cat([t.reshape(-1).float() for t in self._ordered(leaves)])
        return torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))

    def segments(self, master, n_pad):
        """The scale segments: one a leaf (JAX leaf order), then the tail."""
        sizes = [int(t.numel()) for t in self._ordered(master)]
        if self._segs is None or self._segs.sizes[:len(sizes)] != sizes \
                or self._segs.n != n_pad:
            self._segs = leaf_segments(sizes, n_pad)
        return self._segs

    # ---------------------------------------------------------------- state
    def init(self, master) -> OneBitAdamState:
        n = sum(int(t.numel()) for t in master)
        n_pad = padded_size(n, self.dp_size)
        topo = self._exchange_groups.topo
        dev = master[0].device
        z = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)  # noqa: E731
        return OneBitAdamState(exp_avg=z(n_pad), exp_avg_sq=z(n_pad),
                               worker_error=z(n_pad // topo.slice_size),
                               server_error=z(n_pad // self.dp_size))

    # ---------------------------------------------------------------- update
    def exchange(self, m_local, worker_error, server_error, segs):
        """The frozen phase's compressed mean of the local momenta:
        ``(m, new_worker_error, new_server_error)``."""
        return two_level_compressed(m_local, worker_error, server_error,
                                    self._exchange_groups, segs)

    @torch.no_grad()
    def apply(self, grads, state: OneBitAdamState, master, step, hyper, groups=None):
        """One step in place. ``grads`` are this rank's local gradients,
        ``hyper`` a dict or the engine's list of group dicts (one group)."""
        h = hyper if isinstance(hyper, dict) else hyper[0]
        b1, b2 = np.float32(h["beta1"]), np.float32(h["beta2"])
        c1, c2 = float(np.float32(1.0) - b1), float(np.float32(1.0) - b2)
        n_pad = state.exp_avg.numel()
        g = self._flat(grads, n_pad)
        m, v = state.exp_avg, state.exp_avg_sq
        if int(step) > self.freeze_step:
            # worker-local momentum (reference onebit_adam.py:335-336), then
            # the compressed average with per-leaf scales; v frozen
            m_local = m * float(b1) + g * c1
            del g
            new_m, new_we, new_se = self.exchange(m_local, state.worker_error,
                                                  state.server_error,
                                                  self.segments(master, n_pad))
            m.copy_(new_m)
            state.worker_error.copy_(new_we)
            state.server_error.copy_(new_se)
        else:
            if self.dp_size > 1 and g.device.type != "meta":
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=self.groups.world)
                g = g / self.dp_size
            m.copy_(m * float(b1) + g * c1)
            v.copy_(v * float(b2) + torch.square(g) * c2)
            del g
        p = self._flat(master, n_pad)
        update = m / (torch.sqrt(v) + _f32(h["eps"])) + _f32(h["weight_decay"]) * p
        p = p - _f32(h["lr"]) * update
        del update
        off = 0
        for t in self._ordered(master):
            k = t.numel()
            t.copy_(p[off:off + k].reshape(t.shape))
            off += k
        return master, state

    # ---------------------------------------------------------------- elastic restore
    @staticmethod
    def _ef_geometry(we_shape, se_shape):
        """(dp, slice_size, n_pad) implied by the two error-buffer shapes."""
        dp = int(se_shape[0])
        n_pad = dp * int(se_shape[1])
        L = n_pad // int(we_shape[1])
        if not (int(we_shape[0]) == dp and L >= 1 and dp % L == 0
                and L * int(we_shape[1]) == n_pad):
            raise ValueError(f"not a 1-bit error-buffer pair: {we_shape}, {se_shape}")
        return dp, L, n_pad

    def state_template(self, state: OneBitAdamState) -> dict:
        """{checkpoint key: empty host array of its full shape} of this
        engine's state (the shapes ``elastic_adapt`` adapts to)."""
        dp = self.dp_size
        return {"exp_avg": np.empty(state.exp_avg.shape, np.float32),
                "exp_avg_sq": np.empty(state.exp_avg_sq.shape, np.float32),
                "worker_error": np.empty((dp, state.worker_error.numel()), np.float32),
                "server_error": np.empty((dp, state.server_error.numel()), np.float32)}

    def elastic_adapt(self, loaded_flat: dict, template_flat: dict) -> dict:
        """Adapt a checkpointed state saved under another world size (the JAX
        function, on full ``(dp, cols)`` host arrays).

        Moments are truncated or zero-extended to the new padded length.
        ``server_error`` is re-chunked by index permutation (every real
        element survives bit for bit); ``worker_error``'s slice-sharers' float64
        mean is re-placed on every new holder of its position."""
        out = {}
        for key, tmpl in template_flat.items():
            v = loaded_flat.get(key) if key in loaded_flat else None
            tshape = tuple(int(s) for s in tmpl.shape)
            kind = ("worker_error" if key.endswith("worker_error")
                    else "server_error" if key.endswith("server_error") else None)
            if v is None:
                out[key] = np.zeros(tshape, np.float32)
                continue
            if kind is None:
                if tuple(v.shape) == tshape:
                    out[key] = v
                elif v.ndim == 1 and len(tshape) == 1:
                    buf = np.zeros(tshape, np.float32)
                    keep = min(v.size, tshape[0])
                    buf[:keep] = np.asarray(v)[:keep]
                    out[key] = buf
                else:
                    out[key] = np.zeros(tshape, np.float32)
                continue
            prefix = key[:-len(kind)]
            quad = (loaded_flat.get(prefix + "worker_error"),
                    loaded_flat.get(prefix + "server_error"),
                    template_flat.get(prefix + "worker_error"),
                    template_flat.get(prefix + "server_error"))
            try:
                dp_o, L_o, np_o = self._ef_geometry(quad[0].shape, quad[1].shape)
                dp_n, L_n, np_n = self._ef_geometry(quad[2].shape, quad[3].shape)
            except (ValueError, AttributeError, IndexError, ZeroDivisionError):
                out[key] = np.zeros(tshape, np.float32)  # unrecognizable layout
                continue
            if (dp_o, L_o, np_o) == (dp_n, L_n, np_n):
                out[key] = v
                continue
            from ..resilience.elastic import remap_ef_block
            we_new, se_new = remap_ef_block(quad[0], quad[1], dp_o, L_o, np_o,
                                            dp_n, L_n, np_n)
            out[key] = se_new if kind == "server_error" else we_new
        return out
