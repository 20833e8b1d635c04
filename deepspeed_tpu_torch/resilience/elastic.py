"""Topology-changing restore of the engine-held compressed-comm error feedback.

Counterpart of ``deepspeed_tpu/resilience/elastic.py``. Under
``comm.mode: hierarchical_compressed`` the engine holds the exchange's
error feedback (``_comm_we`` / ``_comm_se``, this rank's row of the JAX
engine's ``(dp, cols)`` buffers), whose columns are the chunks of one padded
vector (or, under the bucketed overlap, of each bucket's, back to back): a
function of the bucket plan, dp and the topology's slice size. A checkpoint
saves them with their geometry (``comm_ef.npz`` / ``comm_ef.json``, the JAX
engine's files, ``checkpoint.comm_ef_geometry``); a restore

- validates the saved geometry against the live engine's: the same layout
  kind, bucket count and per-bucket leaf sizes, else ``ValueError`` rather
  than corrupted residuals;
- passes an identical geometry through bit for bit;
- remaps another (dp, slice_size) bucket by bucket with
  ``ops/onebit_adam.py``'s math: ``server_error`` by index permutation (every
  real element bit for bit), ``worker_error`` by the float64 slice mean
  re-placed on every holder of its position.

All of it is host numpy on the full arrays; each rank then takes its row.
"""

import json
import os

import numpy as np
import torch

from ..utils import logger


def _geometry_blocks(geo):
    """Per-bucket ``(n_pad, we_cols, se_cols)`` column spans of a saved or
    live geometry; one block for the monolithic layout."""
    dp, L = geo["dp"], geo["slice_size"]
    if geo["layout"] == "bucketed":
        return [(b["n_pad"], b["n_pad"] // L, b["n_pad"] // dp) for b in geo["buckets"]]
    return [(geo["n_pad"], geo["n_pad"] // L, geo["n_pad"] // dp)]


def _validate_remappable(saved, live):
    """Raise ValueError unless ``saved`` can be carried into ``live``: only
    (dp, slice_size) may differ."""
    if saved["layout"] != live["layout"]:
        raise ValueError(
            f"checkpointed comm EF layout {saved['layout']!r} cannot restore into a "
            f"{live['layout']!r} engine — the residual chunking differs structurally; "
            f"refusing rather than corrupting")
    if saved["layout"] == "bucketed":
        s_b, l_b = saved["buckets"], live["buckets"]
        if len(s_b) != len(l_b) or any(
                tuple(a["sizes"]) != tuple(b["sizes"]) or a["n"] != b["n"]
                for a, b in zip(s_b, l_b)):
            raise ValueError(
                f"checkpointed comm EF bucket plan ({len(s_b)} buckets) does not replay "
                f"under the live engine ({len(l_b)} buckets) — bucket_bytes or the "
                f"parameter tree changed; refusing rather than corrupting")
    elif saved["n"] != live["n"]:
        raise ValueError(
            f"checkpointed comm EF covers {saved['n']} elements but the live parameter "
            f"tree has {live['n']} — refusing rather than corrupting")


def server_offsets(dp, L, n_pad):
    """Global start offset of each rank's server sub-chunk:
    ``(d % L) * (n_pad // L) + (d // L) * (n_pad // dp)``."""
    C, csize = n_pad // L, n_pad // dp
    return [(d % L) * C + (d // L) * csize for d in range(dp)]


def remap_ef_block(we, se, dp_o, L_o, np_o, dp_n, L_n, np_n):
    """Remap one contiguous EF block (a bucket, or the monolithic whole) of
    full ``(dp, cols)`` arrays from geometry (dp_o, L_o, np_o) to (dp_n,
    L_n, np_n)."""
    keep = min(np_o, np_n)
    # server: the dp sub-chunks tile the padded vector exactly — a permutation
    g = np.zeros(np_o, np.float32)
    cs_o = np_o // dp_o
    for d, off in enumerate(server_offsets(dp_o, L_o, np_o)):
        g[off:off + cs_o] = np.asarray(se)[d]
    g_new = np.zeros(np_n, np.float32)
    g_new[:keep] = g[:keep]
    cs_n = np_n // dp_n
    se_new = np.stack([g_new[off:off + cs_n] for off in server_offsets(dp_n, L_n, np_n)])
    # worker: slice-sharers hold independent residuals; re-place their mean
    C_o = np_o // L_o
    gw = np.zeros(np_o, np.float64)
    w64 = np.asarray(we, np.float64)
    for l in range(L_o):
        gw[l * C_o:(l + 1) * C_o] = w64[l::L_o].mean(axis=0)
    gw_new = np.zeros(np_n, np.float64)
    gw_new[:keep] = gw[:keep]
    C_n = np_n // L_n
    we_new = np.stack([gw_new[(d % L_n) * C_n:(d % L_n + 1) * C_n]
                       for d in range(dp_n)]).astype(np.float32)
    return we_new, se_new


def remap_ef(we_s, se_s, saved, live):
    """The full ``(dp, cols)`` buffers of geometry ``saved`` in the layout
    of ``live``: passed through when the geometries are equal, else
    validated and remapped block by block."""
    if saved == live:
        return np.asarray(we_s, np.float32), np.asarray(se_s, np.float32)
    _validate_remappable(saved, live)
    dp_o, L_o = saved["dp"], saved["slice_size"]
    dp_n, L_n = live["dp"], live["slice_size"]
    we_parts, se_parts = [], []
    wo = so = 0
    for (np_o, wc_o, sc_o), (np_n, _, _) in zip(_geometry_blocks(saved),
                                                _geometry_blocks(live)):
        we_b, se_b = remap_ef_block(we_s[:, wo:wo + wc_o], se_s[:, so:so + sc_o],
                                    dp_o, L_o, np_o, dp_n, L_n, np_n)
        we_parts.append(we_b)
        se_parts.append(se_b)
        wo += wc_o
        so += sc_o
    return np.concatenate(we_parts, axis=1), np.concatenate(se_parts, axis=1)


@torch.no_grad()
def restore_comm_ef(engine, ckpt_dir: str) -> bool:
    """Restore (or elastically remap) the engine's ``_comm_we`` /
    ``_comm_se`` from a checkpoint directory: True when restored; False for a
    checkpoint that never saved them (the buffers stay zero)."""
    from ..checkpoint.checkpointing import comm_ef_geometry
    live = comm_ef_geometry(engine)
    if live is None:
        return False
    npz_path = os.path.join(ckpt_dir, "comm_ef.npz")
    json_path = os.path.join(ckpt_dir, "comm_ef.json")
    if not (os.path.isfile(npz_path) and os.path.isfile(json_path)):
        logger.warning("[deepspeed_tpu_torch] checkpoint holds no comm EF state — "
                       "compression restarts with zero residuals")
        return False
    with open(json_path) as f:
        saved = json.load(f)
    with np.load(npz_path) as data:
        we_s, se_s = data["worker_error"], data["server_error"]
    we, se = remap_ef(we_s, se_s, saved, live)
    engine._comm_we.copy_(torch.from_numpy(we[engine.dp_rank]))
    engine._comm_se.copy_(torch.from_numpy(se[engine.dp_rank]))
    if saved != live:
        logger.info(f"[deepspeed_tpu_torch] remapped comm EF state dp={saved['dp']} "
                    f"slice={saved['slice_size']} -> dp={live['dp']} "
                    f"slice={live['slice_size']}")
    return True
