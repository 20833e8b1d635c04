"""Checkpoint save/load (PyTorch port) in the JAX package's on-disk format.

Counterpart of ``deepspeed_tpu/checkpoint/checkpointing.py``, file for file
and key for key, so that a checkpoint either package writes resumes in the
other. A ``<tag>/`` directory holds ``mp_rank_00_model_states.{npz,json}``
(the compute params, widened to float32 where npz has no dtype; the
counters, param groups, LR scheduler and client state),
``loss_scaler.npz``, and either one
``zero_pp_rank_{r}_mp_rank_00_optim_states.npz`` per saved dp rank (the
float32 master and the optimizer state of every leaf, each a flat
``np.array_split`` of the global array, with ``optim_shapes.json`` to merge
them back at any dp) or, under ZeRO-Offload, one
``zero_offload_proc_{r}_optim_states.npz`` per rank with its
``offload_manifest_{r}.json`` (each region's slice of its leaf). Keys are the
JAX package's tree paths (``exp_avg/blocks/0/attn/c_attn_w``), from the
module's ``params_tree()`` (``DeepSpeedEngine._ckpt_keys``).

The commit protocol is the JAX package's, copied: phase 1
(``snapshot_checkpoint``) copies every payload to host memory and touches no
file; phase 2 (``write_snapshot``) writes ``<tag>.tmp/``, then the per-file
sha256 manifest, fsyncs and renames it to ``<tag>/``, and points ``latest``
at it through tmp + ``os.replace``. A crash at any point leaves the previous
committed state or a tag that ``verify_checkpoint`` reports torn, which
restore refuses.

The port's engine updates its state in place, where the JAX package never
mutates a buffer, so the snapshot COPIES every leaf (``to_host``; the offload
buffers are cloned): a commit on a writer thread never sees the next step's
update. At dp > 1 every rank joins the all-gather of each ZeRO slice, leaf by
leaf (the card holds one gathered leaf at a time), rank 0 writes every shared
file, each rank its own offload region file, and ``dist.barrier`` stands for
the JAX package's ``_save_barrier``. A load reads the npz members one at a
time, so a 1.5B model's master and moments never lie whole in host memory.

``write_snapshot`` records the seconds of its stages in ``snapshot["seconds"]``
and ``load_checkpoint`` its own in ``engine.last_checkpoint_load``.
"""

import glob
import hashlib
import json
import os
import shutil
import struct
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.fp16.loss_scaler import LossScaleState
from ..runtime.zero.sharding import elastic_split, shard, unshard
from ..utils import logger


def _path_key(path) -> str:
    """Canonical '/'-joined key for a tree path — the single definition every
    save/load layout (tree npz, per-rank shards, offload regions) keys by."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                    for p in path)


_NPZ_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.bool_, np.uint32, np.uint8,
               np.int8, np.float16)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update reaches (a CUDA
    tensor's ``.to("cpu")`` is a synchronous copy; a CPU tensor is cloned),
    widened to float32 where npz has no dtype (bfloat16; lossless)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        arr = t.to("cpu").float().numpy()
    else:
        arr = t.to("cpu", copy=True).numpy()
    if arr.dtype not in _NPZ_DTYPES:
        arr = arr.astype(np.float32)
    return arr


def _scaler_flat(state: LossScaleState) -> Dict[str, np.ndarray]:
    """The scaler state as the JAX package's 0-d arrays: ``cur_scale``
    float32, the three counters int32."""
    return {f: np.asarray(v, np.float32 if f == "cur_scale" else np.int32)
            for f, v in zip(state._fields, state)}


def _scaler_from(data) -> LossScaleState:
    return LossScaleState(cur_scale=float(data["cur_scale"]),
                          cur_hysteresis=int(data["cur_hysteresis"]),
                          last_overflow_iter=int(data["last_overflow_iter"]),
                          iter_count=int(data["iter_count"]))


def _ckpt_dir(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, str(tag))


class NpzFile:
    """The arrays of an ``np.savez`` archive, each read when it is asked for,
    straight from its (stored, uncompressed) zip member into the array in one
    ``readinto``, where ``np.load`` reads it in 256 KiB chunks through the
    zip CRC and two copies (``chip_smoke.py`` times both); the archive's
    integrity is the manifest's sha256 (``verify_checkpoint``)."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "rb")
        try:
            with zipfile.ZipFile(self._f) as z:
                self._members = {i.filename[:-4]: i for i in z.infolist()
                                 if i.filename.endswith(".npy")}
        except BaseException:
            self._f.close()
            raise

    @property
    def files(self):
        return list(self._members)

    def __contains__(self, key):
        return key in self._members

    def __getitem__(self, key) -> np.ndarray:
        info = self._members[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{self._path}: member {key!r} is compressed; checkpoints "
                             "are written by np.savez, uncompressed")
        f = self._f
        f.seek(info.header_offset)
        head = f.read(30)
        if head[:4] != b"PK\x03\x04":
            raise ValueError(f"{self._path}: no local header for member {key!r}")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran_order, dtype = read_header(f)
        if dtype.hasobject:
            raise ValueError(f"{self._path}: member {key!r} holds Python objects")
        arr = np.empty(shape, dtype, order="F" if fortran_order else "C")
        # the transpose of a Fortran-ordered array is C-contiguous, in file order
        flat = (arr.T if fortran_order else arr).reshape(-1)
        if arr.size and f.readinto(memoryview(flat).cast("B")) != arr.nbytes:
            raise ValueError(f"{self._path}: member {key!r} is truncated")
        return arr

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------- commit protocol
# Manifest name is distinct from the offload_manifest_* region manifests: this
# one is the integrity record of the WHOLE tag dir (per-file sha256), written
# last so its presence certifies every other file landed completely.
MANIFEST_NAME = "ds_ckpt_manifest.json"
TMP_SUFFIX = ".tmp"


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so renames/creates inside it are durable.
    Best-effort: not every filesystem (or platform) supports dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write_text(path: str, text: str) -> None:
    """tmp-file + fsync + os.replace: readers see the old content or the new
    content, never a torn prefix."""
    tmp = path + TMP_SUFFIX
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def write_latest(save_dir: str, tag: str) -> None:
    """Atomically point ``latest`` at ``tag`` — a preemption mid-write must
    never leave a torn ``latest`` that fails every future restore."""
    _atomic_write_text(os.path.join(save_dir, "latest"), str(tag))


def write_manifest(ckpt_dir: str, extra: Optional[Dict] = None) -> Dict:
    """Checksum every file in ``ckpt_dir`` into the integrity manifest. Written
    LAST in the commit sequence: a save killed before this point leaves no (or
    a stale) manifest, which verify_checkpoint reports as torn."""
    entries = {}
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if name == MANIFEST_NAME or name.endswith(TMP_SUFFIX) \
                or not os.path.isfile(path):
            continue
        entries[name] = {"sha256": _file_sha256(path),
                         "bytes": os.path.getsize(path)}
    manifest = {"version": 1, "files": entries}
    if extra:
        manifest.update(extra)
    _atomic_write_text(os.path.join(ckpt_dir, MANIFEST_NAME),
                       json.dumps(manifest, sort_keys=True))
    return manifest


def verify_checkpoint(ckpt_dir: str):
    """(ok, reason) integrity verdict for one tag dir. A checkpoint whose
    manifest is missing a file, or whose bytes/sha256 disagree with the
    manifest, is TORN — restore must skip it, never load it. Pre-manifest
    (legacy) checkpoints pass with a reason noting the weaker guarantee."""
    if not os.path.isdir(ckpt_dir):
        return False, "missing checkpoint directory"
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return True, "legacy (no integrity manifest)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        return False, f"unreadable manifest ({e})"
    for name, ent in manifest.get("files", {}).items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.isfile(path):
            return False, f"missing file {name}"
        if os.path.getsize(path) != ent.get("bytes"):
            return False, (f"size mismatch in {name}: "
                           f"{os.path.getsize(path)} != {ent.get('bytes')}")
        if _file_sha256(path) != ent.get("sha256"):
            return False, f"checksum mismatch in {name}"
    return True, "ok"


def model_states_name(mp_rank: int = 0) -> str:
    return f"mp_rank_{mp_rank:02d}_model_states"


def optim_states_name(dp_rank: int, mp_rank: int = 0) -> str:
    return f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states"


def offload_states_name(proc: int) -> str:
    return f"zero_offload_proc_{proc}_optim_states"


# ------------------------------------------------------------ offload host tier
_OFFLOAD_PREFIXES = ("master", "exp_avg", "exp_avg_sq")


def _offload_buffers(off):
    return {"master": off.fp32, "exp_avg": off.exp_avg, "exp_avg_sq": off.exp_avg_sq}


def _snapshot_offload_regions(engine):
    """This rank's region payloads for the host-tier state
    (``zero_offload_proc_N``); a region manifest records the full leaf
    shapes and every region's slice so that any topology can reassemble full
    leaves on load. A region is this rank's ZeRO slice of one leaf; ``leaf``
    indexes the manifest's leaves, which come in the on-disk key order.
    Buffer regions are COPIED: the async writer thread must not observe the
    next step's in-place host updates."""
    off = engine._offload
    keys = engine._ckpt_keys()
    bufs = _offload_buffers(off)
    shard_, regions_meta = {}, []
    for li, (key, i) in enumerate(keys):
        r = off._regions[i]
        tag = f"r{li}_{r.offset}"
        for prefix, buf in bufs.items():
            shard_[f"{prefix}/{tag}"] = buf[r.offset:r.offset + r.size].clone().numpy()
        regions_meta.append({"tag": tag, "leaf": li, "starts": list(r.starts),
                             "stops": list(r.stops)})
    manifest = {"n_procs": engine.dp_size, "proc": engine.dp_rank,
                "leaves": [{"key": key, "shape": list(engine._shapes[i])}
                           for key, i in keys],
                "regions": regions_meta}
    return shard_, manifest


def _offload_manifests(ckpt_dir: str):
    return sorted(glob.glob(os.path.join(ckpt_dir, "offload_manifest_*.json")))


def _load_offload_regions(ckpt_dir: str):
    """Reassemble full master/exp_avg/exp_avg_sq flat dicts (key -> full array) from
    the per-process region files. Topology-agnostic: works for any current dp."""
    out = None
    seen_procs = set()
    n_procs_seen = set()
    for mpath in _offload_manifests(ckpt_dir):
        with open(mpath) as f:
            manifest = json.load(f)
        leaves = manifest["leaves"]
        seen_procs.add(manifest["proc"])
        n_procs_seen.add(manifest["n_procs"])
        if out is None:
            out = {prefix: {leaf["key"]: np.zeros(leaf["shape"], np.float32)
                            for leaf in leaves}
                   for prefix in _OFFLOAD_PREFIXES}
        path = os.path.join(ckpt_dir, offload_states_name(manifest["proc"]) + ".npz")
        with NpzFile(path) as data:
            for r in manifest["regions"]:
                leaf = leaves[r["leaf"]]
                slices = tuple(slice(a, b) for a, b in zip(r["starts"], r["stops"]))
                shape = tuple(b - a for a, b in zip(r["starts"], r["stops"]))
                for prefix in _OFFLOAD_PREFIXES:
                    out[prefix][leaf["key"]][slices] = \
                        data[f"{prefix}/{r['tag']}"].reshape(shape)
    if out is None:
        raise RuntimeError(f"no offload manifests found in {ckpt_dir}")
    if len(n_procs_seen) != 1 or seen_procs != set(range(next(iter(n_procs_seen)))):
        # partial saves AND stale manifests from an older topology in a reused tag
        # dir must fail loud, not merge into (or zero out) the restored state
        raise RuntimeError(
            f"offload checkpoint is inconsistent: manifests for processes "
            f"{sorted(seen_procs)} with recorded world sizes {sorted(n_procs_seen)}")
    return out["master"], out["exp_avg"], out["exp_avg_sq"]


def _scatter_offload_regions(ckpt_dir: str, engine) -> bool:
    """Same-topology fast path: copy saved regions straight into this rank's
    offload buffers, in place (``engine._master`` holds views of them),
    without materializing full trees. Regions match by (leaf key, starts,
    stops), so a checkpoint of either package matches. Returns False when
    the topology changed (any local region unmatched) — the caller then
    reassembles full leaves."""
    off = engine._offload
    local = {(key, tuple(off._regions[i].starts), tuple(off._regions[i].stops)):
             off._regions[i] for key, i in engine._ckpt_keys()}
    shapes = {key: list(engine._shapes[i]) for key, i in engine._ckpt_keys()}
    bufs = _offload_buffers(off)
    matched = set()
    for mpath in _offload_manifests(ckpt_dir):
        with open(mpath) as f:
            manifest = json.load(f)
        if {leaf["key"]: list(leaf["shape"]) for leaf in manifest["leaves"]} != shapes:
            return False  # different model/tree
        hits = []
        for r in manifest["regions"]:
            key = (manifest["leaves"][r["leaf"]]["key"], tuple(r["starts"]),
                   tuple(r["stops"]))
            if key in local:
                hits.append((r, key))
        if not hits:
            continue
        path = os.path.join(ckpt_dir, offload_states_name(manifest["proc"]) + ".npz")
        with NpzFile(path) as data, torch.no_grad():
            for saved, key in hits:
                lr = local[key]
                for prefix, buf in bufs.items():
                    buf[lr.offset:lr.offset + lr.size].copy_(
                        torch.from_numpy(data[f"{prefix}/{saved['tag']}"].reshape(-1)))
                matched.add(key)
    return matched == set(local)


def _load_offload_full(engine, master, exp_avg, exp_avg_sq):
    """Copy full leaves (key -> host array, read on access; ``exp_avg`` /
    ``exp_avg_sq`` may be None) into this rank's slices of the offload
    buffers, in place."""
    off = engine._offload
    with torch.no_grad():
        for key, i in engine._ckpt_keys():
            r = off._regions[i]
            for flat, buf in ((master, off.fp32), (exp_avg, off.exp_avg),
                              (exp_avg_sq, off.exp_avg_sq)):
                if flat is None:
                    continue
                if key not in flat:
                    raise KeyError(f"checkpoint missing array {key!r}")
                full = torch.from_numpy(np.asarray(flat[key], np.float32))
                part = shard(full.reshape(engine._shapes[i]), engine._axes[i],
                             engine.dp_rank, engine.dp_size)
                buf[r.offset:r.offset + r.size].copy_(part.reshape(-1))


def comm_ef_geometry(engine):
    """The geometry of the engine-held compressed-exchange error feedback
    (``_comm_we`` / ``_comm_se``), or None when the engine holds none: what a
    save records beside the buffers and a restore validates
    (``resilience/elastic.py``; the JAX engine's ``comm_ef.json``)."""
    if getattr(engine, "_comm_we", None) is None:
        return None
    plan = engine._overlap_plan
    geo = {"dp": int(engine.dp_size), "slice_size": int(engine._comm_groups.topo.slice_size)}
    if plan is not None:
        geo["layout"] = "bucketed"
        geo["buckets"] = [{"sizes": [int(s) for s in b["sizes"]], "n": int(b["n"]),
                           "n_pad": int(b["n_pad"])} for b in plan]
    else:
        geo["layout"] = "monolithic"
        geo["n"] = int(engine._numel())
        geo["n_pad"] = int(engine._n_pad)
    return geo


# ------------------------------------------------------------------ save
def _barrier(engine):
    """Rendezvous across ranks: a save returns only after EVERY rank's files
    are on disk (an immediate load may otherwise race another rank's writes)."""
    if getattr(engine, "_world_size", engine.dp_size) > 1:
        dist.barrier()


def snapshot_checkpoint(engine, tag: Optional[str] = None, client_state: Dict = {}):
    """Phase 1 of a save: materialize every checkpoint payload as HOST data.

    Runs the device→host copies (and the all-gathers every rank must join)
    but touches NO files — the returned snapshot is self-contained host
    state, so phase 2 (``write_snapshot``) can run on a background writer
    thread while training keeps stepping (resilience/async_ckpt.py). Every
    leaf is copied before this returns, so the snapshot never observes the
    next step's in-place update."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    offload = engine._offload
    # the model-states/scaler/optim-shard/latest files are shared paths —
    # exactly one WRITER (rank 0); every rank runs every export below, since
    # the ZeRO slices need an all-gather that every rank joins
    # under tensor parallelism every rank holds data rank 0's coordinate of
    # its model-axis group: the writer is world rank 0
    writer = engine.dp_rank == 0 and (not dist.is_initialized() or dist.get_rank() == 0)
    files: Dict[str, Any] = {}  # filename -> ("npz", flat dict) | ("json", obj)

    if offload is not None:
        # host-tier state: each rank snapshots its own regions
        shard_, off_manifest = _snapshot_offload_regions(engine)
        files[offload_states_name(engine.dp_rank) + ".npz"] = ("npz", shard_)
        files[f"offload_manifest_{engine.dp_rank}.json"] = ("json", off_manifest)

    # --- model states (replicated compute params + host-side counters) ---
    params_flat = engine._ckpt_export("params", materialize=writer)
    if writer:
        files[model_states_name() + ".npz"] = ("npz", params_flat)
        meta = {
            "external_master": bool(engine._external_master),
            "global_steps": engine.global_steps,
            "micro_steps": engine.micro_steps,
            "skipped_steps": engine.skipped_steps,
            "dp_world_size": engine.dp_size,
            "zero_stage": engine.zero_optimization_stage(),
            "optimizer_name": engine.optimizer.name,
            "param_groups": [
                {k: (list(v) if isinstance(v, tuple) else v) for k, v in g.items()}
                for g in engine.optimizer.param_groups
            ],
            "lr_scheduler": (engine.lr_scheduler.state_dict()
                             if engine.lr_scheduler is not None else None),
            "client_state": client_state,
        }
        files[model_states_name() + ".json"] = ("json", meta)
        # --- scaler state ---
        files["loss_scaler.npz"] = ("npz", _scaler_flat(engine.scaler_state))

    if offload is None:
        # --- optimizer + master states, one file per DP rank (elastic layout) ---
        # external-master engines hold no master (it is byte-for-byte derivable as
        # the fp32 upcast of the saved params)
        dp = engine.dp_size
        master_flat = ({} if engine._external_master
                       else engine._ckpt_export("master", materialize=writer))
        opt_flat = engine._ckpt_export("opt", materialize=writer)
        if writer:
            split = {f"{prefix}/{key}": elastic_split(arr, dp)
                     for prefix, flat in (("master", master_flat), ("opt", opt_flat))
                     for key, arr in flat.items()}
            for dp_rank in range(dp):
                files[optim_states_name(dp_rank) + ".npz"] = (
                    "npz", {key: parts[dp_rank] for key, parts in split.items()})
            # shape manifest for elastic restore
            shapes = {f"master/{k}": list(v.shape) for k, v in master_flat.items()}
            shapes.update({f"opt/{k}": list(v.shape) for k, v in opt_flat.items()})
            files["optim_shapes.json"] = ("json", {"dp_world_size": dp,
                                                  "shapes": shapes})

    # --- engine-held compressed-comm error feedback: every rank's row ---
    ef_geo = comm_ef_geometry(engine)
    if ef_geo is not None:
        rows = {k: unshard(t[None], 0, engine.dp_size)
                for k, t in (("server_error", engine._comm_se),
                             ("worker_error", engine._comm_we))}
        if writer:
            files["comm_ef.npz"] = ("npz", {k: to_host(t) for k, t in rows.items()})
            files["comm_ef.json"] = ("json", ef_geo)

    return {"tag": str(tag), "writer": writer,
            "single_process": getattr(engine, "_world_size", engine.dp_size) == 1,
            "offload": offload is not None,
            "n_procs": engine.dp_size,
            "manifest_meta": {"tag": str(tag),
                              "global_steps": int(engine.global_steps),
                              "dp_world_size": int(engine.dp_size)},
            "files": files}


def _write_payloads(dirpath: str, files: Dict[str, Any], seconds: Dict[str, float]) -> None:
    for name in sorted(files):
        kind, payload = files[name]
        path = os.path.join(dirpath, name)
        t0 = time.perf_counter()
        with open(path, "wb" if kind == "npz" else "w") as f:
            if kind == "npz":
                np.savez(f, **payload)
            else:
                json.dump(payload, f)
            f.flush()
            t1 = time.perf_counter()
            os.fsync(f.fileno())
        seconds["write"] += t1 - t0
        seconds["fsync_rename"] += time.perf_counter() - t1


def write_snapshot(snapshot: Dict, save_dir: str, save_latest: bool = True,
                   barrier=None) -> str:
    """Phase 2 of a save: the commit protocol. Pure host file I/O — no device
    access — so it is safe on a background writer thread.

    Single-process: every file lands in ``<tag>.tmp/``, the integrity manifest
    is written (itself via tmp + replace), everything is fsynced, and the tmp
    dir is atomically renamed to ``<tag>/``. A crash at ANY point leaves
    either the previous committed state or a ``.tmp`` dir restore ignores.

    Multi-process: each rank writes its own files straight into the final
    dir (a cross-rank dir rename cannot be made atomic without another
    rendezvous); after ``barrier()``, rank 0 writes the manifest LAST, so a
    torn multi-rank save still presents as missing/mismatched manifest and is
    skipped at restore. ``latest`` always updates via tmp + os.replace.

    ``snapshot["seconds"]`` gets the stages' seconds: ``write`` (the payloads),
    ``hash_manifest`` (sha256 of every file and the manifest) and
    ``fsync_rename`` (the payloads' fsyncs, the rename, ``latest``)."""
    tag = snapshot["tag"]
    files = snapshot["files"]
    final_dir = _ckpt_dir(save_dir, tag)
    seconds = snapshot["seconds"] = {"write": 0.0, "hash_manifest": 0.0,
                                     "fsync_rename": 0.0}
    os.makedirs(save_dir, exist_ok=True)

    if snapshot["single_process"]:
        tmp_dir = final_dir + TMP_SUFFIX
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        _write_payloads(tmp_dir, files, seconds)
        t0 = time.perf_counter()
        write_manifest(tmp_dir, extra=snapshot["manifest_meta"])
        t1 = time.perf_counter()
        _fsync_dir(tmp_dir)
        if os.path.isdir(final_dir):
            # re-saving an existing tag: the old dir must vacate the name. The
            # crash window between rmtree and rename can lose THIS tag, but
            # ``latest`` still points at a committed tag until the final step.
            shutil.rmtree(final_dir)
        os.rename(tmp_dir, final_dir)
        _fsync_dir(save_dir)
    else:
        os.makedirs(final_dir, exist_ok=True)
        if snapshot["offload"] and snapshot["writer"]:
            # a reused tag dir may hold files from an older, larger topology;
            # current writers only touch indices < n_procs, so this is safe
            for stale in glob.glob(os.path.join(final_dir, "offload_manifest_*.json")):
                idx = int(stale.rsplit("_", 1)[1].split(".")[0])
                if idx >= snapshot["n_procs"]:
                    os.remove(stale)
                    npz = os.path.join(final_dir, offload_states_name(idx) + ".npz")
                    if os.path.isfile(npz):
                        os.remove(npz)
        _write_payloads(final_dir, files, seconds)
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        if snapshot["writer"]:
            write_manifest(final_dir, extra=snapshot["manifest_meta"])
        t1 = time.perf_counter()

    if save_latest and snapshot["writer"]:
        write_latest(save_dir, tag)
    seconds["hash_manifest"] += t1 - t0
    seconds["fsync_rename"] += time.perf_counter() - t1
    return final_dir


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None, client_state: Dict = {},
                    save_latest: bool = True):
    snapshot = snapshot_checkpoint(engine, tag=tag, client_state=client_state)
    write_snapshot(snapshot, save_dir, save_latest=save_latest,
                   barrier=lambda: _barrier(engine))
    _barrier(engine)
    logger.info(f"[deepspeed_tpu_torch] saved checkpoint {snapshot['tag']} to {save_dir}")
    return True


# ------------------------------------------------------------------ load
class _MergedElastic:
    """The per-DP-rank optim shards of ``ckpt_dir`` (any saved dp size) merged
    back into full arrays (the JAX package's ``_merge_elastic``), each read
    when it is asked for: ``merged[key]`` concatenates its flat parts from
    every rank's file."""

    def __init__(self, ckpt_dir: str):
        with open(os.path.join(ckpt_dir, "optim_shapes.json")) as f:
            manifest = json.load(f)
        self.shapes = manifest["shapes"]
        self._files = []
        try:
            for dp_rank in range(manifest["dp_world_size"]):
                self._files.append(NpzFile(
                    os.path.join(ckpt_dir, optim_states_name(dp_rank) + ".npz")))
        except BaseException:
            self.close()
            raise

    def __contains__(self, key):
        return key in self.shapes

    def __getitem__(self, key):
        return np.concatenate([f[key] for f in self._files]).reshape(self.shapes[key])

    def close(self):
        for f in self._files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Prefixed:
    """``flat`` seen through one key prefix: ``view[k]`` is ``flat[prefix + k]``."""

    def __init__(self, flat, prefix):
        self._flat, self._prefix = flat, prefix

    def __contains__(self, key):
        return self._prefix + key in self._flat

    def __getitem__(self, key):
        return self._flat[self._prefix + key]


class _Timed:
    """``flat`` whose reads add their seconds to ``seconds["read"]``."""

    def __init__(self, flat, seconds):
        self._flat, self._seconds = flat, seconds

    def __contains__(self, key):
        return key in self._flat

    def __getitem__(self, key):
        t0 = time.perf_counter()
        try:
            return self._flat[key]
        finally:
            self._seconds["read"] += time.perf_counter() - t0


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True, load_lr_scheduler_states: bool = True):
    t_start = time.perf_counter()
    if tag is None:
        latest_path = os.path.join(load_dir, "latest")
        if os.path.isfile(latest_path):
            with open(latest_path) as f:
                tag = f.read().strip()
        else:
            logger.warning(f"Unable to find latest file at {latest_path}, "
                           "if trying to load latest checkpoint please pass a valid tag.")
            return None, {}
    ckpt_dir = _ckpt_dir(load_dir, tag)
    if not os.path.isdir(ckpt_dir):
        logger.warning(f"Client provided checkpoint tag {tag} does not exist in {load_dir}")
        return None, {}
    ok, reason = verify_checkpoint(ckpt_dir)
    if not ok:
        # torn / partially-written save (a crash mid-write) — refuse it rather
        # than load silently-corrupt state; auto-resume falls back to an older
        # committed tag (resilience/auto_resume.py)
        logger.warning(f"[deepspeed_tpu_torch] REFUSING to load checkpoint {tag}: {reason}")
        return None, {}
    seconds = {"verify": time.perf_counter() - t_start, "read": 0.0}

    with open(os.path.join(ckpt_dir, model_states_name() + ".json")) as f:
        meta = json.load(f)

    with NpzFile(os.path.join(ckpt_dir, model_states_name() + ".npz")) as data:
        engine._ckpt_import("params", _Timed(data, seconds))

    engine.global_steps = meta["global_steps"]
    engine.micro_steps = meta["micro_steps"]
    engine.skipped_steps = meta["skipped_steps"]
    for g, src in zip(engine.optimizer.param_groups, meta.get("param_groups", [])):
        src = dict(src)
        if "betas" in src and isinstance(src["betas"], list):
            src["betas"] = tuple(src["betas"])
        g.update(src)
    if load_lr_scheduler_states and engine.lr_scheduler is not None and meta.get("lr_scheduler"):
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])

    with np.load(os.path.join(ckpt_dir, "loss_scaler.npz")) as data:
        engine.scaler_state = _scaler_from(data)

    offload = engine._offload
    if load_optimizer_states:
        if _offload_manifests(ckpt_dir):
            if offload is not None and _scatter_offload_regions(ckpt_dir, engine):
                pass  # same topology: regions copied straight into the local buffers
            else:
                # topology or engine changed: reassemble full leaves, then take
                # this rank's slices
                t0 = time.perf_counter()
                master_flat, ea_flat, eas_flat = _load_offload_regions(ckpt_dir)
                seconds["read"] += time.perf_counter() - t0
                if offload is not None:
                    _load_offload_full(engine, master_flat, ea_flat, eas_flat)
                else:
                    if not engine._external_master:
                        engine._ckpt_import("master", master_flat)
                    opt_flat = {f"exp_avg/{k}": v for k, v in ea_flat.items()}
                    opt_flat.update({f"exp_avg_sq/{k}": v for k, v in eas_flat.items()})
                    engine._ckpt_import("opt", opt_flat)
        else:
            with _MergedElastic(ckpt_dir) as merged:
                # an external-master checkpoint holds no master: the master is
                # BY DEFINITION the fp32 upcast of the restored params
                has_master = any(k.startswith("master/") for k in merged.shapes)
                merged = _Timed(merged, seconds)
                master_flat = _Prefixed(merged, "master/")
                opt_flat = _Prefixed(merged, "opt/")
                if offload is not None:
                    # host-tier state: straight into the flat offload buffers —
                    # never materialize master/moments on device
                    _load_offload_full(
                        engine, master_flat if has_master else engine._ckpt_export("params"),
                        _Prefixed(opt_flat, "exp_avg/"), _Prefixed(opt_flat, "exp_avg_sq/"))
                else:
                    if engine._external_master:
                        pass  # no master storage; the view re-derives from params
                    elif has_master:
                        engine._ckpt_import("master", master_flat)
                    else:
                        engine._master_from_params()
                    if engine._onebit is not None and meta["dp_world_size"] != engine.dp_size:
                        # 1-bit Adam's state sizes depend on dp (padded moments,
                        # per-rank error buffers): adapt them
                        template = engine._onebit.state_template(engine.opt_state)
                        opt_flat = engine._onebit.elastic_adapt(
                            {k: opt_flat[k] for k in template if k in opt_flat}, template)
                    engine._ckpt_import("opt", opt_flat)
    elif offload is not None:
        # re-derive master from loaded params (fp16-derived restore, stage2.py:1781-1836)
        _load_offload_full(engine, engine._ckpt_export("params"), None, None)
    else:
        engine._master_from_params()

    if engine._comm_we is not None:
        # engine-held compressed-comm error feedback: restored, remapped on a
        # dp change, or left at zero for a checkpoint without it
        from ..resilience.elastic import restore_comm_ef
        restore_comm_ef(engine, ckpt_dir)

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    _barrier(engine)
    seconds["total"] = time.perf_counter() - t_start
    seconds["place"] = seconds["total"] - seconds["verify"] - seconds["read"]
    engine.last_checkpoint_load = seconds
    logger.info(f"[deepspeed_tpu_torch] loaded checkpoint {tag} from {load_dir} "
                f"(saved dp={meta['dp_world_size']}, current dp={engine.dp_size})")
    return ckpt_dir, meta.get("client_state", {})
