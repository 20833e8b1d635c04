"""Async checkpointing: snapshot on the step thread, commit off it (PyTorch
port of ``deepspeed_tpu/resilience/async_ckpt.py``).

The save is split exactly along the device/host boundary
(checkpoint/checkpointing.py):

- **snapshot** (``snapshot_checkpoint``) runs on the caller's thread — the
  device→host copy of every leaf plus the all-gathers of the ZeRO slices, the
  ONLY part that must see a consistent state. The engine updates its state in
  place, so the snapshot copies every leaf before it returns: the exposed
  cost is the copy, and the next step cannot reach the copied payloads.
- **commit** (``write_snapshot``) is pure host file I/O and runs on a
  background writer thread. The commit protocol (tmp dir → fsync → atomic
  rename → ``latest`` via ``os.replace``) means a crash at any point — the
  trainer's or the writer thread's — leaves either the previous committed
  checkpoint or an ignorable ``.tmp`` dir, never a loadable torn state.

One save may be in flight at a time: a new ``save()`` first joins the
previous writer (re-raising its failure rather than dropping it), so the
steady state is "training overlaps one background commit". At dp > 1 the
COMMIT runs on the caller thread — ``write_snapshot``'s cross-rank barrier
must not rendezvous from per-rank writer threads — keeping the same
two-phase structure and crash safety through the manifest-last ordering.
"""

import threading
import time

from ..checkpoint.checkpointing import _barrier, snapshot_checkpoint, write_snapshot
from ..utils import logger


class AsyncCheckpointer:
    """Owns the background writer for one engine. ``last_stall_ms`` is the
    caller-visible cost of the most recent ``save()`` (snapshot + join of the
    previous writer)."""

    def __init__(self, engine, save_dir: str, save_latest: bool = True,
                 fence_delay_s: float = 0.0):
        self.engine = engine
        self.save_dir = save_dir
        self.save_latest = save_latest
        self._thread = None
        self._error = None
        self.last_stall_ms = 0.0
        self.saves_started = 0
        self.saves_committed = 0
        # fault injection (crash-sim's goodput attribution): a known extra
        # stall inside the snapshot fence, for the ledger's checkpoint_stall
        self.fence_delay_s = float(fence_delay_s)

    @property
    def in_flight(self) -> bool:
        """Whether a commit is running on the writer thread now."""
        return self._thread is not None and self._thread.is_alive()

    def _commit(self, snapshot):
        try:
            write_snapshot(snapshot, self.save_dir, save_latest=self.save_latest,
                           barrier=lambda: _barrier(self.engine))
            self.saves_committed += 1
            logger.info(f"[deepspeed_tpu_torch] async checkpoint {snapshot['tag']} "
                        f"committed to {self.save_dir}")
        except BaseException as e:   # surfaced by the next save()/wait()
            self._error = e

    def save(self, tag=None, client_state={}):
        """Snapshot now, commit in the background. Blocks only for the
        device→host copy (and any previous still-running commit)."""
        t0 = time.perf_counter()
        self.wait()
        if self.fence_delay_s > 0.0:
            time.sleep(self.fence_delay_s)
        snapshot = snapshot_checkpoint(self.engine, tag=tag, client_state=client_state)
        self.saves_started += 1
        if snapshot["single_process"]:
            self._thread = threading.Thread(
                target=self._commit, args=(snapshot,),
                name="ds-ckpt-writer", daemon=True)
            self._thread.start()
        else:
            # dp > 1: the commit's cross-rank barrier must run on the thread
            # every rank drives in lockstep
            self._commit(snapshot)
        self.last_stall_ms = (time.perf_counter() - t0) * 1000.0
        return snapshot["tag"]

    def wait(self):
        """Join the in-flight commit (if any); re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
