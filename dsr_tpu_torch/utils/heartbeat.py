"""Failure detection / elastic recovery: crash-recoverable work claiming.

Counterpart of `dsr_tpu/utils/heartbeat.py`.  Across processes
(`parallel/mesh.initialize_distributed`) a dead rank stalls the
collective until the process group's timeout raises, so the failure unit
is the WORK ITEM, not the process.  This module makes that work item
recoverable: filesystem-lease work claiming with heartbeats, so any
surviving (or restarted) worker re-claims and re-decodes the batches of a
dead one (recovery = re-decode the lost batch, the utterance-level work
queue of `utils/workqueue.py`).

Protocol (shared filesystem, no coordinator):
  - a worker CLAIMS a batch by atomically creating `lease.<batch>.json`
    (O_EXCL) holding its worker id and a heartbeat timestamp;
  - while processing it re-touches the lease every `beat_s`;
  - a lease older than `stale_s` is considered dead: any worker may BREAK
    it (atomic rename to a tombstone) and re-claim;
  - completion is recorded in `DecodeProgress` (the high-water mark), and
    the lease is released.
Batches are therefore processed at-least-once, exactly-once in the absence
of failures — the same contract as the reference's rerun-the-grid-job
operational model, made automatic.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid


class LeaseBoard:
    """Filesystem lease board for crash-recoverable work claiming."""

    def __init__(self, root: str, worker_id: str | None = None,
                 beat_s: float = 5.0, stale_s: float = 15.0):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.worker_id = worker_id or f"{os.getpid()}.{uuid.uuid4().hex[:6]}"
        self.beat_s = beat_s
        self.stale_s = stale_s

    def _lease_path(self, key: str) -> str:
        return os.path.join(self.root, f"lease.{key}.json")

    def try_claim(self, key: str) -> bool:
        """Atomically claim `key`; False if a LIVE lease exists.  A stale
        lease (heartbeat older than stale_s) is broken and re-claimed."""
        path = self._lease_path(key)
        payload = json.dumps({"worker": self.worker_id, "beat": time.time()})
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            return True
        except FileExistsError:
            pass
        try:
            with open(path) as f:
                lease = json.load(f)
        except (OSError, json.JSONDecodeError):
            lease = {"beat": 0.0}
        if time.time() - lease.get("beat", 0.0) <= self.stale_s:
            return False  # holder is alive
        # break the stale lease: rename is atomic, only one breaker wins
        tomb = path + f".tomb.{self.worker_id}"
        try:
            os.rename(path, tomb)
        except FileNotFoundError:
            return False  # someone else broke it first
        os.unlink(tomb)
        return self.try_claim(key)

    def beat(self, key: str) -> None:
        """Refresh the heartbeat on a held lease.  Only beats a lease WE
        still hold (same guard as `release`): if we stalled past stale_s
        and a peer broke + re-claimed, overwriting would hijack the peer's
        live lease and our later release() would delete it — enabling a
        third concurrent claim.  A MISSING lease also skips the beat: the
        break protocol renames-then-unlinks before re-claiming, so None
        means a break (or release) is in flight and recreating the file
        here would race the peer's claim.  (holder()→replace is still not
        atomic — filesystem leases are at-least-once by contract — but
        neither remaining interleaving can recreate a deleted lease.)"""
        h = self.holder(key)
        if h is None or h.get("worker") != self.worker_id:
            return
        path = self._lease_path(key)
        tmp = path + f".beat.{self.worker_id}"
        with open(tmp, "w") as f:
            json.dump({"worker": self.worker_id, "beat": time.time()}, f)
        os.replace(tmp, path)

    def release(self, key: str) -> None:
        """Release only a lease WE still hold: if the lease was broken and
        re-claimed by a peer (we went stale mid-batch), leave it alone."""
        h = self.holder(key)
        if h is not None and h.get("worker") != self.worker_id:
            return
        try:
            os.unlink(self._lease_path(key))
        except FileNotFoundError:
            pass

    def keepalive(self, key: str):
        """Context manager: a daemon thread re-touches the lease every
        beat_s while the body (e.g. a long decode batch) runs, so live
        work is never mistaken for a dead worker's."""
        board = self

        class _Beater:
            def __enter__(self):
                self._stop = threading.Event()

                def loop():
                    while not self._stop.wait(board.beat_s):
                        board.beat(key)

                self._t = threading.Thread(target=loop, daemon=True)
                self._t.start()
                return self

            def __exit__(self, *a):
                self._stop.set()
                self._t.join()

        return _Beater()

    def holder(self, key: str):
        try:
            with open(self._lease_path(key)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None


def run_recoverable(
    utt_ids,
    batch_size: int,
    process_batch,
    progress,
    board: LeaseBoard,
) -> int:
    """Crash-recoverable variant of `workqueue.run_batched`: batches are
    claimed through the lease board, so concurrent workers cooperate and a
    dead worker's unfinished batches become claimable once its heartbeat
    goes stale.  Returns the number of utterances THIS worker processed."""
    batches = [
        utt_ids[i : i + batch_size] for i in range(0, len(utt_ids), batch_size)
    ]
    n = 0
    for bi, batch in enumerate(batches):
        todo = [u for u in batch if not progress.is_done(u)]
        if not todo:
            continue
        key = f"b{bi:06d}"
        if not board.try_claim(key):
            continue
        try:
            with board.keepalive(key):     # heartbeat WHILE processing —
                process_batch(todo)        # slow batches must not look dead
                for u in todo:
                    progress.mark(u)
            n += len(todo)
        finally:
            board.release(key)
    return n
