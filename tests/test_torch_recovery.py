"""tests/test_failure_recovery.py's three drills against the port's
`utils/heartbeat.py` and `utils/checkpoint.DecodeProgress`: leases are
claimed, go stale and are broken; two cooperating workers split the work;
a subprocess worker (importing only the port) is SIGKILLed mid-batch, its
lease goes stale and a survivor re-claims and re-decodes the lost batch,
losing nothing and redoing no finished utterance.  The sleeps only let a
heartbeat go stale; nothing is timed."""

import json
import os
import signal
import subprocess
import sys
import time

from dsr_tpu_torch.utils.checkpoint import DecodeProgress
from dsr_tpu_torch.utils.heartbeat import LeaseBoard, run_recoverable

UTTS = [f"utt{i:03d}" for i in range(12)]


def test_port_lease_claim_stale_break(tmp_path):
    a = LeaseBoard(str(tmp_path), worker_id="A", stale_s=0.3)
    b = LeaseBoard(str(tmp_path), worker_id="B", stale_s=0.3)
    assert a.try_claim("b0")
    assert not b.try_claim("b0")           # live lease blocks
    a.beat("b0")
    assert not b.try_claim("b0")
    time.sleep(0.4)                        # heartbeat goes stale
    assert b.try_claim("b0")               # broken + re-claimed
    assert b.holder("b0")["worker"] == "B"
    b.release("b0")
    assert a.try_claim("b0")


def test_port_cooperative_workers_partition_work(tmp_path):
    prog = DecodeProgress(str(tmp_path / "prog.json"))
    board_a = LeaseBoard(str(tmp_path / "leases"), worker_id="A")
    board_b = LeaseBoard(str(tmp_path / "leases"), worker_id="B")
    seen_a, seen_b = [], []
    na = run_recoverable(UTTS, 3, seen_a.extend, prog, board_a)
    nb = run_recoverable(UTTS, 3, seen_b.extend, prog, board_b)
    assert na == len(UTTS) and nb == 0     # A did everything, B redid nothing
    assert sorted(seen_a) == UTTS


def test_port_killed_worker_batch_is_recovered(tmp_path):
    """The actual drill: a subprocess worker claims the first batch, marks
    one utterance done, then hangs; we SIGKILL it (exact PID).  A survivor
    with a short staleness window re-claims the batch and finishes the
    corpus."""
    prog_path = str(tmp_path / "prog.json")
    lease_dir = str(tmp_path / "leases")
    child_src = f"""
import json, sys, time
sys.path.insert(0, {json.dumps(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
from dsr_tpu_torch.utils.checkpoint import DecodeProgress
from dsr_tpu_torch.utils.heartbeat import LeaseBoard
assert not [m for m in sys.modules if m.startswith("jax") or m.split(".")[0] == "dsr_tpu"]
board = LeaseBoard({json.dumps(lease_dir)}, worker_id="victim")
prog = DecodeProgress({json.dumps(prog_path)})
assert board.try_claim("b000000")
board.beat("b000000")
prog.mark("utt000")        # half-finished batch
print("CLAIMED", flush=True)
time.sleep(300)            # hang holding the lease
"""
    child = subprocess.Popen(
        [sys.executable, "-c", child_src],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        line = child.stdout.readline()
        assert "CLAIMED" in line
        os.kill(child.pid, signal.SIGKILL)   # exact PID, mid-batch death
        child.wait()

        prog = DecodeProgress(prog_path)      # survivor re-reads progress
        assert prog.is_done("utt000")
        survivor = LeaseBoard(lease_dir, worker_id="survivor", stale_s=0.5)
        done = []
        time.sleep(0.6)                       # victim's heartbeat goes stale
        n = run_recoverable(UTTS, 3, done.extend, prog, survivor)
        # survivor re-decoded the lost batch (minus the checkpointed utt)
        # and everything else
        assert n == len(UTTS) - 1
        assert "utt000" not in done           # checkpointed work not redone
        assert sorted(done + ["utt000"]) == UTTS
        assert all(prog.is_done(u) for u in UTTS)
    finally:
        if child.poll() is None:
            child.kill()
