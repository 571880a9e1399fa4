"""Utterance-level work queue with checkpointed progress: recovery =
re-decode the lost batch; over several processes each takes every
num_processes-th batch.

Counterpart of `dsr_tpu/utils/workqueue.py`.
"""

from __future__ import annotations

from typing import Callable, Sequence

from dsr_tpu_torch.utils.checkpoint import DecodeProgress


def run_batched(
    utt_ids: Sequence[str],
    batch_size: int,
    process_batch: Callable[[list[str]], None],
    progress: DecodeProgress | None = None,
    process_index: int = 0,
    num_processes: int = 1,
) -> int:
    """Process utterances in batches, skipping checkpointed ones.

    Returns the number of utterances processed this run.  On a crash,
    re-running skips completed work (the high-water mark is per utterance,
    written after each batch).
    """
    todo = [u for u in utt_ids if progress is None or not progress.is_done(u)]
    todo = todo[process_index::num_processes]
    n = 0
    for i in range(0, len(todo), batch_size):
        batch = todo[i:i + batch_size]
        process_batch(batch)
        if progress is not None:
            for u in batch:
                progress.mark(u)
        n += len(batch)
    return n
