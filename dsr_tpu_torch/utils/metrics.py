"""WER scoring (NIST-style levenshtein alignment) and RTF counters; the
port's copy of `dsr_tpu/utils/metrics.py` (plain Python)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def edit_distance(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """→ (substitutions, deletions, insertions, num_ref)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    dp = [[(0, 0, 0, 0)] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dp[i][0] = (i, 0, i, 0)
    for j in range(1, m + 1):
        dp[0][j] = (j, 0, 0, j)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
                continue
            sub = dp[i - 1][j - 1]
            dele = dp[i - 1][j]
            ins = dp[i][j - 1]
            best = min(sub, dele, ins, key=lambda x: x[0])
            if best is sub:
                dp[i][j] = (best[0] + 1, best[1] + 1, best[2], best[3])
            elif best is dele:
                dp[i][j] = (best[0] + 1, best[1], best[2] + 1, best[3])
            else:
                dp[i][j] = (best[0] + 1, best[1], best[2], best[3] + 1)
    _, s, d, ins = dp[n][m]
    return s, d, ins, n


@dataclass
class WerScorer:
    subs: int = 0
    dels: int = 0
    ins: int = 0
    num_ref: int = 0

    def add(self, ref: list, hyp: list):
        s, d, i, n = edit_distance(ref, hyp)
        self.subs += s
        self.dels += d
        self.ins += i
        self.num_ref += n

    @property
    def wer(self) -> float:
        return (self.subs + self.dels + self.ins) / max(self.num_ref, 1)

    def __str__(self):
        return (
            f"WER {100*self.wer:.2f}%  (S={self.subs} D={self.dels} I={self.ins} "
            f"/ N={self.num_ref})"
        )


@dataclass
class RtfMeter:
    """Real-time-factor / audio-seconds-per-second meter."""

    audio_sec: float = 0.0
    wall_sec: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float):
        self.wall_sec += time.perf_counter() - self._t0
        self.audio_sec += audio_seconds

    @property
    def rtf(self) -> float:
        return self.wall_sec / max(self.audio_sec, 1e-9)

    @property
    def audio_sec_per_sec(self) -> float:
        return self.audio_sec / max(self.wall_sec, 1e-9)
