"""Bytes and operations that each piece of the timed path needs, from its
shapes, for the rooflines and the whole step's share of the peak.

The arithmetic of the analysis, fused analysis + beamform, synthesis and
select counts is a copy of `chip_smoke.py`'s `bound` arguments, so that the
yardstick does not move when that script does.  Every count reads each
input once and writes each output once, whatever a kernel reads again;
where the work depends on the data (the decoder's live tokens), the counts
take what these inputs need, not the most they could.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Work:
    nbytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.flops * k)

    __rmul__ = __mul__


def rfft_flops(n: int) -> float:
    """A real-input FFT of length n: half the 5 n log2 n of a complex one."""
    return 2.5 * n * math.log2(n)


def analysis_beamform(C: int, S: int, T: int, M: int, m: int) -> Work:
    """One fused analysis + MVDR beamform of C channels of S samples into T
    frames of K = M/2 + 1 bins: the signal, the prototype (m M taps) and
    the (K, C) complex weights in, the (T, K) complex subbands out; per
    channel and frame the window (L multiplies and adds), a real FFT of
    length M, and the weighted sum (a complex multiply-add, 8 operations, a
    bin)."""
    K, L = M // 2 + 1, m * M
    return Work(4 * (C * S + L) + 8 * K * C + 8 * T * K,
                C * T * (2 * L + rfft_flops(M) + 8 * K))


def synthesis_rows(T: int, M: int, m: int, r: int, start: int, out_len: int) -> int:
    """The frames that output samples [start, start + out_len) read."""
    L, D = m * M, M // r
    t_lo = max(0, start // D - L // D + 1)
    return min(T - 1, (start + out_len - 1) // D) - t_lo + 1


def synthesis(C: int, T: int, M: int, m: int, r: int, start: int, out_len: int) -> Work:
    """Synthesis of C channels: the frames the output reads (complex, K
    bins) and the prototype in, out_len samples out; an inverse real FFT a
    frame and L / D multiply-adds a sample."""
    K, L, D = M // 2 + 1, m * M, M // r
    rows = synthesis_rows(T, M, m, r, start, out_len)
    return Work(8 * C * rows * K + 4 * L + 4 * C * out_len,
                C * (rows * rfft_flops(M) + out_len * 2 * (L // D)))


def mvdr_weights(B: int, K: int, N: int) -> Work:
    """B blocks' MVDR weights from the loaded inverse coherence (K, N, N,
    complex, read once for the batch) and each block's N delays: steering
    vectors (a phase and its cosine and sine, 4 operations an entry),
    Gamma^-1 v (a complex multiply-add, 8 operations), v^H Gamma^-1 v and
    the division (16 operations an entry); the (B, K, N) weights out."""
    return Work(8 * K * N * N + 4 * B * N + 8 * B * K * N,
                B * K * N * (8 * N + 20))


def mfcc_cmn(B: int, T: int, K: int, num_mel: int, num_cep: int) -> Work:
    """Subband MFCC and CMN of B blocks: the (T, K) complex subbands in,
    the (T, num_cep) normalised cepstra out; the power (3 operations a
    bin), the mel product, the log, the DCT product and the mean and its
    subtraction."""
    return Work(8 * B * T * K + 4 * B * T * num_cep,
                B * T * (3 * K + 2 * K * num_mel + num_mel + 2 * num_mel * num_cep
                         + 2 * num_cep))


def gmm(rows: int, D: int, S: int, C: int) -> Work:
    """Diagonal-GMM log-likelihoods of `rows` frames of D features under S
    states of C components: features and parameters in, (rows, S) out; a
    quadratic form (2 (2 D + 1) operations) a component and a
    log-sum-exp over the components (4 operations a component)."""
    return Work(4 * rows * D + 4 * S * C * (2 * D + 1) + 4 * rows * S,
                rows * S * C * (2 * (2 * D + 1) + 4))


def decode_expand(live_candidates: int) -> Work:
    """The decoder's candidate arcs of the live tokens: per arc its pdf,
    weight and destination and its frame's log-likelihood read (16 bytes),
    two additions."""
    return Work(16 * live_candidates, 2 * live_candidates)


def select(live_candidates: int, live_slots: int, utterances: int) -> Work:
    """The select kernel's frames (recombine, beam prune, top K): 12 bytes
    in a live candidate (score, destination, arc), the beam of each
    utterance, 12 bytes out a kept token; two comparisons a candidate."""
    return Work(12 * live_candidates + 4 * utterances + 12 * live_slots, 2 * live_candidates)
