"""Port parity: the banded Viterbi kernel's plain twin
(`dsr_tpu_torch/ops/cuda/viterbi.py`, `banded_viterbi_plain`, which the
wrapper runs on CPU tensors) against the JAX package's Pallas kernel
(`dsr_tpu/ops/pallas/viterbi.py`, interpret mode, as tests/test_pallas.py
runs it) and against the dense `viterbi` on the same chain.  The CUDA
kernel itself is held to the twin bit for bit on the card by chip_smoke.py.

The lane kernel's algorithm (`ops/cuda/csrc/viterbi.cu`, S <= 1,024) is
transcribed to NumPy and held to the twin bit for bit: lanes of J
consecutive states in warps of 32, the shuffle and the warps' boundary
deltas, ll a chunk of rows at a time through a ring of copies (the rows'
16-byte-aligned interior in one bulk copy, the ragged ends a float at a
time, nothing read outside ll), and bp gathered per chunk and flushed in
head, 16-byte and tail pieces.

Tolerance: the backpointer planes and delta equal bit for bit, and the
paths equal: the twin makes the kernel's float32 additions in the Pallas
kernel's order.  The score from the dense recursion within 1e-5 relative
(its sums run in the same order too; ties, none here, could differ).
"""

import numpy as np
import pytest
import torch

from dsr_tpu.ops.pallas import viterbi as pvit
from dsr_tpu_torch.asr.decoder import viterbi as vit
from dsr_tpu_torch.ops.cuda import viterbi as cvit

NEG = -1e30


def _chain(seed, T, S, adv0):
    rng = np.random.default_rng(seed)
    ll = (rng.standard_normal((T, S)) * 3).astype(np.float32)
    ws = np.log(rng.uniform(0.3, 0.9, S)).astype(np.float32)
    wa = np.log(rng.uniform(0.1, 0.7, S)).astype(np.float32)
    wa[0] = adv0
    return ll, ws, wa


def _pallas_planes(ll, ws, wa):
    """The Pallas kernel's backpointer planes and final delta on states < S
    (its (R, 128) layout padded with -1e30, as `banded_viterbi` pads it)."""
    T, S = ll.shape
    Sp = -(-S // 128) * 128
    R = Sp // 128

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Sp - S)], constant_values=NEG)

    init = np.full(Sp, NEG, np.float32)
    init[0] = 0.0
    bp, delta = pvit._banded_impl(pad(ll).reshape(T, R, 128), pad(ws).reshape(R, 128),
                                  pad(wa).reshape(R, 128), init.reshape(R, 128))
    return np.asarray(bp).reshape(T, Sp)[:, :S], np.asarray(delta).reshape(Sp)[:S]


def _twin(ll, ws, wa):
    cvit.reset_launches()
    bp, delta = cvit.banded_viterbi(*(torch.as_tensor(a) for a in (ll[None], ws, wa)))
    assert cvit.launches["viterbi"] == 0          # CPU tensors run the plain twin
    return bp[0].numpy(), delta[0].numpy()


def test_twin_matches_pallas_kernel_at_37_and_128_states():
    """adv_lp[0] = -1e30, the force-align convention: at S = 128 the Pallas
    kernel's roll reads state S-1 itself into state 0's advance, and the
    -1e30 keeps it harmless, so planes and delta agree bit for bit."""
    for S, T in ((37, 60), (128, 300)):
        ll, ws, wa = _chain(S, T, S, NEG)
        bp_p, d_p = _pallas_planes(ll, ws, wa)
        bp, d = _twin(ll, ws, wa)
        assert np.array_equal(bp, bp_p.astype(np.uint8))
        assert np.array_equal(d.view(np.uint32), d_p.view(np.uint32))
        path_p, score_p = pvit.banded_viterbi(ll, ws, wa)
        path, score = cvit.banded_path(*(torch.as_tensor(a) for a in (ll, ws, wa)))
        assert np.array_equal(path, np.asarray(path_p))
        assert score == float(score_p) and score > NEG / 2


def test_wrap_of_the_pallas_layout_at_a_finite_state_0_advance():
    """With a finite adv_lp[0] and S a multiple of 128 the Pallas kernel
    enters state 0 from state S-1 (its roll wraps); the port gives state 0
    no predecessor (ROADMAP, expected differences).  The planes then differ,
    the traced paths here do not."""
    ll, ws, wa = _chain(7, 300, 128, np.log(0.4))
    bp_p, d_p = _pallas_planes(ll, ws, wa)
    bp, d = _twin(ll, ws, wa)
    assert bp_p[:, 0].any() and not bp[:, 0].any()
    assert not np.array_equal(d, d_p)
    path_p, score_p = pvit.banded_viterbi(ll, ws, wa)
    path, score = cvit.banded_path(*(torch.as_tensor(a) for a in (ll, ws, wa)))
    assert np.array_equal(path, np.asarray(path_p)) and score == float(score_p)


def test_twin_path_equals_dense_viterbi_on_the_chain():
    for seed, (T, S) in enumerate(((60, 37), (200, 36), (90, 90))):
        ll, ws, wa = _chain(seed, T, S, NEG)
        A = np.full((S, S), NEG, np.float32)
        np.fill_diagonal(A, ws)
        A[np.arange(S - 1), np.arange(1, S)] = wa[1:]
        init = np.full(S, NEG, np.float32)
        init[0] = 0.0
        final = np.full(S, NEG, np.float32)
        final[S - 1] = 0.0
        p_d, s_d = vit.viterbi(torch.as_tensor(ll), A, init, final)
        path, score = cvit.banded_path(*(torch.as_tensor(a) for a in (ll, ws, wa)))
        assert np.array_equal(path, p_d.numpy())
        assert abs(score - float(s_d)) <= 1e-5 * abs(float(s_d))


# ------------------------------------------ viterbi.cu's lane kernel, in NumPy

CHUNKS, CHUNK_FLOATS = 4, 4096   # the kernel's kChunks and kChunkFloats


def _lane_geometry(S):
    """launch_lanes: J states a lane (one warp up to 128 states, then warps
    of J = 4), W warps, TC frames a chunk."""
    J = 1 if S <= 32 else 2 if S <= 64 else 4
    W = -(-S // (32 * J))
    return J, W, min(64, max(1, CHUNK_FLOATS // S))


def _lane_kernel_in_numpy(ll, ws, wa, base):
    """banded_lane_kernel on (U, T, S) ll whose first float lies `base`
    floats past a 16-byte boundary (bp's first byte likewise `base` bytes):
    per utterance, lane g = 32 w + j owns states g J .. g J + J - 1; each
    chunk's rows land in a ring slot (filled with NaN first: what the padded
    lanes read is garbage) at their offset modulo 16 bytes, copied from a
    device memory that holds NaN around ll: the aligned interior at once,
    each ragged end's floats one by one, never a float outside the chunk's
    rows; frame t takes
    lane g - 1's last delta (the shuffle, or warp w - 1's boundary delta);
    bp rows gather in a buffer congruent to bp modulo 16 and go out in
    pieces."""
    U, T, S = ll.shape
    J, W, TC = _lane_geometry(S)
    lanes = 32 * W
    sidx = np.arange(lanes)[:, None] * J + np.arange(J)[None, :]   # (lanes, J) states
    own = sidx < S
    slot = (TC * S + 32 * J * W + 8 + 3) & ~3
    bp = np.zeros((U, T, S), np.uint8)
    delta = np.zeros((U, S), np.float32)
    neg = np.float32(-1e30)
    mem = np.full(base + U * T * S + 8, np.nan, np.float32)   # ll at float `base`
    mem[base:base + U * T * S] = ll.reshape(-1)
    for u in range(U):
        rowsg = ll[u].reshape(-1)
        wsl = np.where(own, ws[np.minimum(sidx, S - 1)], np.float32(0))
        wal = np.where(own, wa[np.minimum(sidx, S - 1)], np.float32(0))
        d = np.zeros((lanes, J), np.float32)
        ring = np.full((CHUNKS, slot), np.nan, np.float32)
        nchunk = -(-T // TC)
        for c in range(nchunk):
            t0, nt = c * TC, min(TC, T - c * TC)
            a = base + (u * T + t0) * S            # the rows [a, b), in floats
            b = a + nt * S
            a16, lo, hi = a // 4 * 4, -(-a // 4) * 4, b // 4 * 4
            bulk = hi > lo
            ragged = list(range(a, lo if bulk else b)) + list(range(hi if bulk else b, b))
            assert len(ragged) <= 6 and all(a <= g < b for g in ragged)
            if bulk:
                ring[c % CHUNKS, lo - a16:hi - a16] = mem[lo:hi]
            for g in ragged:
                ring[c % CHUNKS, g - a16] = mem[g]
            rows = ring[c % CHUNKS, a - a16:]
            assert np.array_equal(rows[:nt * S], rowsg[t0 * S:(t0 + nt) * S])
            g = base + (u * T + t0) * S            # bp chunk's byte address modulo 16
            bps = np.zeros(nt * S + 16, np.uint8)
            at = g % 16
            for tl in range(nt):
                t = t0 + tl
                l = rows[tl * S + sidx]
                bits = np.zeros((lanes, J), np.uint8)
                if t == 0:
                    d = np.where(sidx == 0, np.float32(0), neg) + l
                else:
                    prev = np.roll(d[:, J - 1], 1)   # lane g - 1's last delta
                    for i in range(J - 1, -1, -1):
                        stay = d[:, i] + wsl[:, i]
                        adv = (d[:, i - 1] if i > 0 else prev) + wal[:, i]
                        took = (adv > stay) & (sidx[:, i] > 0)
                        d[:, i] = np.where(took, adv, stay) + l[:, i]
                        bits[:, i] = took
                bps[at + tl * S + sidx[own]] = bits[own]
            # the flush: head bytes to the 16-byte boundary, 16-byte pieces, tail
            nbytes = nt * S
            head = min((16 - g % 16) % 16, nbytes)
            body = (nbytes - head) // 16
            out = bp[u].reshape(-1)[t0 * S:(t0 + nt) * S]
            out[:head] = bps[at:at + head]
            out[head:head + 16 * body] = bps[at + head:at + head + 16 * body]
            out[head + 16 * body:] = bps[at + head + 16 * body:at + nbytes]
        delta[u] = d.reshape(-1)[:S]
    return bp, delta


@pytest.mark.parametrize("S", [1, 31, 32, 33, 36, 512, 1000, 1024])
def test_lane_kernel_in_numpy_matches_twin_bitwise(S):
    """At T = 1, 2 and a chunk's frames - 1, + 0, + 1 (the ring's first wrap
    at S = 512 and above), two utterances, ll at each offset modulo 16
    bytes: bp planes and delta equal the twin's bit for bit."""
    J, W, TC = _lane_geometry(S)
    assert W * 32 * J >= S and (W == 1 or J == 4)
    rng = np.random.default_rng(S)
    for T in sorted({1, 2, TC - 1, TC, TC + 1} - {0}):
        ll = (rng.standard_normal((2, T, S)) * 3).astype(np.float32)
        ws = np.log(rng.uniform(0.3, 0.9, S)).astype(np.float32)
        wa = np.log(rng.uniform(0.1, 0.7, S)).astype(np.float32)
        wa[0] = -1e30
        bp_p, d_p = cvit.banded_viterbi_plain(*(torch.as_tensor(a) for a in (ll, ws, wa)))
        for base in range(4):
            bp, d = _lane_kernel_in_numpy(ll, ws, wa, base)
            assert np.array_equal(bp, bp_p.numpy()), (S, T, base)
            assert np.array_equal(d.view(np.uint32), d_p.numpy().view(np.uint32)), (S, T, base)
