"""The decoders' traceback (`dsr_tpu_torch/ops/cuda/traceback.py`): the
plain twin against the JAX decoders' walk (`_traceback_impl`, one
utterance at a time), and the CUDA kernel's algorithm
(`ops/cuda/csrc/traceback.cu`: a warp an utterance, the ring of prefetched
frames, the ballot search in groups of 32 slots, the warp argmax of the
final carry), transcribed to NumPy, against the twin.  The kernel itself
is held to the twin on the card by chip_smoke.py.

Tolerance: none.  The walk compares ints and adds one pair of floats a
slot, so arcs and scores must be equal bit for bit.

The tables are random with a path planted in them, so that the walk
follows arcs for many frames, and they hold each case the walk has to get
right: the current state in two slots (the first counts), in a dead slot
(state 0, arc -1) before a live one, absent from its row (slot 0 counts),
arcs of -1 on the path, utterances that end early (and one of no frame),
an utterance with no token in a final state, ties in the best final
score, and both source maps: arc // a_div, and through a row table whose
extra rows map to states as the degree-split graph's overflow rows do.
"""

import numpy as np
import pytest
import torch

from dsr_tpu.asr.decoder.topk_decoder import _traceback_impl
from dsr_tpu_torch.ops.cuda import traceback as ctb

NEG = np.float32(-1e30)
HALF_NEG = np.float32(-5e29)     # traceback.cu's kHalfNeg


def walk_case(seed, U=6, T=40, K=37, S=23, A=3, rows=False):
    """Token tables (T, U, K), the final carry, its final weights, lengths,
    the row table (or None) and the final-weight table (S,)."""
    rng = np.random.default_rng(seed)
    G = S // 2 if rows else 0             # overflow rows, each owned by a state
    src_of_row = np.concatenate([np.arange(S), rng.integers(0, S, G)]).astype(np.int32)
    ts = rng.integers(0, S, (T, U, K)).astype(np.int32)
    ta = rng.integers(0, (S + G) * A, (T, U, K)).astype(np.int32)
    ta[rng.random((T, U, K)) < 0.1] = -1
    dead = rng.random((T, U, K)) < 0.2    # the select's dead slots: state 0, arc -1
    ts[dead], ta[dead] = 0, -1
    for u in range(U):                    # a planted path, frame T-1 back to 0
        state = int(rng.integers(0, S))
        for t in range(T - 1, -1, -1):
            k = int(rng.integers(0, K))
            ts[t, u, k] = state
            prev = int(rng.integers(0, S))
            owners = np.flatnonzero(src_of_row == prev)
            ta[t, u, k] = int(rng.choice(owners)) * A + int(rng.integers(0, A))
            r = rng.random()
            if r < 0.08:                  # an arc of -1 on the path: the state stays
                ta[t, u, k] = -1
            elif r < 0.16:                # absent from the row: slot 0 decides
                ts[t, u][ts[t, u] == state] = (state + 1) % S
            elif r < 0.3 and k > 0:       # in an earlier dead slot too: that one counts
                j = int(rng.integers(0, k))
                ts[t, u, j], ta[t, u, j] = state, -1
            elif r < 0.4 and k > 0:       # in an earlier live slot too
                j = int(rng.integers(0, k))
                ts[t, u, j] = state
            state = prev if ta[t, u, k] >= 0 else state
    final_w = np.where(rng.random(S) < 0.4, rng.integers(-4, 1, S), NEG).astype(np.float32)
    states_f = ts[T - 1].copy()
    states_f[0] = np.flatnonzero(final_w == NEG)[0]         # utterance 0 reaches no final state
    scores_f = rng.integers(-6, 0, (U, K)).astype(np.float32)    # integers: ties
    scores_f[dead[T - 1]] = NEG
    final_f = final_w[states_f]
    lengths = np.array([T, T - 3, 1, 0, T // 2, T + 5][:U] + [T] * max(0, U - 6), np.int32)
    return ts, ta, states_f, scores_f, final_f, lengths, (src_of_row if rows else None), final_w


def twin(ts, ta, sf, scf, ff, lengths, a_div, rows):
    t = torch.as_tensor
    arcs, best = ctb.traceback_plain(t(ts), t(ta), t(sf), t(scf), t(ff), t(lengths), a_div,
                                     None if rows is None else t(rows))
    return arcs.numpy(), best.numpy()


@pytest.mark.parametrize("K", [5, 37, 64])
@pytest.mark.parametrize("rows", [False, True], ids=["divisor", "row_table"])
def test_twin_matches_the_jax_walk(rows, K):
    """Per utterance, the JAX walk over its first `length` frames, with an
    olabel table of arc id + 1 (0: no arc) and, for the row table, arc ids
    rewritten to their source state's own row (so that its arc // a_max is
    src_of_row[arc // a_div])."""
    A = 3
    ts, ta, sf, scf, ff, lengths, src, final_w = walk_case(K, K=K, A=A, rows=rows)
    arcs, best = twin(ts, ta, sf, scf, ff, lengths, A, src)
    T, U, _ = ts.shape
    S = len(final_w)
    via = ta if src is None else np.where(ta >= 0, src[np.maximum(ta, 0) // A] * A + ta % A, -1)
    olabel = (np.arange(S * A).reshape(S, A) + 1).astype(np.int32)
    mapped = np.where(arcs >= 0, (arcs if src is None else
                                  src[np.maximum(arcs, 0) // A] * A + arcs % A) + 1, 0)
    walked = 0
    for u in range(U):
        L = min(int(lengths[u]), T)
        ol, score = _traceback_impl(ts[:L, u], via[:L, u], sf[u], scf[u], final_w, olabel,
                                    a_max=A)
        assert np.array_equal(mapped[u, :L], np.asarray(ol)), u
        assert (arcs[u, L:] == -1).all()
        assert np.float32(score).view(np.int32) == best[u].view(np.int32), u
        walked += int((arcs[u] >= 0).sum())
    assert walked > T                     # the planted paths are followed
    assert best[0] == scf[0].max()        # no final token: the best score alone


# ------------------------------------------- traceback.cu's algorithm, in NumPy

def _take_better(v, k, v2, k2):
    take = (v2 > v) | ((v2 == v) & (k2 < k))
    return np.where(take, v2, v), np.where(take, k2, k)


def _warp_argmax(vals, K):
    """traceback.cu's lane loop (slot lane + 32 j, ascending) and xor
    butterfly: every lane's (largest value, its smallest slot)."""
    v = np.full(32, -np.inf, np.float32)
    k = np.full(32, 2**31 - 1, np.int64)
    for lane in range(32):
        for s in range(lane, K, 32):
            v[lane:lane + 1], k[lane:lane + 1] = _take_better(v[lane:lane + 1], k[lane:lane + 1],
                                                              vals[s:s + 1], np.array([s]))
    for o in (16, 8, 4, 2, 1):
        v, k = _take_better(v, k, v[np.arange(32) ^ o], k[np.arange(32) ^ o])
    assert (v == v[0]).all() and (k == k[0]).all()
    return v[0], int(k[0])


def kernel_walk(ts, ta, sf, scf, ff, lengths, a_div, rows, W, D, seed=0):
    """traceback.cu's kernel, block by block and warp by warp: each warp's
    ring starts full of stale words, issue(i, slot) copies step i's frame
    (L - 1 - i) into its slot, D - 1 steps ahead of the read, the slots
    counted round the ring (`fill` ahead of `s`), and the search
    takes the lowest set bit of the first nonzero ballot of 4 groups of 32
    slots a pass.  The outputs start as garbage: every word is written."""
    T, U, K = ts.shape
    Kp = (K + 3) & ~3
    rng = np.random.default_rng(seed)
    arcs = rng.integers(-9, 9, (U, T)).astype(np.int32)
    best = np.full(U, np.nan, np.float32)
    for b in range(-(-U // W)):
        for w in range(W):
            u = b * W + w
            if u >= U:
                continue
            ring = rng.integers(-3, 30, (D, 2, Kp)).astype(np.int32)
            L = min(max(int(lengths[u]), 0), T)

            def issue(i, slot):
                if i < L:
                    ring[slot, 0, :K], ring[slot, 1, :K] = ts[L - 1 - i, u], ta[L - 1 - i, u]

            for i in range(D - 1):
                issue(i, i)
            vt, kt = _warp_argmax(scf[u] + ff[u], K)
            vs, ks = _warp_argmax(scf[u], K)
            dead = not vt > HALF_NEG
            state = int(sf[u, ks if dead else kt])
            best[u] = vs if dead else vt
            arcs[u, L:] = -1
            lane = np.arange(32)
            s, fill = 0, D - 1
            for i in range(L):
                issue(i + D - 1, fill)
                fill = 0 if fill + 1 == D else fill + 1
                rs = ring[s]
                slot = 0
                for j in range(0, K, 32 * 4):
                    hit = -1
                    for g in range(3, -1, -1):
                        k = j + 32 * g + lane
                        m = (k < K) & (rs[0, np.minimum(k, Kp - 1)] == state)
                        if m.any():
                            hit = j + 32 * g + int(np.flatnonzero(m)[0])
                    if hit >= 0:
                        slot = hit
                        break
                arc = int(rs[1, slot])
                arcs[u, L - 1 - i] = arc if arc >= 0 else -1
                if arc >= 0:
                    state = arc // a_div if rows is None else int(rows[arc // a_div])
                s = 0 if s + 1 == D else s + 1
    return arcs, best


@pytest.mark.parametrize("K,W,D", [(5, 1, 1), (37, 3, 2), (64, 8, 3), (300, 2, 8)])
@pytest.mark.parametrize("rows", [False, True], ids=["divisor", "row_table"])
def test_kernel_algorithm_matches_the_twin(rows, K, W, D):
    """K = 300 takes three search passes; D = 1 refills the slot it reads;
    W = 3 and 8 leave warps of the last block without an utterance."""
    A = 4
    case = walk_case(100 + K, U=7, T=45, K=K, S=29, A=A, rows=rows)
    ts, ta, sf, scf, ff, lengths, src, _ = case
    want_arcs, want_best = twin(ts, ta, sf, scf, ff, lengths, A, src)
    got_arcs, got_best = kernel_walk(ts, ta, sf, scf, ff, lengths, A, src, W, D)
    assert np.array_equal(got_arcs, want_arcs)
    assert np.array_equal(got_best.view(np.int32), want_best.view(np.int32))
    assert (want_arcs >= 0).sum() > 45


def test_wrapper_runs_the_twin_on_cpu_tensors_and_checks_its_inputs():
    ts, ta, sf, scf, ff, lengths, src, _ = walk_case(3, rows=True)
    t = torch.as_tensor
    before = dict(ctb.launches)
    arcs, best = ctb.traceback(t(ts), t(ta), t(sf), t(scf), t(ff), t(lengths), 3, t(src))
    want = twin(ts, ta, sf, scf, ff, lengths, 3, src)
    assert arcs.dtype == torch.int32 and best.dtype == torch.float32
    assert np.array_equal(arcs.numpy(), want[0]) and np.array_equal(best.numpy(), want[1])
    assert ctb.launches == before                # CPU tensors launch nothing
    with pytest.raises(ValueError):
        ctb.traceback(t(ts), t(ta), t(sf), t(scf), t(ff), t(lengths), 0)
    with pytest.raises(ValueError):
        ctb.traceback(t(ts[:, :0]), t(ta[:, :0]), t(sf[:0]), t(scf[:0]), t(ff[:0]),
                      t(lengths[:0]), 3)


def test_decoders_copy_only_the_words_and_scores_to_the_host(monkeypatch):
    """decode_batch's traceback hands the (T, U, K) tables to the wrapper
    where they are and copies only its (U, T) olabels and (U,) scores."""
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk

    rng = np.random.default_rng(5)
    S, A, P, U, T = 20, 3, 6, 4, 12
    t = torch.as_tensor
    tg = tk.TokenGraph(t(rng.integers(0, P, (S, A)), dtype=torch.int32),
                       t(rng.integers(0, 5, (S, A)), dtype=torch.int32),
                       t(-rng.random((S, A)), dtype=torch.float32),
                       t(rng.integers(0, S, (S, A)), dtype=torch.int32), 0,
                       t(np.where(rng.random(S) < 0.3, 0.0, NEG), dtype=torch.float32), S, A)
    ll = t(rng.standard_normal((U, T, P)), dtype=torch.float32)
    copied = []
    cpu = torch.Tensor.cpu

    def spy(self, *a, **k):
        copied.append(tuple(self.shape))
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    olabs, scores = tk.decode_batch(tg, ll, [T, 5, 9, 1], kcap=8, beam=10.0)
    assert copied == [(U, T), (U,)]
    assert olabs.shape == (U, T) and scores.shape == (U,)
    assert (olabs[1, 5:] == 0).all() and (olabs[3, 1:] == 0).all()
