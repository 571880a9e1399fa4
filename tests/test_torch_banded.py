"""Port parity: the banded Viterbi kernel's plain twin
(`dsr_tpu_torch/ops/cuda/viterbi.py`, `banded_viterbi_plain`, which the
wrapper runs on CPU tensors) against the JAX package's Pallas kernel
(`dsr_tpu/ops/pallas/viterbi.py`, interpret mode, as tests/test_pallas.py
runs it) and against the dense `viterbi` on the same chain.  The CUDA
kernel itself is held to the twin bit for bit on the card by chip_smoke.py.

Tolerance: the backpointer planes and delta equal bit for bit, and the
paths equal: the twin makes the kernel's float32 additions in the Pallas
kernel's order.  The score from the dense recursion within 1e-5 relative
(its sums run in the same order too; ties, none here, could differ).
"""

import numpy as np
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
