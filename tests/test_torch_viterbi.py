"""Port parity: the dense Viterbi family (`dsr_tpu_torch/asr/decoder/
viterbi.py`: `viterbi`, `viterbi_batch`, `forward_backward`) against the
JAX package's, on random (T, S) = (50, 12) problems made with numpy.

Tolerance: paths equal (ties go to the lowest index in both); scores
within 1e-4 relative (the same float32 sums; only logsumexp's internals
differ between the libraries); forward-backward gamma within 1e-4 and the
total within 1e-3 relative (log-domain sums in float32 over 50 frames).
"""

import numpy as np
import torch

from dsr_tpu.asr.decoder import viterbi as jvit
from dsr_tpu_torch.asr.decoder import viterbi as vit


def _problem(seed, T=50, S=12):
    rng = np.random.default_rng(seed)
    ll = rng.standard_normal((T, S)).astype(np.float32)
    A = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    init = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    final = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    return ll, A, init, final


def test_viterbi_matches_jax():
    for seed in (1, 2):
        ll, A, init, final = _problem(seed)
        p_j, s_j = jvit.viterbi(ll, A, init, final)
        p, s = vit.viterbi(torch.as_tensor(ll), A, init, final)
        assert np.array_equal(p.numpy(), np.asarray(p_j))
        assert abs(float(s) - float(s_j)) <= 1e-4 * abs(float(s_j))


def test_viterbi_batch_with_ragged_lengths_matches_jax():
    """Frames at or past each length freeze; the path repeats its last state."""
    ll, A, init, final = _problem(3)
    llb = np.stack([ll, _problem(4)[0], _problem(5)[0]])
    lens = np.array([50, 31, 7])
    p_j, s_j = jvit.viterbi_batch(llb, A, init, final, lens)
    p, s = vit.viterbi_batch(torch.as_tensor(llb), A, init, final, lens)
    assert np.array_equal(p.numpy(), np.asarray(p_j))
    assert np.all(np.abs(s.numpy() - np.asarray(s_j)) <= 1e-4 * np.abs(np.asarray(s_j)))
    assert np.all(p.numpy()[1, 30:] == p.numpy()[1, 30])


def test_forward_backward_matches_jax():
    ll, A, init, final = _problem(6, T=30, S=8)
    for length in (None, 19):
        g_j, t_j = jvit.forward_backward(ll, A, init, final, length)
        g, t = vit.forward_backward(torch.as_tensor(ll), A, init, final, length)
        assert np.max(np.abs(g.numpy() - np.asarray(g_j))) < 1e-4
        assert abs(float(t) - float(t_j)) <= 1e-3 * abs(float(t_j))
        if length is not None:
            assert np.all(g.numpy()[length:] == 0.0)
