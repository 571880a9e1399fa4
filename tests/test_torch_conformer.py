"""The port's Conformer-CTC (`dsr_tpu_torch.models.conformer`) against the
JAX package's on the CPU, with flax's parameters carried across by
`convert.conformer_ctc` (relative-position tables, LayerNorm scales and
biases drawn at random so that each matters).  Inputs are made with numpy
from seeds; vocab 7, dim 32, 2 layers, 2 heads.

Tolerances:
- logits: 1e-4 of the largest magnitude (float32 matmuls and softmax in
  another order; flax's LayerNorm takes E[x²] − E[x]², torch two passes);
- CTC loss: 1e-5 relative; gradients: 1e-3 of each leaf's largest
  magnitude, 1e-6 absolute for the k bias (`_torch_parity.grads_match`);
- decodes: identical ids, scores within 1e-4 (the same float32
  recurrence; exp and log differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import grads_match, randomized, rel
from dsr_tpu.models import conformer as jc
from dsr_tpu_torch import convert
from dsr_tpu_torch.models import conformer as pc

VOCAB, DIM, LAYERS, HEADS = 7, 32, 2, 2


def _pair(T, seed=0):
    """(JAX model, its randomised params, the port's model loaded from them)."""
    jm = jc.ConformerCtc(vocab=VOCAB, dim=DIM, layers=LAYERS, heads=HEADS)
    params = randomized(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, T, 13))), seed + 1)
    pm = pc.ConformerCtc(VOCAB, DIM, LAYERS, HEADS, device="cpu")
    pm.load_state_dict(convert.conformer_ctc(params), strict=True)
    return jm, params, pm


def _batch(T, seed):
    """A padded batch of 3 with its key mask (lengths T, T − 9, T − 16)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((3, T, 13)).astype(np.float32)
    lens = np.array([T, T - 9, T - 16])
    mask = np.arange(T)[None, :] < lens[:, None]
    return X * mask[..., None], lens, mask


@pytest.mark.parametrize("T", [40, 41])
def test_logits_match_jax_on_a_masked_batch(T):
    """Both parities of T: XLA pads the stride-2 SAME convs (0, 1) on even
    and (1, 1) on odd lengths, on the time and the feature axes."""
    jm, params, pm = _pair(T)
    X, _, mask = _batch(T, 1)
    ref = np.asarray(jm.apply(params, X, mask))
    with torch.no_grad():
        out = pm(torch.as_tensor(X), torch.as_tensor(mask)).numpy()
    assert ref.shape == (3, (T + 3) // 4, VOCAB + 1)
    assert rel(out, ref) <= 1e-4


def test_ctc_loss_and_gradients_match_jax():
    T = 44
    jm, params, pm = _pair(T, seed=2)
    X, lens, mask = _batch(T, 3)
    llen = (lens + 3) // 4
    labels = np.array([[1, 3, 5], [2, 6, 0], [4, 0, 0]], np.int32)
    label_lens = np.array([3, 2, 1], np.int32)

    def loss_fn(p):
        return jc.ctc_loss(jm.apply(p, X, mask), jnp.asarray(llen), jnp.asarray(labels),
                           jnp.asarray(label_lens))

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    loss = pc.ctc_loss(pm(torch.as_tensor(X), torch.as_tensor(mask)), llen, labels, label_lens)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    grads_match(pm, convert.conformer_ctc(grads_j))


def _bigram(rng, V):
    """An add-one bigram over random label sequences, as tests/test_neural.py
    builds its corpus LM: (V+1, V+1) log-probabilities, row 0 the start."""
    counts = np.ones((V + 1, V + 1))
    for _ in range(20):
        prev = 0
        for w in rng.integers(1, V + 1, size=rng.integers(1, 4)):
            counts[prev, w] += 1
            prev = w
    return np.log(counts / counts.sum(axis=1, keepdims=True)).astype(np.float32)


def test_greedy_and_beam_decodes_match_jax():
    rng = np.random.default_rng(7)
    V = VOCAB
    lm = _bigram(rng, V)
    cases = [dict(), dict(lm_logprobs=lm), dict(lm_logprobs=lm, lm_weight=0.7, bonus=0.5),
             dict(bonus=-0.4, length=17), dict(lm_logprobs=lm, max_len=3),
             dict(length=9, max_len=2, bonus=1.0)]
    for trial in range(4):
        T = 24 + 3 * trial
        logits = (rng.standard_normal((T, V + 1)) * (1 + trial)).astype(np.float32)
        length = T - 5 * trial
        assert list(pc.greedy_ctc_decode(torch.as_tensor(logits), length)) == list(
            jc.greedy_ctc_decode(jnp.asarray(logits), length))
        for kw in cases:
            ids_j, sc_j = jc.beam_ctc_decode(logits, beam=8, **kw)
            ids, sc = pc.beam_ctc_decode(torch.as_tensor(logits), beam=8, **kw)
            assert ids.dtype == np.int32 and list(ids) == list(ids_j), (trial, kw)
            assert abs(sc - sc_j) <= 1e-4 * max(1.0, abs(sc_j)), (trial, kw, sc, sc_j)


def test_beam_decode_hand_cases_of_the_jax_tests():
    """tests/test_neural.py:98-118: prefix mass beats the greedy path, and
    shallow fusion flips an acoustically close decision; both have exact
    ties among the live beams."""
    lp = np.log(np.asarray([[0.4, 0.35, 0.25]] * 2, np.float32))
    assert list(pc.greedy_ctc_decode(torch.as_tensor(lp))) == []
    ids, sc = pc.beam_ctc_decode(torch.as_tensor(lp), beam=4)
    ids_j, sc_j = jc.beam_ctc_decode(lp, beam=4)
    assert list(ids) == list(ids_j) == [1] and abs(sc - sc_j) <= 1e-6

    V = 3
    lm = np.full((V + 1, V + 1), -5.0, np.float32)
    lm[0, 1] = -0.1
    lm[0, 2] = -4.0
    logits = np.log(np.asarray([[0.1, 0.42, 0.47, 0.01]] * 4, np.float32))
    for kw, want in ((dict(), [2]), (dict(lm_logprobs=lm, lm_weight=1.0), [1])):
        ids, sc = pc.beam_ctc_decode(torch.as_tensor(logits), beam=4, **kw)
        ids_j, sc_j = jc.beam_ctc_decode(logits, beam=4, **kw)
        assert list(ids) == list(ids_j) == want and abs(sc - sc_j) <= 1e-5 * abs(sc_j)
