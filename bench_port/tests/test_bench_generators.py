"""The traffic generators make the same inputs from the same seed, and
every seed the same sizes."""

import numpy as np
import pytest
import torch

from conftest import load


def decode_pool(seed, **kw):
    from bench_port.generators import utterance_batches as ub

    p = load("traffic/batch1024.json")
    p.update(utterances_per_batch=5, pool_batches=2, **kw)
    task = {"vocab_size": 50, "seed": 0, "branching": 3, "states_per_phone": 3}
    return ub.make_pool(task, p, seed, 120, "cpu")


def test_utterance_batches_same_seed_same_inputs():
    a, b = decode_pool(2**31 + 11), decode_pool(2**31 + 11)
    for x, y in zip(a, b):
        assert torch.equal(x.feats, y.feats)
        assert [u.words for u in x.utts] == [u.words for u in y.utts]


def test_utterance_batches_seed_changes_words_not_sizes():
    a, b = decode_pool(1), decode_pool(2)
    for x, y in zip(a, b):
        assert sorted(x.lengths) == sorted(y.lengths)
        assert x.feats.shape == y.feats.shape
        assert [u.words for u in x.utts] != [u.words for u in y.utts]


def test_utterance_batches_render_the_words():
    """Each frame's largest feature is its pdf (scale 4 over noise 0.5
    almost always), the pdfs follow the sentence's phones, and each state
    lasts 2 to 4 frames."""
    from bench_port.generators import utterance_batches as ub

    batch = decode_pool(7)[0]
    prons, _ = ub.lexicon(50, 0, 3)
    for i, u in enumerate(batch.utts):
        top = batch.feats[i, :u.frames].argmax(-1).numpy()
        runs = np.split(top, np.flatnonzero(np.diff(top)) + 1)
        phones = [r[0] // 3 for r in runs if r[0] % 3 == 0]
        assert np.mean([2 <= len(r) <= 4 for r in runs]) > 0.9
        words = np.concatenate([prons[w] for w in u.words])
        assert set(words) <= set(phones) | {ub.SIL}


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_array_blocks_same_seed_same_inputs(seed):
    from bench_port.generators import array_blocks as ab

    cfg = load("configs/mvdr64_m256.json")
    cfg["array"]["channels"] = 4
    p = load("traffic/block8s.json")
    p.update(block_s=0.1, pool_blocks=2)
    (x1, p1), (x2, p2) = ab.make_pool(cfg, p, seed, "cpu"), ab.make_pool(cfg, p, seed, "cpu")
    assert torch.equal(x1, x2) and np.array_equal(p1, p2)
    x3, p3 = ab.make_pool(cfg, p, seed + 1, "cpu")
    assert x3.shape == x1.shape and not torch.equal(x3, x1)
    d = np.linalg.norm(p1, axis=1)
    assert np.all((d >= 1.0 - 1e-9) & (d <= 3.0 + 1e-9))


def test_array_blocks_delay_the_talker():
    """Each microphone's channel is the talker delayed by its point-source
    delay: cross-correlation peaks at the rounded delay."""
    from bench_port.generators import array_blocks as ab

    cfg = load("configs/mvdr64_m256.json")
    cfg["array"].update(channels=4, radius_m=0.5)
    p = load("traffic/block8s.json")
    p.update(block_s=0.5, pool_blocks=1, snr_db=60.0)
    x, pos = ab.make_pool(cfg, p, 5, "cpu")
    tau = ab.delays_s(ab.array_positions(cfg["array"]), pos, 343.0)[0] * 16000
    X = torch.fft.rfft(x[0].double())
    for n in range(1, 4):
        xc = torch.fft.irfft(X[n] * X[0].conj(), n=x.shape[-1])
        lag = int(xc.argmax())
        lag = lag - x.shape[-1] if lag > x.shape[-1] // 2 else lag
        assert abs(lag - (tau[n] - tau[0])) <= 1.0
