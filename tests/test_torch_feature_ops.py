"""Port parity: regression deltas, `add_deltas`, splicing and spectral
subtraction of `dsr_tpu_torch.ops.features` against `dsr_tpu.ops.features`,
on features made with numpy from a seed.

Tolerance: 1e-6 of the largest magnitude of the JAX output (edge copies
and slices are exact; the deltas' weighted sums and the division by their
denominator round alike in float32).
"""

import itertools

import numpy as np
import torch

from dsr_tpu.ops import features as jft
from dsr_tpu_torch.ops import features as ft


def close(got: torch.Tensor, ref) -> bool:
    """max |got - ref| <= 1e-6 max |ref| (exact where ref is all zeros: the
    deltas of a single frame)."""
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got.numpy() - ref).max()) <= 1e-6 * float(np.abs(ref).max())


def test_deltas_and_add_deltas_match_jax():
    rng = np.random.default_rng(1)
    for window, shape in itertools.product((1, 2), ((2, 30, 13), (1, 1, 13), (1, 5), (2, 5),
                                                    (3, 4))):     # T <= window too
        f = rng.standard_normal(shape).astype(np.float32)
        assert close(ft.deltas(torch.as_tensor(f), window), jft.deltas(f, window))
        a = ft.add_deltas(torch.as_tensor(f), window)
        assert a.shape == (*shape[:-1], 3 * shape[-1])
        assert close(a, jft.add_deltas(f, window))


def test_splice_matches_jax():
    f = np.random.default_rng(3).standard_normal((2, 12, 5)).astype(np.float32)
    for left, right in ((3, 3), (0, 5)):
        s = ft.splice(torch.as_tensor(f), left, right)
        assert s.shape == (2, 12, 5 * (left + right + 1))
        assert np.array_equal(s.numpy(), np.asarray(jft.splice(f, left, right)))
    # one frame: every column is that frame
    one = torch.as_tensor(f[:, :1])
    assert torch.equal(ft.splice(one, 2, 1), one.repeat(1, 1, 4))


def test_spectral_subtraction_matches_jax():
    rng = np.random.default_rng(4)
    P = (rng.chisquare(2, (40, 17)) / 2).astype(np.float32)
    noise = (0.5 + rng.random(17)).astype(np.float32)
    for alpha, floor in ((1.0, 0.1), (2.0, 0.05)):
        got = ft.spectral_subtraction(torch.as_tensor(P), torch.as_tensor(noise), alpha, floor)
        assert close(got, jft.spectral_subtraction(P, noise, alpha, floor))
        assert bool((got >= floor * torch.as_tensor(P) - 1e-7).all())
