"""Port parity: `dsr_tpu_torch.ops.beamforming.ds_beamform` (on CPU tensors,
the plain twin of the steering kernel, `ops/cuda/steering.py`) against the
JAX package's fused steering + DS Pallas kernel (`ops/pallas/steering.py`,
interpret mode) and its composed XLA `ds_beamform`, for static delays and
for a per-frame trajectory, on the inputs of tests/test_pallas.py's
steering gates.

Tolerances, relative to the largest magnitude of the reference: 1e-4
against the Pallas kernel (the JAX package's own gate,
tests/test_pallas.py); 1e-5 against the composed XLA version (the same
float32 phases, cos/sin and sums, in another rounding order).
"""

import numpy as np
import pytest
import torch

from _torch_parity import SR, rel, subbands
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops.pallas import steering as psteer
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops.cuda import steering as csteer
from golden import room as groom

M = 64


def _delays(pos, n):
    POS = np.asarray(JGeometry.linear(n, 0.05).positions)
    return (groom.steering_delays(POS, np.asarray(pos), 343.0, SR) / SR).astype(np.float32)


def test_ds_beamform_static_delays_match_pallas_kernel():
    X = subbands(np.random.default_rng(3), 6, 30, M // 2 + 1)
    taus = _delays([0.5, 1.5, 0.0], 6)
    csteer.reset_launches()
    Y = bf.ds_beamform(torch.as_tensor(X), torch.as_tensor(taus), M, SR)
    assert Y.dtype == torch.complex64 and Y.shape == (30, M // 2 + 1)
    assert rel(Y.numpy(), np.asarray(psteer.ds_beamform(X, taus, M, SR))) < 1e-4
    assert rel(Y.numpy(), np.asarray(jbf.ds_beamform(X, taus, M, SR))) < 1e-5
    assert csteer.launches["steering"] == 0   # CPU tensors run the plain twin


def test_ds_beamform_trajectory_matches_pallas_kernel():
    """A moving source: frame t's delays differ, and frame t's output equals
    the static beamformer's at those delays."""
    X = subbands(np.random.default_rng(4), 4, 20, M // 2 + 1)
    taus_t = np.stack([_delays([0.5 + 0.01 * t, 1.5, 0.0], 4) for t in range(20)])
    Y = bf.ds_beamform(torch.as_tensor(X), torch.as_tensor(taus_t), M, SR)
    assert rel(Y.numpy(), np.asarray(psteer.ds_beamform(X, taus_t, M, SR))) < 1e-4
    assert rel(Y.numpy(), np.asarray(jbf.ds_beamform(X, taus_t, M, SR))) < 1e-5
    for t in (0, 10, 19):
        y_t = bf.ds_beamform(torch.as_tensor(X[:, t:t + 1]), torch.as_tensor(taus_t[t]), M, SR)
        assert rel(Y[t].numpy(), y_t[0].numpy()) < 1e-5


def test_ds_beamform_twin_is_the_composed_beamformer():
    """The twin equals `apply_weights(X, ds_weights(steering_vectors(τ)))`
    of the port itself, and the wrapper refuses delays of the wrong shape."""
    X = torch.as_tensor(subbands(np.random.default_rng(5), 4, 12, M // 2 + 1))
    taus = torch.as_tensor(_delays([1.0, 1.0, 0.5], 4))
    v = bf.steering_vectors(taus, M, SR)
    assert torch.equal(csteer.ds_beamform_plain(X, taus, M, SR),
                       bf.apply_weights(X, bf.ds_weights(v)))
    with pytest.raises(ValueError, match="delays must be"):
        csteer.ds_beamform(X, taus[:3], M, SR)
    with pytest.raises(ValueError, match="delays must be"):
        csteer.ds_beamform(X, taus.expand(5, 4), M, SR)
