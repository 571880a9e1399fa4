"""Port parity: the IEKF speaker tracker of `dsr_tpu_torch.ops.tracking`
(covariance and square-root forms) and the TDOA localisers of
`dsr_tpu_torch.ops.tde` against the JAX package, on the config-3 recipe of
tests/test_tracked_gsc_wer.py at a small size: an 8-mic 0.10 m circular
array, a seeded source in free field, per-pair median GCC-PHAT TDOAs over
three 0.5 s blocks, the tracker started 0.7 m off the source (prior
+[0.5, -0.4, 0.2] m) and run 40 epochs over the medians.

Tolerances: positions within 1e-4 m (float32 solves of systems that are
ill-conditioned along the range, which a 0.2 m aperture barely resolves;
the two packages agree to ~1e-5 m); steering delays within 1e-9 s
(1/60 of a sample at 16 kHz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SR
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.ops import tde as jtde
from dsr_tpu.ops import tracking as jtrack
from dsr_tpu_torch.ops import tde
from dsr_tpu_torch.ops import tracking as track
from golden import room as groom

SOURCE = np.array([0.6, 1.5, 0.3])
PRIOR = (SOURCE + np.array([0.5, -0.4, 0.2])).astype(np.float32)
P0 = np.eye(3, dtype=np.float32) * 0.09


@pytest.fixture(scope="module")
def case():
    POS = np.asarray(JGeometry.circular(8, 0.10).positions).astype(np.float32)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)]
    PI, PJ = (np.asarray([p[k] for p in pairs]) for k in (0, 1))
    rng = np.random.default_rng(0)
    x = groom.simulate(rng.standard_normal(16000), POS, SOURCE, SR, snr_db=20.0,
                       rng=rng).astype(np.float32)
    td = np.stack([np.asarray(jtde.gcc_phat_pairs(x[:, b * 4000:b * 4000 + 8000], pairs, SR,
                                                  max_tau=0.21 / 343.0, interp=16))
                   for b in range(3)])
    seq = np.tile(np.median(td, axis=0), (40, 1)).astype(np.float32)
    jax_args = (jnp.asarray(POS), jnp.asarray(PI), jnp.asarray(PJ))
    port_args = (torch.as_tensor(POS), torch.as_tensor(PI), torch.as_tensor(PJ))
    return seq, jax_args, port_args


def test_track_matches_jax(case):
    seq, jargs, args = case
    for q, r in ((1e-6, 1e-8), (1e-4, 1e-9)):
        ref = np.asarray(jtrack.track(jnp.asarray(seq), jnp.asarray(PRIOR), jnp.asarray(P0),
                                      *jargs, q=q, r=r))
        est = track.track(torch.as_tensor(seq), torch.as_tensor(PRIOR), torch.as_tensor(P0),
                          *args, q=q, r=r)
        assert est.shape == (40, 3) and est.dtype == torch.float32
        assert np.max(np.abs(est.numpy() - ref)) < 1e-4
    # the tracker found the source: within 0.2 m (the aperture resolves
    # bearing far better than range)
    assert np.linalg.norm(est[-1].numpy() - SOURCE) < 0.2


def test_track_sqrt_matches_jax(case):
    seq, jargs, args = case
    S0 = np.linalg.cholesky(P0).astype(np.float32)
    ref = np.asarray(jtrack.track_sqrt(jnp.asarray(seq), jnp.asarray(PRIOR), jnp.asarray(S0),
                                       *jargs, q=1e-6, r=1e-8))
    est = track.track_sqrt(torch.as_tensor(seq), torch.as_tensor(PRIOR), torch.as_tensor(S0),
                           *args, q=1e-6, r=1e-8)
    assert np.max(np.abs(est.numpy() - ref)) < 1e-4
    # the square-root filter tracks the same path as the covariance form
    cov = track.track(torch.as_tensor(seq), torch.as_tensor(PRIOR), torch.as_tensor(P0),
                      *args, q=1e-6, r=1e-8)
    assert np.max(np.abs(est.numpy() - cov.numpy())) < 1e-3


def test_localisers_and_steering_delays_match_jax(case):
    seq, jargs, args = case
    tdoas = seq[0]
    ref = np.asarray(jtde.ls_position(jnp.asarray(tdoas), *jargs, jnp.asarray(PRIOR)))
    pos = tde.ls_position(torch.as_tensor(tdoas), *args, torch.as_tensor(PRIOR))
    assert np.max(np.abs(pos.numpy() - ref)) < 1e-4
    t0 = tdoas[:7]           # pairs (0, 1) .. (0, 7): TDOAs relative to mic 0
    ref = np.asarray(jtde.sx_position(jnp.asarray(t0), jargs[0]))
    assert np.max(np.abs(tde.sx_position(torch.as_tensor(t0), args[0]).numpy() - ref)) < 1e-4
    ref = np.asarray(jtrack.steering_delays_from_position(jnp.asarray(PRIOR), jargs[0]))
    taus = track.steering_delays_from_position(torch.as_tensor(PRIOR), args[0])
    assert np.max(np.abs(taus.numpy() - ref)) < 1e-9
