"""Port parity: time-delay estimation of `dsr_tpu_torch.ops.tde` against
`dsr_tpu.ops.tde`: GCC-PHAT over all 28 pairs of an 8-mic array (waveform
and subband forms) and SRP-PHAT over a grid, on a seeded source simulated
in free field with `golden.room` (as tests/test_tracking.py does).

Tolerances: TDOAs within 1e-3 of a sample (the peak index is the same; the
parabolic interpolation sees float32 correlations that differ in the
last bits of their FFTs); the SRP-PHAT power within 1e-5 of its largest
magnitude (a float32 product in another order) and the same grid point.
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import SR, rel
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops import tde as jtde
from dsr_tpu_torch.ops import tde
from golden import room as groom

POS = np.asarray(JGeometry.circular(8, 0.15).positions)
PAIRS = [(i, j) for i in range(8) for j in range(i + 1, 8)]
PI = np.asarray([p[0] for p in PAIRS])
PJ = np.asarray([p[1] for p in PAIRS])


def _sim(src_pos, seed, S=8192):
    rng = np.random.default_rng(seed)
    return groom.simulate(rng.standard_normal(S), POS, np.asarray(src_pos), SR, snr_db=20.0,
                          rng=rng).astype(np.float32)


def test_gcc_phat_pairs_matches_jax():
    x = _sim([1.2, 1.7, 0.1], 0)
    for interp, max_tau in ((4, 0.005), (16, 0.31 / 343.0)):
        ref = np.asarray(jtde.gcc_phat_pairs(x, PAIRS, SR, max_tau=max_tau, interp=interp))
        tau = tde.gcc_phat_pairs(torch.as_tensor(x), PAIRS, SR, max_tau=max_tau, interp=interp)
        assert tau.shape == (28,) and tau.dtype == torch.float32
        assert np.max(np.abs(tau.numpy() - ref)) < 1e-3 / SR


def test_gcc_phat_subband_pairs_matches_jax():
    x = _sim([-0.8, 1.1, 0.0], 1)
    A = np.array(jfb.analysis(x, JFilterbankConfig(M=64, m=2, r=2)))
    ref = np.asarray(jtde.gcc_phat_subband_pairs(jnp.asarray(A), jnp.asarray(PI),
                                                 jnp.asarray(PJ), M=64, interp=8))
    lags = tde.gcc_phat_subband_pairs(torch.as_tensor(A), PI, PJ, M=64, interp=8)
    assert lags.shape == (28,)
    assert np.max(np.abs(lags.numpy() - ref)) < 1e-3 * 8   # lags in 1/8-sample units


def test_srp_phat_matches_jax():
    x = _sim([0.8, 1.4, 0.0], 2)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 13), np.linspace(0.5, 2.5, 9))
    grid = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    best_ref, pow_ref = (np.asarray(a) for a in jtde.srp_phat(x, POS, grid, SR))
    best, power = tde.srp_phat(torch.as_tensor(x), POS, grid, SR)
    assert power.shape == (grid.shape[0],)
    assert rel(power.numpy(), pow_ref) < 1e-5
    assert np.allclose(best.numpy(), best_ref)
