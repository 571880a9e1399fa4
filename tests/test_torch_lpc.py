"""Port parity: LPC, warped autocorrelation, Levinson-Durbin, the LPC and
MVDR envelopes and warped-MVDR cepstra of `dsr_tpu_torch.ops.lpc` against
`dsr_tpu.ops.lpc`, on frames made with numpy from a seed.

Tolerances, each from float32 arithmetic in another order than the JAX
package's: rtol 1e-4 for the autocorrelations and Levinson (an FFT; the
warped one a matmul per allpass stage where JAX runs a recurrence over
the samples: measured 3e-5 at order 30), atol 1e-7 beside it for the
smallest lags; 1e-4 of the largest magnitude for the envelopes (Levinson's input frames carry
more noise than tests/test_features.py's: at its 0.05 the order-12
autocorrelation is near singular and float32 Levinson's smallest
coefficients move by 1e-3 relative between two summation orders, which
that file allows JAX against golden); 5e-3 of
the largest magnitude for the cepstra, the bound tests/test_features.py
gives the JAX package against golden (Levinson in float32 amplifies
rounding).
"""

import numpy as np
import pytest
import torch

from _torch_parity import rel
from dsr_tpu.ops import lpc as jlpc
from dsr_tpu_torch.ops import lpc

SR = 16000.0


def speechish(S, seed, noise=0.05):
    """Three partials and a little noise, as tests/test_features.py makes them."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) / SR
    x = (0.6 * np.sin(2 * np.pi * 180 * t) + 0.3 * np.sin(2 * np.pi * 700 * t + 1.0)
         + 0.2 * np.sin(2 * np.pi * 2400 * t + 2.0) + noise * rng.standard_normal(S))
    return x.astype(np.float32)


def frames(seeds, noise=0.05):
    return np.stack([speechish(400, s, noise) for s in seeds])


def test_autocorr_and_levinson_match_jax():
    x = frames(range(4), noise=0.2)
    r_ref = np.array(jlpc.autocorr(x, 12))
    r = lpc.autocorr(torch.as_tensor(x), 12)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-4, atol=1e-7)
    a_ref, err_ref = (np.asarray(v) for v in jlpc.levinson(r_ref))
    a, err = lpc.levinson(torch.as_tensor(r_ref))
    np.testing.assert_allclose(a.numpy(), a_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(err.numpy(), err_ref, rtol=1e-4)


@pytest.mark.parametrize("order", [8, 30])
def test_warped_autocorr_matches_the_jax_scan(order):
    x = frames(range(10, 13)).reshape(3, 1, 400)
    r_ref = np.asarray(jlpc.warped_autocorr(x, order, 0.4595))
    r = lpc.warped_autocorr(torch.as_tensor(x), order, 0.4595)
    assert r.shape == (3, 1, order + 1)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-4, atol=1e-7)


def test_lpc_and_mvdr_envelopes_match_jax():
    r = np.asarray(jlpc.autocorr(frames(range(20, 24), noise=0.2), 12))
    a, err = (np.array(v) for v in jlpc.levinson(r))
    for name in ("lpc_envelope", "mvdr_envelope"):
        ref = np.asarray(getattr(jlpc, name)(a, err, 65))
        got = getattr(lpc, name)(torch.as_tensor(a), torch.as_tensor(err), 65)
        assert rel(got.numpy(), ref) < 1e-4, name
    # the MVDR envelope lies below the LPC one (the classical property)
    assert bool((lpc.mvdr_envelope(torch.as_tensor(a), torch.as_tensor(err), 65)
                 <= lpc.lpc_envelope(torch.as_tensor(a), torch.as_tensor(err), 65) * 1.001).all())


def test_warped_mvdr_cepstra_match_jax():
    x = frames(range(30, 40)).reshape(2, 5, 400)
    ref = np.asarray(jlpc.warped_mvdr_cepstra(x, order=16))
    c = lpc.warped_mvdr_cepstra(torch.as_tensor(x), order=16)
    assert c.shape == (2, 5, 13)
    assert rel(c.numpy(), ref) < 5e-3
