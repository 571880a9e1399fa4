"""Port parity: the post-filters of `dsr_tpu_torch.ops.postfilter` and WPE
dereverberation (`dsr_tpu_torch.ops.dereverb.wpe`) against the JAX
package, on numpy-seeded subbands (the data of tests/test_enhancement.py:
a coherent source plus noise, and AR-smeared "reverberant" subbands).

Tolerances, relative to the largest magnitude of the reference: 1e-5 for
the gains (float32 smoothing recursions and pair sums in another rounding
order; the smoothing coefficient 1 - α is rounded once in float64 here
and in float32 there, one ulp apart); 1e-4 for WPE on well-conditioned
data (its batched 64 x 64 normal-equation solves at N = 8, taps = 8
amplify rounding by their condition number), and on ill-conditioned data
see the test.
"""

import numpy as np
import torch

from _torch_parity import SR, rel
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import dereverb as jder
from dsr_tpu.ops import postfilter as jpf
from dsr_tpu_torch.ops import dereverb as der
from dsr_tpu_torch.ops import postfilter as pf
from golden import dereverb as gder

M = 64


def _coherent(seed, N=4, T=50, K=M // 2 + 1):
    """A source common to all channels plus independent noise."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))
    n = 0.5 * (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K)))
    return (s[None] + n).astype(np.complex64)


def test_zelinski_and_mccowan_match_jax():
    X = _coherent(0)
    POS = np.asarray(JGeometry.linear(4, 0.05).positions)
    G = np.array(jbf.diffuse_coherence(POS, M, SR, 343.0))
    Xt, Gt = torch.as_tensor(X), torch.as_tensor(G)
    H = pf.zelinski_weights(Xt)
    assert H.dtype == torch.float32 and H.shape == X.shape[1:]
    assert rel(H.numpy(), np.asarray(jpf.zelinski_weights(X))) < 1e-5
    assert rel(pf.mccowan_weights(Xt, Gt).numpy(), np.asarray(jpf.mccowan_weights(X, G))) < 1e-5
    assert rel(pf.smooth(Xt[0].abs(), 0.7).numpy(), np.asarray(jpf.smooth(np.abs(X[0]), 0.7))) < 1e-5
    Y = Xt.mean(dim=0)
    assert rel(pf.apply_postfilter(Y, H).numpy(),
               np.asarray(jpf.apply_postfilter(Y.numpy(), H.numpy()))) < 1e-6


def test_lefkimmiatis_apab_and_mask_match_jax():
    X = _coherent(1)
    POS = np.asarray(JGeometry.circular(4, 0.05).positions)
    G = np.array(jbf.diffuse_coherence(POS, M, SR, 343.0))
    w = (np.exp(2j * np.pi * np.random.default_rng(2).random((M // 2 + 1, 4))) / 4
         ).astype(np.complex64)
    H = pf.lefkimmiatis_weights(torch.as_tensor(X), torch.as_tensor(G), torch.as_tensor(w))
    assert rel(H.numpy(), np.asarray(jpf.lefkimmiatis_weights(X, G, w))) < 1e-5
    Y, Z = X[0], X[1] - X[2]
    assert rel(pf.apab_weights(torch.as_tensor(Y), torch.as_tensor(Z)).numpy(),
               np.asarray(jpf.apab_weights(Y, Z))) < 1e-5
    assert np.array_equal(pf.binary_mask(torch.as_tensor(Y), torch.as_tensor(Z)).numpy(),
                          np.asarray(jpf.binary_mask(Y, Z)))


def test_wpe_matches_jax():
    """On tests/test_enhancement.py's data the normal equations are
    ill-conditioned (the gated source leaves frames of tiny power, whose
    inverse weights dominate), and float32 results scatter by ~1e-2 around
    the float64 one in both packages, with rounding alone deciding where:
    there the port runs in complex128 and is held to the float64 reference
    (`golden.dereverb.wpe`), and in complex64 must still dereverberate.  On
    a longer, denser recording its complex64 WPE follows the JAX package's."""
    rng = np.random.default_rng(7)
    N, T, K = 2, 60, 9
    dry = (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))) * (
        rng.random((1, T, 1)) > 0.5)
    Y = dry.copy()
    for t in range(3, T):
        Y[:, t] += 0.54 * Y[:, t - 3]
    kw = dict(taps=4, delay=2, iters=2)
    assert rel(der.wpe(torch.as_tensor(Y), **kw).numpy(), gder.wpe(Y, **kw)) < 1e-9
    D = der.wpe(torch.as_tensor(Y.astype(np.complex64)), **kw)
    assert D.dtype == torch.complex64 and D.shape == Y.shape
    assert np.mean(np.abs(D.numpy() - dry) ** 2) < 0.5 * np.mean(np.abs(Y - dry) ** 2)

    N, T, K = 8, 500, 17
    Y = rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))
    for t in range(3, T):
        Y[:, t] += 0.54 * Y[:, t - 3]
    Y = Y.astype(np.complex64)
    assert rel(der.wpe(torch.as_tensor(Y)).numpy(), np.asarray(jder.wpe(Y))) < 1e-4
