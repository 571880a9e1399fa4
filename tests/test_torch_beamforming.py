"""Port parity: the fixed beamformers of `dsr_tpu_torch` against `dsr_tpu`,
with weights carried across by `dsr_tpu_torch.convert`.  Inputs are made
with numpy from a seed.

Tolerances, each relative to the largest magnitude of the reference:
  - 1e-5 for elementwise float32 math (steering phases, coherence, DS,
    apply), which differs only in rounding order;
  - 1e-4 for MVDR weights: Γ + 1e-2·I of a 0.10 m array is ill-conditioned
    at the low bins (condition number ~8e2 for 8 mics at DC, where Γ is all
    ones), so two LAPACK complex64 solves agree to ~cond·eps.
"""

import numpy as np
import torch

from _torch_parity import SR, M, geometry, rel, subbands
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu_torch import convert
from dsr_tpu_torch.ops import beamforming as bf


def test_steering_and_fixed_weights_match_jax():
    POS, taus = geometry()
    v_ref = np.asarray(jbf.steering_vectors(taus, M, SR))
    v = bf.steering_vectors(torch.as_tensor(taus), M, SR)
    assert v.dtype == torch.complex64
    assert rel(v.numpy(), v_ref) < 1e-5
    assert rel(bf.ds_weights(v).numpy(), np.asarray(jbf.ds_weights(v_ref))) < 1e-5
    assert rel(bf.subband_freqs(M, SR).numpy(), np.asarray(jbf.subband_freqs(M, SR))) < 1e-6
    G_ref = np.asarray(jbf.diffuse_coherence(POS, M, SR, 343.0))
    G = bf.diffuse_coherence(POS, M, SR, 343.0)
    assert G.dtype == torch.float32
    assert rel(G.numpy(), G_ref) < 1e-5


def test_mvdr_weights_match_jax():
    POS, taus = geometry()
    v_ref = jbf.steering_vectors(taus, M, SR)
    G_ref = jbf.diffuse_coherence(POS, M, SR, 343.0)
    w_ref = np.asarray(jbf.mvdr_weights(v_ref, G_ref, 1e-2))
    v = bf.steering_vectors(torch.as_tensor(taus), M, SR)
    G = bf.diffuse_coherence(POS, M, SR, 343.0)
    w = bf.mvdr_weights(v, G, 1e-2)
    assert w.dtype == torch.complex64
    assert rel(w.numpy(), w_ref) < 1e-4
    w_inv = bf.mvdr_weights_from_inv(v, bf.mvdr_precompute(G, 1e-2))
    w_inv_ref = np.asarray(jbf.mvdr_weights_from_inv(v_ref, jbf.mvdr_precompute(G_ref, 1e-2)))
    assert rel(w_inv.numpy(), w_inv_ref) < 1e-4
    # distortionless towards the source: wᴴv = 1 in every bin
    resp = torch.sum(w.conj() * v, dim=-1)
    assert torch.allclose(resp, torch.ones_like(resp), atol=1e-4)


def test_apply_weights_and_ds_beamform_match_jax():
    rng = np.random.default_rng(0)
    _, taus = geometry()
    X = subbands(rng)
    w = np.asarray(jbf.ds_weights(jbf.steering_vectors(taus, M, SR)))
    Y_ref = np.asarray(jbf.apply_weights(X, w))
    Y = bf.apply_weights(torch.as_tensor(X), convert.beamformer_weights(w))
    assert rel(Y.numpy(), Y_ref) < 1e-5
    assert rel(bf.ds_beamform(torch.as_tensor(X), torch.as_tensor(taus), M, SR).numpy(),
               np.asarray(jbf.ds_beamform(X, taus, M, SR))) < 1e-5
    taus_t = (taus[None, :] * np.linspace(0.5, 1.5, X.shape[1])[:, None]).astype(np.float32)
    assert rel(bf.ds_beamform(torch.as_tensor(X), torch.as_tensor(taus_t), M, SR).numpy(),
               np.asarray(jbf.ds_beamform(X, taus_t, M, SR))) < 1e-5
