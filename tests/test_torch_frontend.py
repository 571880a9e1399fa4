"""Port parity: subband features and GMM scoring of `dsr_tpu_torch` against
`dsr_tpu`, with parameters carried across by `dsr_tpu_torch.convert`, and the
port's copies of the design helpers against `golden`.  Inputs are made with
numpy from a seed.

Tolerance: 1e-5 of the largest magnitude of the reference for MFCC, CMN and
GMM scores (float32 matmuls, logs and logsumexp, which differ only in
rounding order); the design helpers are bit-equal.
"""

import numpy as np
import pytest
import torch

from _torch_parity import SR, M, geometry, rel, subbands
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.ops import features as jft
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.utils import design
from golden import features as gfeat
from golden import filterbank as gfb
from golden import room as groom


def test_design_helpers_equal_golden():
    POS, _ = geometry()
    src = np.array([0.5, 2.0, 0.3])
    assert np.array_equal(design.steering_delays(POS, src, 343.0, SR),
                          groom.steering_delays(POS, src, 343.0, SR))
    freqs = np.arange(M // 2 + 1) * (SR / M)
    for warp in (1.0, 0.9):
        assert np.array_equal(design.mel_filterbank(30, freqs, 20.0, 8000.0, warp),
                              gfeat.mel_filterbank(30, freqs, 20.0, 8000.0, warp))
    assert np.array_equal(design.dct_matrix(13, 30), gfeat.dct_matrix(13, 30))
    for S in (1, 3000, 16000):
        assert design.num_frames(S, 256, 4, 2) == gfb.num_frames(S, 256, 4, 2)


@pytest.mark.parametrize("warp", [1.0, 0.92])
def test_subband_mfcc_and_cmn_match_jax(warp):
    rng = np.random.default_rng(1)
    Y = subbands(rng, N=1)[0]
    f_ref = np.asarray(jft.cmn(jft.mfcc_from_subbands(Y, M, SR, vtln_warp=warp)))
    f = ft.cmn(ft.mfcc_from_subbands(torch.as_tensor(Y), M, SR, vtln_warp=warp))
    assert f.shape == (40, 13)
    assert rel(f.numpy(), f_ref) < 1e-5
    assert torch.allclose(f.mean(0), torch.zeros(13), atol=1e-5)


def _jax_gmm(rng, S=12, C=3, D=13):
    return jgmm.GmmParams(
        rng.standard_normal((S, C, D)).astype(np.float32),
        (0.5 + rng.random((S, C, D))).astype(np.float32),
        np.log(rng.dirichlet(np.ones(C), size=S)).astype(np.float32),
    )


def test_gmm_loglik_and_posteriors_match_jax():
    rng = np.random.default_rng(2)
    jp = _jax_gmm(rng)
    p = convert.gmm_params(jp)
    feats = rng.standard_normal((2, 30, 13)).astype(np.float32)
    W_ref, shape_ref = jgmm.pack_matmul_weights(jp)
    W, shape = gmm.pack_matmul_weights(p)
    assert shape == shape_ref
    assert rel(W.numpy(), np.asarray(W_ref)) < 1e-6
    ll_ref = np.asarray(jgmm.loglik(jp, feats))
    ll = gmm.loglik(p, torch.as_tensor(feats))
    assert ll.shape == (2, 30, 12)
    assert rel(ll.numpy(), ll_ref) < 1e-5
    assert torch.equal(p(torch.as_tensor(feats)), ll)
    sll_ref, post_ref = (np.asarray(a) for a in jgmm.component_posteriors(jp, feats))
    sll, post = gmm.component_posteriors(p, torch.as_tensor(feats))
    assert rel(sll.numpy(), sll_ref) < 1e-5
    assert np.max(np.abs(post.numpy() - post_ref)) < 1e-5
    assert p.num_states == jp.num_states == 12
