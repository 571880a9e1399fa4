"""The slice as a whole: BASELINE config 3's front end (GCC-PHAT TDOAs →
IEKF tracker → tracked steering → MVDR-quiescent GSC-NLMS, and tracked DS
over the tracker's trajectory → synthesis → MFCC + CMN), composed as
tests/test_tracked_gsc_wer.py composes it, at a small size: an 8-mic
0.10 m circular array, M = 64, 1.5 s of a seeded source in free field.
Both packages' trackers start from the same TDOAs, and both beamformers
are fed the JAX package's tracked delays: a delay 1e-9 s off turns the
steering phase at 8 kHz by 5e-5 rad, which would hide the beamformers'
own agreement.

Tolerances: positions within 1e-4 m and delays within 1e-9 s (see
tests/test_torch_tracking.py); subbands and waveforms within 1e-4 of the
largest reference magnitude, the MVDR gate of tests/test_torch_beamforming.py
(the quiescent weights come from an ill-conditioned solve); features within
1e-4 (log-mel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SR, rel
from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import features as jft
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops import tde as jtde
from dsr_tpu.ops import tracking as jtrack
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.ops import tde
from dsr_tpu_torch.ops import tracking as track
from golden import room as groom

SOURCE = np.array([0.6, 1.5, 0.3])
PRIOR = (SOURCE + np.array([0.5, -0.4, 0.2])).astype(np.float32)
BL, HOP = 8000, 4000


@pytest.fixture(scope="module")
def case():
    POS = np.asarray(JGeometry.circular(8, 0.10).positions).astype(np.float32)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)]
    PI, PJ = (np.asarray([p[k] for p in pairs]) for k in (0, 1))
    rng = np.random.default_rng(11)
    xm = groom.simulate(rng.standard_normal(24000), POS, SOURCE, SR, snr_db=20.0,
                        rng=rng).astype(np.float32)
    nb = (xm.shape[-1] - BL) // HOP + 1
    # the TDOAs both packages start from: the port's own, checked against JAX's
    td = torch.stack([tde.gcc_phat_pairs(torch.as_tensor(xm[:, b * HOP:b * HOP + BL]), pairs,
                                         SR, max_tau=0.21 / 343.0, interp=16)
                      for b in range(nb)]).numpy()
    td_ref = np.stack([np.asarray(jtde.gcc_phat_pairs(xm[:, b * HOP:b * HOP + BL], pairs, SR,
                                                      max_tau=0.21 / 343.0, interp=16))
                       for b in range(nb)])
    assert np.max(np.abs(td - td_ref)) < 1e-3 / SR
    seq = np.concatenate([np.tile(np.median(td_ref, axis=0), (40, 1)), td_ref]).astype(np.float32)
    return xm, POS, PI, PJ, seq, nb


def _track(case):
    xm, POS, PI, PJ, seq, _ = case
    P0 = np.eye(3, dtype=np.float32) * 0.09
    est_ref = np.asarray(jtrack.track(jnp.asarray(seq), jnp.asarray(PRIOR), jnp.asarray(P0),
                                      jnp.asarray(POS), jnp.asarray(PI), jnp.asarray(PJ),
                                      q=1e-6, r=1e-8))
    est = track.track(torch.as_tensor(seq), torch.as_tensor(PRIOR), torch.as_tensor(P0),
                      torch.as_tensor(POS), torch.as_tensor(PI), torch.as_tensor(PJ),
                      q=1e-6, r=1e-8)
    assert np.max(np.abs(est.numpy() - est_ref)) < 1e-4
    return est, est_ref


def test_tracked_gsc_matches_jax(case):
    xm, POS, _, _, _, nb = case
    est, est_ref = _track(case)
    taus_ref = np.array(jtrack.steering_delays_from_position(jnp.asarray(est_ref[39]),
                                                             jnp.asarray(POS)))
    taus = track.steering_delays_from_position(est[39], torch.as_tensor(POS))
    assert np.max(np.abs(taus.numpy() - taus_ref)) < 1e-9
    taus_true = groom.steering_delays(POS, SOURCE, 343.0, SR) / SR
    assert np.mean(np.abs(taus.numpy() - taus_true)) < 30e-6   # the JAX gate

    jcfg, cfg = JFilterbankConfig(M=64, m=4, r=2), FilterbankConfig(M=64, m=4, r=2)
    A_ref = jfb.analysis(xm, jcfg)
    v_ref = jbf.steering_vectors(jnp.asarray(taus_ref), 64, SR)
    w_ref = jbf.mvdr_weights(v_ref, jbf.diffuse_coherence(POS, 64, SR, 343.0), 1e-2)
    Y_ref, wa_ref = jbf.gsc_nlms(A_ref, w_ref, jbf.blocking_matrix(v_ref), 0.05, 1e-6, 10.0)
    y_ref = np.asarray(jfb.synthesis(Y_ref, jcfg, xm.shape[-1]))
    f_ref = np.asarray(jft.cmn(jft.mfcc_from_subbands(Y_ref, 64, SR)))

    A = fb.analysis(torch.as_tensor(xm), cfg)
    v = bf.steering_vectors(torch.as_tensor(taus_ref), 64, SR)
    w = bf.mvdr_weights(v, bf.diffuse_coherence(POS, 64, SR, 343.0), 1e-2)
    Y, wa = bf.gsc_nlms(A, w, bf.blocking_matrix(v), 0.05, 1e-6, 10.0)
    y = fb.synthesis(Y, cfg, xm.shape[-1])
    f = ft.cmn(ft.mfcc_from_subbands(Y, 64, SR))
    assert rel(Y.numpy(), np.asarray(Y_ref)) < 1e-4
    assert rel(wa.numpy(), np.asarray(wa_ref)) < 1e-4
    assert rel(y.numpy(), y_ref) < 1e-4 and rel(f.numpy(), f_ref) < 1e-4


def test_tracked_ds_over_the_trajectory_matches_jax(case):
    """DS steered frame by frame along the tracker's per-block positions
    (the last nb steps, one per 0.5 s GCC block), each frame taking the
    block that covers its centre."""
    xm, POS, _, _, _, nb = case
    est, est_ref = _track(case)
    jcfg, cfg = JFilterbankConfig(M=64, m=4, r=2), FilterbankConfig(M=64, m=4, r=2)
    A = fb.analysis(torch.as_tensor(xm), cfg)
    T = A.shape[1]
    block = np.clip((np.arange(T) * cfg.D - BL // 2) // HOP, 0, nb - 1)
    taus_t = torch.stack([track.steering_delays_from_position(p, torch.as_tensor(POS))
                          for p in est[-nb:]])[torch.as_tensor(block)]
    taus_t_ref = np.stack([np.asarray(jtrack.steering_delays_from_position(
        jnp.asarray(p), jnp.asarray(POS))) for p in est_ref[-nb:]])[block]
    assert np.max(np.abs(taus_t.numpy() - taus_t_ref)) < 1e-9
    Y = bf.ds_beamform(A, torch.as_tensor(taus_t_ref), 64, SR)
    Y_ref = np.asarray(jbf.ds_beamform(jfb.analysis(xm, jcfg), taus_t_ref, 64, SR))
    assert Y.shape == (T, 33)
    assert rel(Y.numpy(), Y_ref) < 1e-4
    assert rel(fb.synthesis(Y, cfg, xm.shape[-1]).numpy(),
               np.asarray(jfb.synthesis(Y_ref, jcfg, xm.shape[-1]))) < 1e-4
