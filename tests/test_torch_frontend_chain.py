"""Slice 8 as a whole: a barge-in front end through the JAX package and
through the port on the CPU, on one recording made with numpy from a seed.

An 8-mic circular 0.10 m array records 1 s: a talker at (0, 2, 0) m who
speaks from 0.35 s to 0.75 s, and a loudspeaker 0.3 m from the array that
plays a prompt throughout, at 20 dB sensor SNR (`utils/room.py`, free
field).  The chain at M = 64, m = 2, r = 2 (a shipped prototype):
analysis -> delay-and-sum `apply_weights` -> `cancel_voice_prompt` (the
prompt's analysis as the far end, step 0.1: the talker goes on over the
prompt, and a larger step lets the filter chase the talker) -> `sohn_vad`
(noise PSD from the first 20 frames, threshold 1: on noise of a known PSD
its decision-directed ratio averages slightly above 0) -> synthesis ->
400 / 160 Hamming frames -> warped-MVDR cepstra (order 16) ->
`add_deltas` -> `splice(3, 3)`; then the objective measures
of the output against the talker's clean signal.  The JAX analysis and
synthesis run their XLA paths, as tests/test_torch_filterbank.py runs them.

Tolerances: waveform 1e-4 of its largest magnitude (complex64 NLMS over
the frames, float32 FFTs); decisions and segments equal; cepstra and their
deltas and splices 5e-3 of the largest magnitude (tests/test_features.py's
bound for float32 warped MVDR); the objective measures within 1e-12 (the
same float64 numpy on the same waveforms).
"""

import numpy as np
import pytest
import torch

from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import aec as jaec
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import features as jft
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops import lpc as jlpc
from dsr_tpu.ops import sad as jsad
from dsr_tpu.utils import objective as jobj
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig
from dsr_tpu_torch.ops import aec, beamforming, features, filterbank, lpc, sad
from dsr_tpu_torch.utils import objective, room

SR = 16000.0
S = 16000


def rel(a, ref) -> float:
    return float(np.max(np.abs(np.asarray(a) - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(13)
    pos = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    talk = rng.standard_normal(S) * ((np.arange(S) >= 0.35 * SR) & (np.arange(S) < 0.75 * SR))
    prompt = rng.standard_normal(S)
    x = (room.simulate(talk, pos, np.array([0.0, 2.0, 0.0]), SR, snr_db=20.0, rng=rng)
         + room.simulate(prompt, pos, np.array([0.0, -0.3, 0.05]), SR, snr_db=None, rng=rng))
    taus = room.steering_delays(pos, np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR
    w = np.array(jbf.ds_weights(jbf.steering_vectors(taus.astype(np.float32), 64, SR)))
    return x.astype(np.float32), prompt.astype(np.float32), talk, w


def hamming_frames(y):
    idx = np.arange(1 + (S - 400) // 160)[:, None] * 160 + np.arange(400)[None, :]
    return (y[idx] * np.hamming(400)).astype(np.float32)


@pytest.fixture(scope="module")
def chains(scene):
    x, prompt, _, w = scene
    jcfg = JFilterbankConfig(M=64, m=2, r=2)
    Y = jbf.apply_weights(jfb.analysis(x, jcfg), w)
    E, _ = jaec.cancel_voice_prompt(Y, jfb.analysis(prompt, jcfg), taps=4, mu=0.1)
    P = np.abs(np.asarray(E)) ** 2
    dec, llr = jsad.sohn_vad(P, P[:20].mean(0), threshold=1.0)
    y = np.asarray(jfb.synthesis(E, jcfg, S))
    c = jlpc.warped_mvdr_cepstra(hamming_frames(y), order=16)
    feats = jft.splice(jft.add_deltas(c), 3, 3)
    ref = dict(y=y, dec=np.asarray(dec), llr=np.asarray(llr), c=np.asarray(c),
               feats=np.asarray(feats))

    cfg = FilterbankConfig(M=64, m=2, r=2)
    Y_t = beamforming.apply_weights(filterbank.analysis(torch.as_tensor(x), cfg),
                                    torch.as_tensor(w))
    E_t, _ = aec.cancel_voice_prompt(Y_t, filterbank.analysis(torch.as_tensor(prompt), cfg),
                                     taps=4, mu=0.1)
    P_t = E_t.abs() ** 2
    dec_t, llr_t = sad.sohn_vad(P_t, P_t[:20].mean(0), threshold=1.0)
    y_t = filterbank.synthesis(E_t, cfg, S)
    window = torch.as_tensor(np.hamming(400).astype(np.float32))
    c_t = lpc.warped_mvdr_cepstra(y_t.unfold(-1, 400, 160) * window, order=16)
    feats_t = features.splice(features.add_deltas(c_t), 3, 3)
    got = dict(y=y_t.numpy(), dec=dec_t.numpy(), llr=llr_t.numpy(), c=c_t.numpy(),
               feats=feats_t.numpy())
    return ref, got


def test_barge_in_chain_matches_jax(scene, chains):
    ref, got = chains
    assert got["y"].shape == (S,) and got["feats"].shape == (98, 7 * 39)
    assert rel(got["y"], ref["y"]) < 1e-4
    assert np.array_equal(got["dec"], ref["dec"])
    assert sad.segments_from_vad(got["dec"]) == jsad.segments_from_vad(ref["dec"])
    assert rel(got["c"], ref["c"]) < 5e-3 and rel(got["feats"], ref["feats"]) < 5e-3
    # the detector finds the talker: frame t of the bank centres on sample 32 t
    t = np.arange(len(got["dec"])) * 32 / SR
    assert got["dec"][(t > 0.40) & (t < 0.70)].mean() > 0.9
    assert got["dec"][(t > 0.05) & (t < 0.30)].mean() < 0.2


def test_objective_measures_match_jax(scene, chains):
    talk = scene[2]
    ref, got = chains
    y = got["y"].astype(np.float64)
    for name in ("si_sdr", "segmental_snr", "fw_segmental_snr"):
        a = getattr(objective, name)(y, talk)
        b = getattr(jobj, name)(y, talk)
        assert abs(a - b) < 1e-12, name
    assert objective.fw_segmental_snr(y[:100], talk[:100]) == jobj.fw_segmental_snr(
        y[:100], talk[:100])                     # shorter than one frame: SI-SDR
    # the echo canceller helps: the output is closer to the talker than the
    # delay-and-sum output alone
    x, _, _, w = scene
    cfg = FilterbankConfig(M=64, m=2, r=2)
    y_ds = filterbank.synthesis(beamforming.apply_weights(
        filterbank.analysis(torch.as_tensor(x), cfg), torch.as_tensor(w)), cfg, S).numpy()
    assert objective.si_sdr(y, talk) > objective.si_sdr(y_ds.astype(np.float64), talk) + 3
