"""Port parity: speaker-adaptive training (`dsr_tpu_torch/asr/adapt/sat.py`)
against the JAX package's, on tests/test_adapt_mmi_lattice.py's SAT
recipes (two speakers with cepstral shifts on the 6-word phone task,
GMMs trained by the JAX package and carried across).

Tolerances, as max |a - b| over the largest |b|:
  - the host loop (`sat_iteration`, re-aligned occupancies from each
    package's own forced alignment, checked equal): transforms 5e-4, as
    tests/test_torch_adapt.py allows fMLLR (float32 row updates); the
    re-estimated means 2e-3, the reference's own gate between its two SAT
    forms (an M-step over float32 statistics of transformed features);
    measured 2e-5 and 4e-6;
  - the batched form against the host loop on fixed occupancies: 2e-4
    (transforms) and 2e-3 (means), the reference's gate, in the port and
    against the JAX package's batched form; measured 3-7e-5 and 4e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import adapt_gamma, adapt_system, rel
from dsr_tpu.asr.adapt import fmllr as jfmllr
from dsr_tpu.asr.adapt import sat as jsat
from dsr_tpu_torch.asr.adapt import fmllr, sat
from dsr_tpu_torch.asr.am import gmm


@pytest.fixture(scope="module")
def system():
    return adapt_system()


def test_sat_iteration_matches_jax(system):
    jtask, task, jp, p, feats, words = system
    shifts = {"spkA": np.r_[np.float32([1.2, -0.6, 0.4]), np.zeros(10, np.float32)],
              "spkB": np.r_[np.float32([-0.9, 0.8, -0.3]), np.zeros(10, np.float32)]}
    speakers = {"spkA": [feats[0] + shifts["spkA"], feats[2] + shifts["spkA"]],
                "spkB": [feats[1] + shifts["spkB"], feats[3] + shifts["spkB"]]}
    spk_words = {"spkA": [words[0], words[2]], "spkB": [words[1], words[3]]}

    def gamma_fn(params, f, spk, utt_idx):
        ws = spk_words[spk][utt_idx if utt_idx is not None else 0]
        return adapt_gamma(jtask, task, jp, p, np.asarray(f, np.float32), ws)

    new, Ws = sat.sat_iteration(p, speakers, gamma_fn, num_comp=2)
    jnew, jWs = jsat.sat_iteration(jp, speakers, gamma_fn, num_comp=2)
    assert list(Ws) == list(jWs) == ["spkA", "spkB"]
    for spk, utts in speakers.items():
        assert rel(Ws[spk].numpy(), jWs[spk]) < 5e-4
        f = torch.as_tensor(utts[0])
        ll_raw = float(gmm.loglik(p, f).max(-1).values.sum())
        ll_sat = float(gmm.loglik(p, fmllr.apply_fmllr(f, Ws[spk])).max(-1).values.sum())
        assert ll_sat > ll_raw
    for name in ("means", "variances"):
        assert rel(getattr(new, name).numpy(), getattr(jnew, name)) < 2e-3, name


def test_sat_batched_matches_host_loop_and_jax(system):
    jtask, task, jp, p, feats, words = system
    T = min(f.shape[0] for f in feats[:4])
    utts = [np.asarray(f[:T], np.float32) for f in feats[:4]]
    gams = [adapt_gamma(jtask, task, jp, p, u, words[i]) for i, u in enumerate(utts)]
    speakers = {"a": [utts[0], utts[1]], "b": [utts[2], utts[3]]}
    gmap = {("a", 0): gams[0], ("a", 1): gams[1], ("b", 0): gams[2], ("b", 1): gams[3]}

    def gamma_fn(params, f, spk, utt_idx):
        return gmap[(spk, 0 if utt_idx is None else utt_idx)]

    ref_params, ref_W = sat.sat_iteration(p, speakers, gamma_fn, num_comp=2)
    fb = np.stack([np.stack([utts[0], utts[1]]), np.stack([utts[2], utts[3]])])
    gb = np.stack([np.stack([gams[0], gams[1]]), np.stack([gams[2], gams[3]])])
    # the host loop re-accumulates with utterance 0's occupancies
    gb2 = np.stack([np.stack([gams[0], gams[0]]), np.stack([gams[2], gams[2]])])
    new, Ws = sat.sat_iteration_batched(p, fb, gb,
                                        gamma_fn=lambda params, f: torch.as_tensor(gb2))
    jnew, jWs = jsat.sat_iteration_batched(jp, fb, gb, gamma_fn=lambda params, f: jnp.asarray(gb2))
    assert Ws.shape == (2, 13, 14)
    for i, spk in enumerate(("a", "b")):
        assert rel(Ws[i].numpy(), ref_W[spk].numpy()) < 2e-4
        assert rel(Ws[i].numpy(), jWs[i]) < 2e-4
    assert rel(new.means.numpy(), ref_params.means.numpy()) < 2e-3
    assert rel(new.means.numpy(), jnew.means) < 2e-3
    # the transform applied to a speaker's whole batch, as the JAX package does
    assert rel(fmllr.apply_fmllr(torch.as_tensor(fb), Ws[:, None]).numpy(),
               np.stack([np.asarray(jfmllr.apply_fmllr(jnp.asarray(fb[i]), jWs[i]))
                         for i in range(2)])) < 2e-4
