"""The port's MMI training (`dsr_tpu_torch.asr.train.mmi`) against the JAX
package's (`dsr_tpu.asr.train.mmi`) at tests/test_adapt_mmi_lattice.py's
fixture size: the phone task over six words (two states per phone), 25
corpus utterances, GMMs of two components trained in 3 iterations (by the
port, on the CPU, and carried to the JAX package), and the bigram HCLG
built by the JAX package and carried across by `convert.packed_graph`.

Tolerances: the EBW update is elementwise float32 arithmetic (1e-5
relative; for the variances, σ² = E[x²] − μ² in float32, relative to
|σ²| + μ², the magnitude of the terms that cancel).  The full-graph
denominator forward-backward is held to a float64 one (1e-4 absolute on
γ, 1e-6 relative on the total) and to the JAX package's within that one's
own distance from float64 plus 1e-4: the port scales each frame's forward
and backward values, the JAX package does not, and its float32 values
lose more than 1e-4 on γ at this size (1e-5 relative on the total).  `ebw_train`'s
criterion sums Viterbi alignment scores and totals over 5 utterances and
2 iterations (1e-3 relative).  The lattice denominator is held to the JAX
package's own gates against the full-graph one (exhaustive: 2e-3 max;
pruned: 0.02 mean).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import config1_corpus, phone_pair
from dsr_tpu.asr.am.gmm import GmmParams as JGmmParams
from dsr_tpu.asr.decoder import wfst_decoder as jwd
from dsr_tpu.asr.fsm import hclg as jhclg
from dsr_tpu.asr.fsm import lm as jlm
from dsr_tpu.asr.fsm.packed import pack as jpack
from dsr_tpu.asr.train import ml as jml
from dsr_tpu.asr.train import mmi as jmmi
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import path as apath
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.asr.decoder import wfst_decoder as wd
from dsr_tpu_torch.asr.train import ml, mmi, trainer
from dsr_tpu_torch.utils import corpus


@pytest.fixture(scope="module")
def system():
    jtask, task = phone_pair(corpus.VOCAB[:6])
    feats, words = config1_corpus(40, seed=0)
    keep = [i for i, ws in enumerate(words) if all(w in task.vocab for w in ws)][:25]
    feats, words = [feats[i] for i in keep], [words[i] for i in keep]
    params = trainer.train(task, feats, words, num_comp=2, iters=3, device="cpu")
    jparams = JGmmParams(*(jnp.asarray(getattr(params, n).numpy())
                           for n in ("means", "variances", "logweights")))
    G = jlm.arpa_to_fst(jlm.train_arpa_bigram(words, jtask.vocab), jtask.words)
    L, ndis = jhclg.build_lexicon_fst(jtask.lexicon, jtask.phones, jtask.words,
                                      sil_phone="sil")
    H = jhclg.build_hmm_fst(len(jtask.phones) - 1, ndis, states_per_phone=jtask.spp)
    jgraph = jpack(jhclg.compose_hclg(H, L, G, len(jtask.phones) - 1, ndis))
    graph = convert.packed_graph(jgraph)
    return dict(jtask=jtask, task=task, feats=feats, words=words, params=params,
                jparams=jparams, jdev=jwd.to_device(jgraph), dev=wd.to_device(graph, "cpu"),
                graph=graph)


def _forward_backward_f64(g, ll):
    """The full-graph forward-backward (the JAX package's, unscaled) in
    float64: (γ (T, P), total)."""
    src, pdf, dst, S = g.src, g.pdf, g.dst, g.num_states
    w, ll = g.weight.double(), ll.double()
    T, P = ll.shape

    def lse(c, seg):
        mx = torch.full((S,), -torch.inf, dtype=torch.float64).scatter_reduce(
            0, seg, c, "amax", include_self=False)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        sums = torch.zeros(S, dtype=torch.float64).index_add_(0, seg, torch.exp(c - mx[seg]))
        return torch.where(sums > 0, mx + torch.log(sums), -1e30)

    alpha = torch.full((S,), -1e30, dtype=torch.float64)
    alpha[g.start] = 0.0
    alphas, betas = [], [None] * T
    for t in range(T):
        alphas.append(alpha)
        alpha = lse(alpha[src] + w + ll[t, pdf], dst)
    final = g.final_weight.double()
    total = torch.logsumexp(alpha + final, dim=0)
    beta = final
    for t in range(T - 1, -1, -1):
        betas[t] = beta
        beta = lse(beta[dst] + w + ll[t, pdf], src)
    lg = torch.stack(alphas)[:, src] + w + ll[:, pdf] + torch.stack(betas)[:, dst] - total
    gam = torch.zeros((T, P), dtype=torch.float64).index_add_(1, pdf, torch.exp(lg.clamp_max(0)))
    return gam.numpy(), float(total)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1e-6)))


def test_mstep_mmi_and_denominator_gamma_match_jax(system):
    s = system
    S, C, D = s["params"].means.shape
    f = s["feats"][1]
    ll = gmm.loglik(s["params"], torch.as_tensor(f))
    g, tot = mmi.denominator_gamma(s["dev"], ll, return_total=True)
    # the EBW update on one utterance's numerator (its alignment) and
    # denominator statistics, the same numbers fed to both packages
    al = apath.force_align(s["task"], s["params"], f, s["words"][1])
    num = ml.accumulate(s["params"], torch.as_tensor(f),
                        torch.nn.functional.one_hot(torch.as_tensor(al.states).long(), S).float(),
                        ml.zero_accum(S, C, D))
    den = ml.accumulate(s["params"], torch.as_tensor(f), g, ml.zero_accum(S, C, D))
    new = mmi.mstep_mmi(s["params"], num, den)
    ref = jmmi.mstep_mmi(s["jparams"], *(jml.GmmAccum(*(jnp.asarray(a.numpy()) for a in x))
                                         for x in (num, den)))
    for name in ("means", "logweights"):
        assert _rel(getattr(new, name), getattr(ref, name)) <= 1e-5, name
    # σ² = E[x²] − μ² cancels: relative to the terms' magnitude |σ²| + μ²
    v, v_ref, mu = new.variances.numpy(), np.asarray(ref.variances), np.asarray(ref.means)
    assert float(np.max(np.abs(v - v_ref) / (np.abs(v_ref) + mu**2))) <= 1e-5

    g_ref, tot_ref = jmmi.denominator_gamma(s["jdev"], jnp.asarray(ll.numpy()),
                                            return_total=True)
    g64, tot64 = _forward_backward_f64(s["dev"], ll)
    g, g_ref = g.numpy(), np.asarray(g_ref)
    assert g.shape == (len(f), S)
    # the port's scaled forward-backward against float64, and against the
    # JAX package's unscaled float32 one up to the latter's own error
    err_port, err_jax = float(np.abs(g - g64).max()), float(np.abs(g_ref - g64).max())
    assert err_port <= 1e-4
    assert float(np.abs(g - g_ref).max()) <= err_jax + 1e-4
    assert abs(float(tot) - float(tot_ref)) <= 1e-5 * abs(float(tot_ref))
    assert abs(float(tot) - tot64) <= 1e-6 * abs(tot64)
    np.testing.assert_allclose(g.sum(axis=1), 1.0, atol=1e-4)

    # a padded batch (as `ebw_train` runs it) gives each utterance its own
    # γ and total, zero past its length
    f0 = s["feats"][0]
    lls = [gmm.loglik(s["params"], torch.as_tensor(x)) for x in (f0, f)]
    pad = torch.nn.utils.rnn.pad_sequence(lls, batch_first=True)
    gb, totb = mmi.denominator_gamma(s["dev"], pad, return_total=True,
                                     lengths=[len(f0), len(f)])
    for u, l_ in enumerate(lls):
        g1, t1 = mmi.denominator_gamma(s["dev"], l_, return_total=True)
        n = len(l_)
        assert float((gb[u, :n] - g1).abs().max()) <= 1e-6
        assert not bool(gb[u, n:].any())
        assert abs(float(totb[u]) - float(t1)) <= 1e-9 * abs(float(t1))


def test_ebw_train_matches_jax_and_increases_the_criterion(system):
    s = system
    _, hist = mmi.ebw_train(s["task"], s["params"], s["dev"], s["feats"][:5], s["words"][:5],
                            iters=2, e_const=2.0)
    _, ref = jmmi.ebw_train(s["jtask"], s["jparams"], s["jdev"], s["feats"][:5],
                            s["words"][:5], iters=2, e_const=2.0)
    hist, ref = np.asarray(hist), np.asarray(ref)
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert (np.diff(hist) > 0).all(), f"EBW criterion not strictly increasing: {hist}"
    np.testing.assert_allclose(hist, ref, rtol=1e-3)


def test_lattice_denominator_meets_the_jax_gates(system):
    s = system
    tg = tk.build_token_graph(s["graph"], "cpu")
    S = s["graph"].num_states
    for i, (kw, gate) in enumerate((
            (dict(kcap=S, beam=1e9, nlat=min(S * tg.a_max, 512)), "max"),
            (dict(kcap=24, beam=30.0, nlat=6), "mean"))):
        ll = gmm.loglik(s["params"], torch.as_tensor(s["feats"][1 if i == 0 else 4]))
        g_dense = mmi.denominator_gamma(s["dev"], ll).numpy()
        g_lat = mmi.denominator_gamma_lattice(tg, ll, **kw)
        assert g_lat.shape == g_dense.shape
        if gate == "max":
            np.testing.assert_allclose(g_lat.sum(axis=1), 1.0, atol=1e-3)
            assert np.max(np.abs(g_lat - g_dense)) < 2e-3
        else:
            np.testing.assert_allclose(g_lat.sum(axis=1), 1.0, atol=1e-2)
            assert np.mean(np.abs(g_lat - g_dense)) < 0.02
