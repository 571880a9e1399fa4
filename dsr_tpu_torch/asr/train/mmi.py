"""MMI (maximum mutual information) estimation via extended Baum-Welch
(PyTorch).

Counterpart of `dsr_tpu/asr/train/mmi.py` (reference `asr/train/` MMI
[K]): numerator statistics from the forced alignment of the reference
transcript, denominator statistics from the forward-backward over the full
decoding graph (`denominator_gamma`) or over the decode lattice
(`denominator_gamma_lattice`); the M-step is the extended Baum-Welch
update with a per-Gaussian smoothing constant:

    μ' = (sx_num − sx_den + E·occ·μ) / (occ_num − occ_den + E·occ)
    σ²' analogous with second-order stats (floored).

The full-graph forward-backward is a frame loop of segment max and segment
sum over the packed graph's arcs (`scatter_reduce` "amax" and
`index_add_`) on the device of the log-likelihoods, over a padded batch of
utterances at once; the arc posteriors of an utterance's frames are then
one vectorised pass.  On the card the segment sums are
atomic adds in no fixed order, so the card and the CPU agree to float32
rounding (about 1e-5 on γ), not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import path as apath
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.am.gmm import GmmParams
from dsr_tpu_torch.asr.decoder import lattice as lat_
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.asr.decoder.wfst_decoder import NEG
from dsr_tpu_torch.asr.train import ml
from dsr_tpu_torch.asr.train.ml import GmmAccum


def mstep_mmi(params: GmmParams, num: GmmAccum, den: GmmAccum, e_const: float = 2.0,
              var_floor: float = 1e-3) -> GmmParams:
    """Extended Baum-Welch update with E·occ_den smoothing (standard EBW)."""
    occ_num = num.occ[..., None]
    occ_den = den.occ[..., None]
    Dsm = e_const * occ_den + 1e-3
    denom = occ_num - occ_den + Dsm
    means = (num.sx - den.sx + Dsm * params.means) / denom
    second = (num.sxx - den.sxx + Dsm * (params.variances + params.means**2)) / denom
    variances = torch.clamp_min(second - means**2, var_floor)
    # weights: EBW weight update (simple smoothed ratio, renormalised)
    w_new = torch.clamp_min(num.occ - den.occ + e_const * torch.exp(params.logweights)
                            * torch.sum(num.occ, dim=-1, keepdim=True), 1e-8)
    logw = torch.log(w_new / torch.sum(w_new, dim=-1, keepdim=True))
    return GmmParams(means, variances, logw)


def _segment_logsumexp(contrib: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """log Σ exp(contrib) per row and segment id in seg (S segments), by
    segment max and normalised segment sum: contrib (U, A), seg (A,) →
    (U, S), NEG for a segment no arc reaches."""
    U = contrib.shape[0]
    mx = torch.full((U, S), -torch.inf, dtype=contrib.dtype, device=contrib.device)
    mx = mx.scatter_reduce(1, seg.expand(U, -1), contrib, "amax", include_self=False)
    mx_safe = torch.where(torch.isfinite(mx), mx, 0.0)
    sums = torch.zeros((U, S), dtype=contrib.dtype, device=contrib.device)
    sums.index_add_(1, seg, torch.exp(contrib - mx_safe[:, seg]))
    return torch.where(sums > 0, mx_safe + torch.log(sums), NEG)


def denominator_gamma(graph_dev, loglik: torch.Tensor, return_total: bool = False,
                      lengths=None):
    """State posteriors over the packed decode graph → pdf posteriors.

    graph_dev: `wfst_decoder.DeviceGraph`; loglik: (T, P) → γ_pdf (T, P)
    [, the total denominator log-likelihood when `return_total`: the exact
    log Σ_paths p(X, path) the MMI criterion needs, a float64 0-d tensor].
    A padded batch of utterances, loglik (U, T, P) with `lengths` (U,)
    (all T when None), → γ (U, T, P), zero past each length [, totals
    (U,)]: one frame loop carries every utterance, each with its own sums,
    so a batch costs the launches of its longest utterance.
    Log-domain forward-backward over the arcs (all emitting), on the device
    of loglik.

    Scaled, unlike the JAX package's: each frame's forward and backward
    values are shifted by their maximum and the shifts summed in float64,
    so float32 keeps their precision at any utterance length.  Unscaled,
    α and β grow with the utterance (to |2,500| over config 1's, where
    float32's spacing is 2.4e-4), and γ inherits that rounding.
    """
    src, pdf, w, dst = graph_dev.src, graph_dev.pdf, graph_dev.weight, graph_dev.dst
    S = graph_dev.num_states
    batched = loglik.dim() == 3
    ll = loglik if batched else loglik[None]
    U, T, P = ll.shape
    dev = ll.device
    lens = [T] * U if lengths is None else [int(n) for n in lengths]
    active = (torch.arange(T, device=dev)[None, :]
              < torch.as_tensor(lens, device=dev)[:, None])          # (U, T)

    def shift(v):   # each row minus its max (0 for a row of NEG), and the maxima
        m = v.max(dim=1).values
        m = torch.where(m > NEG / 2, m, 0.0)
        return v - m[:, None], m.double()

    # alphas[:, t]: alpha BEFORE frame t, betas[:, t]: beta AFTER frame t,
    # each stored shifted; the true values add the offsets a_off, b_off.
    # Past its length an utterance's values and offsets stay as they are.
    alphas = torch.empty((U, T, S), dtype=torch.float32, device=dev)
    a_off = torch.empty((U, T), dtype=torch.float64, device=dev)
    alpha = torch.full((U, S), NEG, dtype=torch.float32, device=dev)
    alpha[:, graph_dev.start] = 0.0
    off = torch.zeros(U, dtype=torch.float64, device=dev)
    for t in range(T):
        alphas[:, t], a_off[:, t] = alpha, off
        new, m = shift(_segment_logsumexp(alpha[:, src] + w + ll[:, t, pdf], dst, S))
        alpha = torch.where(active[:, t, None], new, alpha)
        off = off + torch.where(active[:, t], m, 0.0)
    total = off + torch.logsumexp(alpha + graph_dev.final_weight, dim=1).double()
    betas = torch.empty((U, T, S), dtype=torch.float32, device=dev)
    b_off = torch.empty((U, T), dtype=torch.float64, device=dev)
    beta, off = shift(graph_dev.final_weight.expand(U, -1))
    for t in range(T - 1, -1, -1):
        betas[:, t], b_off[:, t] = beta, off
        new, m = shift(_segment_logsumexp(beta[:, dst] + w + ll[:, t, pdf], src, S))
        beta = torch.where(active[:, t, None], new, beta)
        off = off + torch.where(active[:, t], m, 0.0)
    # arc posteriors of all of an utterance's frames at once:
    # γ_arc(t) = α_t[src] + w + ll_t[pdf] + β_{t+1}[dst] − total
    frame_off = (a_off + b_off - total[:, None]).to(torch.float32)
    gammas = torch.zeros((U, T, P), dtype=torch.float32, device=dev)
    for u, n in enumerate(lens):
        lg = (alphas[u, :n][:, src] + w + ll[u, :n][:, pdf] + betas[u, :n][:, dst]
              + frame_off[u, :n, None])
        gammas[u, :n].index_add_(1, pdf, torch.exp(torch.clamp_max(lg, 0.0)))
    if not batched:
        gammas, total = gammas[0], total[0]
    if return_total:
        return gammas, total
    return gammas


def ebw_train(task, params: GmmParams, graph_dev, feats_list, transcripts, iters: int = 4,
              e_const: float = 2.0, verbose: bool = False):
    """The discriminative training loop: per iteration, numerator
    occupancies from the forced alignment of the reference transcript
    (`asr.path.force_align`, through the banded Viterbi kernel on the
    card), denominator occupancies and the total log-likelihoods from the
    exact forward-backward over the decode graph (all utterances in one
    padded batch), then the EBW M-step.

    Runs on the device of `params` (the decode graph must be on the same
    one).  Criterion (Viterbi-numerator MMI): Σ_u [score(align_u) −
    log p_den(X_u)].  Returns (params, history) with history of length
    iters+1: the criterion before each update and after the last.
    """
    S, C, D = params.means.shape
    dev = params.means.device
    fjs = [torch.as_tensor(np.asarray(f, np.float32), device=dev) for f in feats_list]
    lens = [len(f) for f in fjs]
    fpad = torch.nn.utils.rnn.pad_sequence(fjs, batch_first=True)   # (U, T_max, D)

    def pass_once(p):
        num = ml.zero_accum(S, C, D, dev)
        den = ml.zero_accum(S, C, D, dev)
        gds, tots = denominator_gamma(graph_dev, gmm.loglik(p, fpad), return_total=True,
                                      lengths=lens)
        tots = tots.tolist()
        crit = 0.0
        for u, (f, ws) in enumerate(zip(feats_list, transcripts)):
            al = apath.force_align(task, p, f, ws)
            gamma = torch.nn.functional.one_hot(
                torch.as_tensor(al.states, dtype=torch.int64, device=dev), S).to(torch.float32)
            num = ml.accumulate(p, fjs[u], gamma, num)
            den = ml.accumulate(p, fjs[u], gds[u, :lens[u]], den)
            crit += al.score - tots[u]
        return num, den, crit

    history = []
    for it in range(iters):
        num, den, crit = pass_once(params)
        history.append(crit)
        if verbose:
            print(f"EBW iter {it}: criterion {crit:.2f}")
        params = mstep_mmi(params, num, den, e_const=e_const)
    _, _, crit = pass_once(params)
    history.append(crit)
    if verbose:
        print(f"EBW final: criterion {crit:.2f}")
    return params, history


def denominator_gamma_lattice(token_graph, loglik, kcap: int = 256, beam: float = 30.0,
                              nlat: int = 8) -> np.ndarray:
    """LVCSR-scale MMI denominator: pdf occupancies from the decode LATTICE
    (reference lattice-based MMI [K]) instead of the full decoding graph;
    per-frame cost is bounded by kcap·nlat whatever the graph's size.

    token_graph: `topk_decoder.TokenGraph` (the decode runs on its device);
    loglik: (T, P) → γ_pdf (T, P) numpy float64, accumulated on the host
    from the lattice's link posteriors.  Converges to `denominator_gamma`
    as kcap, beam and nlat grow.
    """
    out = tk.decode_with_tokens(token_graph, loglik, kcap=kcap, beam=beam, nlat=nlat)
    _, _, ts_, ta_, tsc_, aa, asc = out
    lat = lat_.from_topk(ts_, ta_, tsc_, token_graph, aa, asc)
    _, _, _, post = lat.forward_backward()          # (T, K, N), sums to 1 per frame
    T = post.shape[0]
    P = loglik.shape[-1]
    arcs = lat.alt_arcs
    pdfs = token_graph.pdf.cpu().numpy().reshape(-1)[np.maximum(arcs, 0)]
    valid = arcs >= 0
    frames = np.broadcast_to(np.arange(T)[:, None, None], arcs.shape)
    gamma = np.zeros((T, P))
    np.add.at(gamma, (frames[valid], pdfs[valid]), post[valid])
    return gamma
