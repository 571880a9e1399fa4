"""Plain reference of the LVCSR cells: diagonal-GMM log-likelihoods and a
beam-pruned top-K token-passing decode over the packed HCLG arcs.

The decode's semantics are those the port states for its decoder: each
frame, every live token extends along each arc of its state (score + arc
log-probability, then + the frame's log-likelihood of the arc's pdf); each
destination state keeps its best incoming candidate (equal scores: the
smaller arc id, arcs numbered state by state in their packed order); the
beam drops candidates not above the frame's best minus `beam`; the best
`kcap` survive (equal scores: the smaller state).  An utterance's tokens
stop at its length.  At the end the best token by score plus final
log-probability wins, or the best token when none is final, and its
backpointers give the words.  Written from that statement with sorts and
backpointers, on whatever device and dtype it is given; dead slots are
-inf, not a large negative number.

The reference computes the GMM in float64 and decodes, in the
configuration's float32, those log-likelihoods rounded to float32: given
the program's own log-likelihoods, this decode reproduces its scores and
words bit for bit (PERF.md), so a gap is the program's, not a search that
rounding sent elsewhere.  The control is the same code a step below the
configuration's float32: the GMM's products on inputs rounded to TF32
(`gmm_loglik(..., "control")`) and the decode's scores, its other
float32, rounded to bfloat16 after each addition (`decode(..., low=True)`).

The graph's arcs are the configuration's: `graph_digest` fingerprints
them, and the configuration states the fingerprint (`expect`), so a
graph that the port's compiler builds otherwise is refused before a run.
`decode(..., tally=...)` also counts, over the utterances' own frames,
the live candidates (arcs of live tokens) and the live slots that these
inputs need: the decoder's work for the rooflines, taken from the
reference and not from the program.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores round a product's inputs; here
    on any device."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def gmm_loglik(feats, means, variances, logw, precision: str):
    """(..., T, D) features -> (..., T, S): log sum_c w_c N(x; mu_sc, var_sc).
    float64: the quadratic form expanded and summed in float64; control:
    the same products in float32 with their inputs rounded to TF32."""
    low = precision != "float64"
    dt = torch.float32 if low else torch.float64
    r = tf32 if low else (lambda t: t)
    x = feats.to(dt)
    mu, var, lw = means.to(dt), variances.to(dt), logw.to(dt)
    S, C, D = mu.shape
    iv = 1.0 / var
    const = lw - 0.5 * (mu * mu * iv + torch.log(2 * math.pi * var)).sum(-1)      # (S, C)
    quad = r(x * x) @ r(-0.5 * iv).reshape(S * C, D).T
    lin = r(x) @ r(mu * iv).reshape(S * C, D).T
    comp = (quad + lin).reshape(*x.shape[:-1], S, C) + const
    return torch.logsumexp(comp, dim=-1)


def graph_digest(src, pdf, olabel, weight, dst, start, final_weight, num_states) -> str:
    """sha256 of the packed arcs in state order (arcs of one state in their
    packed order), the final weights and the start: integers as int64,
    weights as the float32 the decode reads."""
    src = np.asarray(src, np.int64)
    order = np.argsort(src, kind="stable")
    h = hashlib.sha256()
    for a, dt in ((src, "<i8"), (dst, "<i8"), (pdf, "<i8"), (olabel, "<i8"), (weight, "<f4")):
        h.update(np.ascontiguousarray(np.asarray(a)[order], dtype=dt).tobytes())
    h.update(np.ascontiguousarray(final_weight, dtype="<f4").tobytes())
    h.update(np.array([start, num_states], "<i8").tobytes())
    return h.hexdigest()


class Graph:
    """The packed arcs (src, pdf, olabel, weight = -log p, dst, start,
    final weight, +inf where not final) as (S, A) tables on `device`."""

    def __init__(self, src, pdf, olabel, weight, dst, start, final_weight, num_states,
                 device, dtype):
        src = np.asarray(src, np.int64)
        order = np.argsort(src, kind="stable")
        counts = np.bincount(src, minlength=num_states)
        A = int(counts.max())
        first = np.cumsum(counts) - counts
        rows = src[order]
        cols = np.arange(len(src)) - first[rows]
        arc = np.full((num_states, A), -1, np.int64)
        arc[rows, cols] = np.arange(len(src))        # arc id: position in state order
        tab = lambda a, fill, t: torch.as_tensor(  # noqa: E731
            np.where(arc >= 0, np.asarray(a)[order][np.maximum(arc, 0)], fill), dtype=t,
            device=device)
        self.pdf = tab(pdf, 0, torch.int64)
        self.logp = tab(-np.asarray(weight, np.float64), -np.inf, dtype)
        self.dst = tab(dst, 0, torch.int64)
        self.arc = torch.as_tensor(arc, device=device)
        self.olabel = torch.as_tensor(np.asarray(olabel, np.int64)[order], device=device)
        fw = np.asarray(final_weight, np.float64)
        self.final = torch.as_tensor(np.where(np.isfinite(fw), -fw, -np.inf), dtype=dtype,
                                     device=device)
        self.start = int(start)
        self.a_max = A


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def decode(g: Graph, ll: torch.Tensor, lengths, kcap: int, beam: float, low: bool = False,
           tally: dict | None = None):
    """ll (B, T, P) on g's device, in g's dtype -> (words: list of lists of
    word ids, scores: float64 numpy (B,)); low=True rounds every score to
    bfloat16 after each addition.  A `tally` dict gains the frames' live
    candidates, live slots and active rows (utterances inside their
    length), summed over the frames."""
    r = bf16 if low else (lambda t: t)
    B, T, _ = ll.shape
    dev, dt = ll.device, ll.dtype
    lengths = torch.as_tensor(np.asarray(lengths), device=dev)
    st = torch.full((B, kcap), g.start, dtype=torch.int64, device=dev)
    sc = torch.full((B, kcap), -math.inf, dtype=dt, device=dev)
    sc[:, 0] = 0.0
    rows = torch.arange(B, device=dev)[:, None, None]
    slot = torch.arange(kcap, device=dev)[None, :, None].expand(B, kcap, g.a_max)
    backs, arcs = [], []
    live = torch.zeros(3, dtype=torch.int64, device=dev)
    for t in range(T):
        cand = r(r(sc[:, :, None] + g.logp[st]) + ll[rows, t, g.pdf[st]])
        cand, dst, arc = cand.reshape(B, -1), g.dst[st].reshape(B, -1), g.arc[st].reshape(B, -1)
        src_slot = slot.reshape(B, -1)
        # order by (dst asc, score desc, arc asc): stable sorts, last key first
        o = torch.sort(arc, dim=1, stable=True).indices
        o = o.gather(1, torch.sort(cand.gather(1, o), dim=1, descending=True, stable=True).indices)
        o = o.gather(1, torch.sort(dst.gather(1, o), dim=1, stable=True).indices)
        d, v = dst.gather(1, o), cand.gather(1, o)
        best = torch.ones_like(d, dtype=torch.bool)
        best[:, 1:] = d[:, 1:] != d[:, :-1]
        v = torch.where(best, v, -math.inf)
        v = torch.where(v > v.max(dim=1, keepdim=True).values - beam, v, -math.inf)
        top = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :kcap]
        keep = (t < lengths)[:, None]
        nv = v.gather(1, top)
        if tally is not None:
            live[0] += ((cand > -math.inf) & keep).sum()
            live[1] += ((nv > -math.inf) & keep).sum()
            live[2] += keep.sum()
        pick = o.gather(1, top)
        st = torch.where(keep, d.gather(1, top), st)
        sc = torch.where(keep, nv, sc)
        backs.append(src_slot.gather(1, pick))
        arcs.append(torch.where(nv > -math.inf, arc.gather(1, pick), -1))
    if tally is not None:
        for key, n in zip(("live_candidates", "live_slots", "active_rows"), live.tolist()):
            tally[key] = tally.get(key, 0) + n
    total = r(sc + g.final[st])
    none_final = ~(total.max(dim=1).values > -math.inf)
    total = torch.where(none_final[:, None], sc, total)
    k = total.argmax(dim=1)           # the first best slot
    best_score = total.gather(1, k[:, None])[:, 0]
    back = torch.stack(backs).cpu().numpy()          # (T, B, K)
    arc = torch.stack(arcs).cpu().numpy()
    olab = g.olabel.cpu().numpy()
    k = k.cpu().numpy()
    words = []
    for b, n in enumerate(lengths.cpu().numpy()):
        s, out = int(k[b]), []
        for t in range(int(n) - 1, -1, -1):
            a = arc[t, b, s]
            if a >= 0 and olab[a] != 0:
                out.append(int(olab[a]))
            s = back[t, b, s]
        words.append(out[::-1])
    return words, best_score.to(torch.float64).cpu().numpy()
