"""Batched top-K token-passing WFST decoder (the LVCSR path), PyTorch.

Counterpart of `dsr_tpu/asr/decoder/topk_decoder.py`, its sort path
(`select_mode="xla"`).  Fixed shapes:

  - arcs are padded per state to A_max (CSR → dense (S, A_max) tables,
    int32 and float32, on the decoder's device);
  - per frame, each utterance's K live tokens gather their arc rows and
    score all K·A_max candidates: token score + arc weight + acoustic
    log-likelihood, exact float32 gathers and adds;
  - recombination (best candidate per destination state, ties to the
    smallest arc id), the beam prune and the top-K selection are one call
    of `ops/cuda/select.recombine_topk`: the hand-written kernel for CUDA
    tensors, its plain twin for CPU tensors;
  - backpointers: the (T, K) winning arcs; the traceback copies the token
    tables to the host once and walks them back there.

The utterance axis of `decode_batch` is written out (U rows per call), and
the frame loop is a Python loop.  The selection is always exact, so the
`return_spill` flags are all False.  Dropped TPU workarounds: the one-hot
MXU lookups (`_split_mm`), the chunk-length buckets, and the
`select_mode` / `select_q` / `approx_topk` knobs.

Lattice mode (`nlat > 0`): the select's lattice mode also gives each
surviving token its state's top `nlat` incoming arcs and their path scores
(column 0 the winner), the (T, K, nlat) alt tables that
`asr/decoder/lattice.from_topk` turns into a true lattice; `nlat` is cut
to a_max·kcap as the reference cuts it.

Outputs: token tables stay on the decoder's device; the traceback's
olabels and scores are CPU tensors.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from dsr_tpu_torch.asr.fsm.packed import PackedGraph
from dsr_tpu_torch.ops.cuda.select import recombine_topk
from dsr_tpu_torch.utils.device import resolve

NEG = -1e30


class TokenGraph(NamedTuple):
    pdf: torch.Tensor           # (S, A_max) int32
    olabel: torch.Tensor        # (S, A_max) int32
    weight: torch.Tensor        # (S, A_max) float32 log-prob (NEG where invalid)
    dst: torch.Tensor           # (S, A_max) int32
    start: int
    final_weight: torch.Tensor  # (S,) float32 log-prob (NEG non-final)
    num_states: int
    a_max: int


def build_token_graph(g: PackedGraph, device=None) -> TokenGraph:
    """Pad the packed arcs to (S, A_max) tables on `device` (the card
    unless `device="cpu"`)."""
    dev = resolve(device)
    S = g.num_states
    A = len(g.src)
    counts = np.bincount(g.src, minlength=S).astype(np.int64)
    A_max = max(1, int(counts.max()))
    if S * A_max >= 2**31:
        raise ValueError(f"{S} states x {A_max} arcs overflow the int32 arc ids")
    # per-state slot: stable-sort arcs by src, slot = rank within the run
    order = np.argsort(g.src, kind="stable")
    run_start = np.cumsum(counts) - counts
    rows = g.src[order].astype(np.int64)
    slots = np.arange(A, dtype=np.int64) - run_start[rows]
    pdf = np.zeros((S, A_max), np.int32)
    ola = np.zeros((S, A_max), np.int32)
    wgt = np.full((S, A_max), NEG, np.float32)
    dst = np.zeros((S, A_max), np.int32)
    pdf[rows, slots] = g.pdf[order]
    ola[rows, slots] = g.olabel[order]
    wgt[rows, slots] = -g.weight[order]
    dst[rows, slots] = g.dst[order]
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight, NEG).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return TokenGraph(t(pdf), t(ola), t(wgt), t(dst), int(g.start), t(fin), S, A_max)


def candidates(graph: TokenGraph, states, scores, ll):
    """The K·A_max candidate arcs of each utterance's tokens: states and
    scores (U, K), ll (U, P) → (scores, dst, arc ids), each (U, K·A_max)."""
    U = states.shape[0]
    rows = torch.arange(U, device=states.device)[:, None, None]
    cand = scores[:, :, None] + graph.weight[states] + ll[rows, graph.pdf[states]]
    slot = torch.arange(graph.a_max, dtype=torch.int32, device=states.device)
    arcs = states[:, :, None] * graph.a_max + slot
    return cand.reshape(U, -1), graph.dst[states].reshape(U, -1), arcs.reshape(U, -1)


def token_pass(expand, ll, lengths, states, scores, beam, kcap: int, nlat: int = 0):
    """The frame loop shared by the dense and degree-split decoders.

    expand(states, scores, ll_t) → (cand, dst, arcs[, extra]) gives the
    (U, N) candidates of one frame; ll (U, T, P); lengths: host ints (U,),
    frames t >= length pass the carry through with arc -1.  Returns
    (states, scores) after the last frame, the (T, U, K) token tables
    (states, arcs, scores), the per-frame extras (a list, one per frame)
    and, when nlat > 0, the (T, U, K, nlat) alt tables (arcs, scores), else
    None; frames t >= length hold arc -1 and score NEG there.
    """
    U, T = ll.shape[:2]
    dev = ll.device
    lengths = np.asarray(lengths)
    beam_t = torch.full((U,), float(beam), dtype=torch.float32, device=dev)
    tok_states = torch.empty((T, U, kcap), dtype=torch.int32, device=dev)
    tok_arcs = torch.empty((T, U, kcap), dtype=torch.int32, device=dev)
    tok_scores = torch.empty((T, U, kcap), dtype=torch.float32, device=dev)
    alts = None
    if nlat:
        alts = (torch.empty((T, U, kcap, nlat), dtype=torch.int32, device=dev),
                torch.empty((T, U, kcap, nlat), dtype=torch.float32, device=dev))
    extras = []
    for t in range(T):
        cand, dst, arcs, *extra = expand(states, scores, ll[:, t])
        extras.append(extra)
        new_scores, new_states, new_arcs, *alt = recombine_topk(cand, dst, arcs, beam_t, kcap,
                                                                nlat)
        # the select writes dead slots as (score <= NEG/2, dst 0, arc -1)
        if t >= lengths.min():   # some utterance has ended: carry passes through
            keep = torch.as_tensor(t < lengths, device=dev)[:, None]
            new_states = torch.where(keep, new_states, states)
            new_scores = torch.where(keep, new_scores, scores)
            new_arcs = torch.where(keep, new_arcs, -1)
            alt = [torch.where(keep[..., None], a, fill) for a, fill in zip(alt, (NEG, -1))]
        states, scores = new_states, new_scores
        tok_states[t], tok_arcs[t], tok_scores[t] = states, new_arcs, scores
        if nlat:   # the select gives (scores, arcs); the tables are (arcs, scores)
            alts[1][t], alts[0][t] = alt
    return states, scores, tok_states, tok_arcs, tok_scores, extras, alts


def _best_final(states_f: np.ndarray, scores_f: np.ndarray, final_f: np.ndarray):
    """(best state, best score) per utterance from the final carry
    (U, K) and its states' final weights final_f (U, K): score + final
    weight, or, when no token reaches a final state (an utterance cut
    mid-word), the best token without it."""
    total = scores_f + final_f
    dead = ~(total.max(axis=1) > NEG / 2)
    total[dead] = scores_f[dead]
    slot = np.argmax(total, axis=1)
    rows = np.arange(len(slot))
    return states_f[rows, slot], total[rows, slot]


def _backtrack(tok_states: np.ndarray, tok_arcs: np.ndarray, best_state: np.ndarray,
               lengths, source_of) -> tuple[np.ndarray, np.ndarray]:
    """Walk the (T, U, K) token tables back from each utterance's best
    state → (arcs (T, U), valid (T, U)).  At frame t the token holding the
    current state (its first slot; slot 0 if none does) gives the arc;
    it is followed while t < length and the arc is >= 0, and
    source_of(arcs) maps arc ids to their source states."""
    T, U, _ = tok_states.shape
    lengths = np.full(U, T) if lengths is None else np.asarray(lengths)
    state = best_state.copy()
    rows = np.arange(U)
    arcs = np.zeros((T, U), np.int64)
    valid = np.zeros((T, U), bool)
    for t in range(T - 1, -1, -1):
        slot = np.argmax(tok_states[t] == state[:, None], axis=1)
        arc = tok_arcs[t, rows, slot].astype(np.int64)
        ok = (t < lengths) & (arc >= 0)
        arcs[t] = np.maximum(arc, 0)
        valid[t] = ok
        state = np.where(ok, source_of(np.maximum(arc, 0)), state)
    return arcs, valid


def traceback_lookups(tok_states, tok_arcs, states_f, scores_f, lengths, source_of, final_of,
                      olabel_of):
    """The traceback of every top-K decoder: the (T, U, K) token tables and
    the final carry (U, K) → (olabels (U, T), scores (U,)), CPU tensors.
    final_of(states) and olabel_of(arcs) look up the final weights of
    states and the olabels of arc ids given as tensors on the carry's
    device; source_of maps host arc ids to their source states.  The token
    tables come to the host once, and no whole graph table is copied."""
    best_state, best_score = _best_final(states_f.cpu().numpy(), scores_f.cpu().numpy(),
                                         final_of(states_f).cpu().numpy())
    arcs, valid = _backtrack(tok_states.cpu().numpy(), tok_arcs.cpu().numpy(), best_state,
                             lengths, source_of)
    dev = states_f.device
    olabs = torch.where(torch.as_tensor(valid, device=dev),
                        olabel_of(torch.as_tensor(arcs, device=dev)), 0)
    return olabs.T.contiguous().cpu(), torch.from_numpy(best_score)


def traceback_tables(graph, tok_states, tok_arcs, states_f, scores_f, lengths, source_of):
    """The traceback of the dense and split decoders, over the graph's own
    final-weight and olabel tables (`traceback_lookups`)."""
    return traceback_lookups(tok_states, tok_arcs, states_f, scores_f, lengths, source_of,
                             lambda s: graph.final_weight[s],
                             lambda a: graph.olabel.reshape(-1)[a])


def _traceback(graph: TokenGraph, tok_states, tok_arcs, states_f, scores_f, lengths):
    return traceback_tables(graph, tok_states, tok_arcs, states_f, scores_f, lengths,
                            lambda a: a // graph.a_max)


def start_tokens(graph, U: int, kcap: int):
    """The initial (states, scores) (U, kcap): the start-state token in slot
    0 of each utterance, dead slots elsewhere."""
    dev = graph.weight.device
    states = torch.zeros((U, kcap), dtype=torch.int32, device=dev)
    scores = torch.full((U, kcap), NEG, dtype=torch.float32, device=dev)
    states[:, 0] = graph.start
    scores[:, 0] = 0.0
    return states, scores


def _logliks(graph: TokenGraph, loglik) -> torch.Tensor:
    return torch.as_tensor(loglik, dtype=torch.float32, device=graph.weight.device)


def stream_start(graph: TokenGraph, kcap: int = 256):
    """Initial streaming carry: the start-state token."""
    states, scores = start_tokens(graph, 1, min(kcap, graph.num_states))
    return states[0], scores[0]


def decode_chunk(graph: TokenGraph, loglik, carry, kcap: int = 256, beam: float = 1e9,
                 nlat: int = 0, return_spill: bool = False):
    """Streaming decode of one chunk of frames, loglik (T, P).

    carry = (states (K,), scores (K,)) from `stream_start` or the previous
    chunk.  Returns (new_carry, (tok_states, tok_arcs, tok_scores
    [, alt_arcs, alt_scores][, spill])), each (T, K) ((T, K, nlat) for the
    alt tables when nlat > 0, (T,) for spill, all False): accumulate the
    tables and run `traceback` at the utterance's end; the result is
    identical to the whole-utterance decode (the carry is the decoder's
    only state), the alt tables included."""
    kcap = min(kcap, graph.num_states)
    nlat = min(nlat, graph.a_max * kcap)
    ll = _logliks(graph, loglik)
    T = ll.shape[0]
    states, scores, ts, ta, tsc, _, alts = token_pass(
        partial(candidates, graph), ll[None], [T], carry[0][None], carry[1][None], beam, kcap,
        nlat)
    outs = (ts[:, 0], ta[:, 0], tsc[:, 0])
    if nlat:
        outs = outs + (alts[0][:, 0], alts[1][:, 0])
    if return_spill:
        outs = outs + (torch.zeros(T, dtype=torch.bool, device=ll.device),)
    return (states[0], scores[0]), outs


def traceback(graph: TokenGraph, tok_states, tok_arcs, carry):
    """Utterance-final traceback over accumulated (possibly concatenated)
    streaming token tables (T, K) → (olabels (T,), score)."""
    states_f, scores_f = carry
    olabs, score = _traceback(graph, tok_states[:, None], tok_arcs[:, None],
                              states_f[None], scores_f[None], None)
    return olabs[0], score[0]


def decode_with_tokens(graph: TokenGraph, loglik, kcap: int = 256, beam: float = 1e9,
                       length=None, nlat: int = 0, return_spill: bool = False):
    """Full decode of loglik (T, P) returning the token tables:
    (olabels (T,), score, tok_states (T, K), tok_arcs (T, K),
    tok_scores (T, K)) [+ alt_arcs (T, K, nlat), alt_scores (T, K, nlat)
    when nlat > 0: each surviving token's top-nlat incoming arcs with their
    path scores, the lattice's links] [+ spill (T,), all False, when
    return_spill, always last]."""
    ll = _logliks(graph, loglik)
    T = ll.shape[0]
    length = T if length is None else int(length)
    kcap = min(kcap, graph.num_states)
    nlat = min(nlat, graph.a_max * kcap)
    states, scores = start_tokens(graph, 1, kcap)
    sf, scf, ts, ta, tsc, _, alts = token_pass(partial(candidates, graph), ll[None], [length],
                                               states, scores, beam, kcap, nlat)
    olabs, score = _traceback(graph, ts, ta, sf, scf, [length])
    out = (olabs[0], score[0], ts[:, 0], ta[:, 0], tsc[:, 0])
    if nlat:
        out = out + (alts[0][:, 0], alts[1][:, 0])
    if return_spill:
        out = out + (torch.zeros(T, dtype=torch.bool, device=ll.device),)
    return out


def decode(graph: TokenGraph, loglik, kcap: int = 256, beam: float = 1e9, length=None):
    """loglik (T, P) → (olabels (T,), score ()).  0-olabels are epsilon."""
    out = decode_with_tokens(graph, loglik, kcap, beam, length)
    return out[0], out[1]


def decode_batch(graph: TokenGraph, loglik, lengths, kcap: int = 256, beam: float = 1e9,
                 return_spill: bool = False):
    """loglik (U, T, P), lengths (U,) → (olabels (U, T), scores (U,)
    [, spill (U, T), all False]): the U utterances go through each frame's
    select together."""
    ll = _logliks(graph, loglik)
    U, T = ll.shape[:2]
    lengths = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths,
                         np.int64).reshape(U)
    kcap = min(kcap, graph.num_states)
    states, scores = start_tokens(graph, U, kcap)
    sf, scf, ts, ta, _, _, _ = token_pass(partial(candidates, graph), ll, lengths, states,
                                          scores, beam, kcap)
    olabs, best = _traceback(graph, ts, ta, sf, scf, lengths)
    if return_spill:
        return olabs, best, torch.zeros((U, T), dtype=torch.bool, device=ll.device)
    return olabs, best
