"""Degree-split top-K decoder, PyTorch.

Counterpart of `dsr_tpu/asr/decoder/split_decoder.py`.  The dense
`TokenGraph` pads every state's arc row to A_max while the mean out-degree
is far lower (2.4 on the monophone LVCSR HCLG, max 47), so most of the
dense candidate pool is padding.  This variant packs arcs two-tier:

  - a (S, a0) main table: every state's first a0 arcs;
  - an overflow table of a0-arc group rows for the states with more; a
    token on such a state expands its extra groups through a fixed
    per-frame budget of `eg` group slots, assigned by prefix sum over the
    live tokens in their order from the previous selection.

Candidates per frame: (kcap + eg)·a0 (2,304 at kcap 256, eg 896, a0 2,
against the dense table's 12,032).  When a frame's demand exceeds the
budget, the highest-indexed tokens' extra groups are dropped first (the
tokens are score-sorted, so the weakest lose them) and the frame counts in
`overflow_frames`; it is not an error, as in the JAX package.  Identical
to the dense decoder whenever no frame overflows.

Arc ids are uniform row·a0 + slot over [main rows | overflow rows], kept in
int32 tables (the JAX package packed ids into float32 planes, exact only
below 2^24; here the build asserts that (S + G)·a0 fits int32).  The
selection is the exact `ops/cuda/select.recombine_topk`, so
`spill_frames` is always 0.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from dsr_tpu_torch.asr.decoder.topk_decoder import (
    NEG, _logliks, start_tokens, token_pass, traceback_tables,
)
from dsr_tpu_torch.asr.fsm.packed import PackedGraph
from dsr_tpu_torch.utils.device import resolve

A0 = 8


class SplitTokenGraph(NamedTuple):
    weight: torch.Tensor      # (S, a0) float32 main-table arc log-probs (NEG where invalid)
    pdf: torch.Tensor         # (S, a0) int32
    dst: torch.Tensor         # (S, a0) int32
    ov_base: torch.Tensor     # (S,) int32 first overflow group of each state
    ov_count: torch.Tensor    # (S,) int32 overflow groups of each state
    ov_weight: torch.Tensor   # (max(G, 1), a0) float32 per overflow group
    ov_pdf: torch.Tensor      # (max(G, 1), a0) int32
    ov_dst: torch.Tensor      # (max(G, 1), a0) int32
    olabel: torch.Tensor      # ((S + G)·a0,) int32 by uniform arc id
    src_of_row: torch.Tensor  # (S + G,) int32 source state per table row
    start: int
    final_weight: torch.Tensor
    num_states: int
    num_groups: int
    a0: int = A0


def build_split_graph(g: PackedGraph, a0: int = A0, device=None) -> SplitTokenGraph:
    """Pack two-tier with a main width of `a0`, on `device` (the card
    unless `device="cpu"`)."""
    dev = resolve(device)
    S = g.num_states
    A = len(g.src)
    counts = np.bincount(g.src, minlength=S).astype(np.int64)
    order = np.argsort(g.src, kind="stable")
    run_start = np.cumsum(counts) - counts
    rows = g.src[order].astype(np.int64)
    slots = np.arange(A, dtype=np.int64) - run_start[rows]

    main = slots < a0
    w_m = np.full((S, a0), NEG, np.float32)
    p_m = np.zeros((S, a0), np.int32)
    d_m = np.zeros((S, a0), np.int32)
    o_m = np.zeros((S, a0), np.int32)
    w_m[rows[main], slots[main]] = -g.weight[order][main]
    p_m[rows[main], slots[main]] = g.pdf[order][main]
    d_m[rows[main], slots[main]] = g.dst[order][main]
    o_m[rows[main], slots[main]] = g.olabel[order][main]

    # overflow groups: ceil((deg - a0)/a0) per high-degree state, packed
    extra = np.maximum(counts - a0, 0)
    ngrp = -(-extra // a0)
    ov_base = np.zeros(S, np.int64)
    ov_base[1:] = np.cumsum(ngrp)[:-1]
    G = int(ngrp.sum())
    if (S + G) * a0 >= 2**31:
        raise ValueError(f"{S} states + {G} overflow groups at a0={a0} overflow "
                         "the int32 arc ids")
    w_o = np.full((max(G, 1), a0), NEG, np.float32)
    p_o = np.zeros((max(G, 1), a0), np.int32)
    d_o = np.zeros((max(G, 1), a0), np.int32)
    o_o = np.zeros((max(G, 1), a0), np.int32)
    ext = ~main
    es = slots[ext] - a0
    erow = ov_base[rows[ext]] + es // a0
    eslot = es % a0
    w_o[erow, eslot] = -g.weight[order][ext]
    p_o[erow, eslot] = g.pdf[order][ext]
    d_o[erow, eslot] = g.dst[order][ext]
    o_o[erow, eslot] = g.olabel[order][ext]

    grp_state = np.repeat(np.arange(S, dtype=np.int64), ngrp)
    src_of_row = np.concatenate([np.arange(S, dtype=np.int64), grp_state]).astype(np.int32)
    olabel = np.concatenate([o_m, o_o[:G]], axis=0).reshape(-1).astype(np.int32)
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight, NEG).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return SplitTokenGraph(
        t(w_m), t(p_m), t(d_m), t(ov_base.astype(np.int32)), t(ngrp.astype(np.int32)),
        t(w_o), t(p_o), t(d_o), t(olabel), t(src_of_row), int(g.start), t(fin), S, G, a0)


def candidates(graph: SplitTokenGraph, states, scores, ll, eg: int):
    """The (K + eg)·a0 candidates of each utterance's tokens: the main rows
    of its K tokens and up to `eg` overflow group rows → (scores, dst, arc
    ids, overflow (U,) bool)."""
    U, K = states.shape
    dev = states.device
    a0 = graph.a0
    # ---- ragged overflow groups → eg dense slots --------------------------
    ovc = torch.where(scores > NEG / 2, graph.ov_count[states], 0)
    incl = torch.cumsum(ovc, dim=1, dtype=torch.int32)
    pref = incl - ovc                                            # exclusive
    overflow = incl[:, -1] > eg
    slots_e = torch.arange(eg, dtype=torch.int32, device=dev).expand(U, eg).contiguous()
    # slot e belongs to token t_e = #{k: pref_k <= e} - 1
    t_e = torch.searchsorted(pref, slots_e, right=True) - 1
    j_e = slots_e - pref.gather(1, t_e)
    valid_e = j_e < ovc.gather(1, t_e)
    ovb_e = graph.ov_base[states].gather(1, t_e)
    grow = torch.clamp(ovb_e + j_e, 0, max(graph.num_groups - 1, 0))
    w_e = torch.where(valid_e[:, :, None], graph.ov_weight[grow], NEG)
    # ---- unified (K + eg, a0) candidate block ------------------------------
    w_all = torch.cat([graph.weight[states], w_e], dim=1)
    pdf_all = torch.cat([graph.pdf[states], graph.ov_pdf[grow]], dim=1)
    dst_all = torch.cat([graph.dst[states], graph.ov_dst[grow]], dim=1)
    base = torch.cat([scores, scores.gather(1, t_e)], dim=1)
    row_id = torch.cat([states, graph.num_states + grow], dim=1)
    rows = torch.arange(U, device=dev)[:, None, None]
    cand = base[:, :, None] + w_all + ll[rows, pdf_all]
    slot = torch.arange(a0, dtype=torch.int32, device=dev)
    arcs = row_id[:, :, None] * a0 + slot
    return cand.reshape(U, -1), dst_all.reshape(U, -1), arcs.reshape(U, -1), overflow


def decode_batch_split(graph: SplitTokenGraph, loglik, lengths, kcap: int = 256,
                       beam: float = 1e9, eg: int = 256):
    """Batched degree-split decode: loglik (U, T, P), lengths (U,) →
    (olabels (U, T), scores (U,), spill_frames (U,), overflow_frames (U,))."""
    ll = _logliks(graph, loglik)
    U, T = ll.shape[:2]
    lengths = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths,
                         np.int64).reshape(U)
    kcap = min(kcap, graph.num_states)
    states, scores = start_tokens(graph, U, kcap)
    sf, scf, ts, ta, _, extras, _ = token_pass(partial(candidates, graph, eg=eg), ll,
                                               lengths, states, scores, beam, kcap)
    # a frame counts as overflowed only while the utterance is running
    ovf = torch.stack([x[0] for x in extras]).cpu().numpy()          # (T, U)
    ovf_frames = (ovf & (np.arange(T)[:, None] < lengths[None, :])).sum(axis=0)
    olabs, best_score = traceback_tables(graph, ts, ta, sf, scf, lengths,
                                         (graph.a0, graph.src_of_row))
    return (olabs, best_score, torch.zeros(U, dtype=torch.int64),
            torch.from_numpy(ovf_frames.astype(np.int64)))


def overflow_budget(graph: SplitTokenGraph, kcap: int) -> int:
    """The most overflow group rows `kcap` live tokens can ask for in one
    frame (the sum of the kcap largest per-state group counts): an `eg` of
    this size never overflows."""
    k = min(kcap, graph.num_states)
    return max(int(torch.topk(graph.ov_count.cpu(), k).values.sum()), 1)


def decode_split(graph: SplitTokenGraph, loglik, kcap: int = 256, beam: float = 1e9,
                 length=None, eg: int = 256):
    """Degree-split decode of one utterance: loglik (T, P) → (olabels (T,),
    score, spill_frames, overflow_frames).

    The default `eg` is the reference's 256 group rows, which a graph with
    high out-degree states can overrun: an overflowed frame drops the
    weakest tokens' extra arcs (on the triphone graph, the arcs at word
    ends) and counts in `overflow_frames`, with no error.  A caller sizes
    `eg` from its graph (`overflow_budget`, or the demand it measured) and
    checks that count."""
    ll = _logliks(graph, loglik)
    T = ll.shape[0]
    out = decode_batch_split(graph, ll[None], [T if length is None else int(length)],
                             kcap=kcap, beam=beam, eg=eg)
    return tuple(o[0] for o in out)
