"""Triphone context-dependency: the C transducer and triphone HCLG.

The port's copy of `dsr_tpu/asr/triphone.py`: the context-dependency
transducer C and the tied-state triphone pipeline over `DistribTree`,
composed by the port's native WFST core (a missing core raises its build
error, as everywhere in the port).

C (delayed-emission convention): consuming output phone r from state
(l, c) emits input symbol tri(l, c, r) — "phone c in context l _ r" — and
moves to (c, r).  Boundary contexts are modelled as 'sil' (every utterance
in this task begins/ends in silence); pending phones are flushed by final
arcs tri(l, c, sil).  Disambiguation symbols pass through as self-loops.

Full graph:  HCLG_tri = rmeps( H_tri ∘ det(rmeps(C ∘ det(rmeps(L ∘ G)))) )
with H_tri mapping pdf sequences (tree-tied) to triphone symbols.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from dsr_tpu_torch.asr.fsm import native as _native
from dsr_tpu_torch.asr.fsm.hclg import SymbolTable, build_lg_fst
from dsr_tpu_torch.asr.fsm.packed import pack_csr
from dsr_tpu_torch.asr.fsm.wfst import EPS, Wfst
from dsr_tpu_torch.asr.tree import DistribTree


@dataclass
class TriphoneTable:
    """Dense triphone-symbol ids: tri(l, c, r) with phones 1..P (+1 offset
    base id 1; disambig symbols follow at P³·... + k)."""

    num_phones: int

    def tri(self, l: int, c: int, r: int) -> int:
        P = self.num_phones
        return 1 + ((l - 1) * P + (c - 1)) * P + (r - 1)

    def untri(self, sym: int) -> tuple[int, int, int]:
        P = self.num_phones
        s = sym - 1
        return s // (P * P) + 1, (s // P) % P + 1, s % P + 1

    @property
    def num_tri(self) -> int:
        return self.num_phones**3

    def disambig(self, k: int) -> int:
        return 1 + self.num_tri + (k - 1)


def build_context_fst(phones: SymbolTable, num_disambig: int,
                      sil_name: str = "sil") -> tuple[Wfst, TriphoneTable]:
    """C: triphone symbols → phones (delayed emission, sil boundaries)."""
    P = len(phones) - 1
    tbl = TriphoneTable(P)
    sil = phones[sil_name]
    # Convention: state (l, c) has phone c PENDING (not yet emitted as a
    # triphone), with left context l; a dedicated start state has nothing
    # pending, so the first phone produces no spurious triphone.
    C = Wfst()
    idx = {}
    start = C.add_state()
    C.set_start(start)
    final = C.add_state()
    C.set_final(final, 0.0)

    def st2(l, c):
        if (l, c) not in idx:
            idx[(l, c)] = C.add_state()
        return idx[(l, c)]

    for r in range(1, P + 1):
        # first phone r becomes pending with left context sil
        C.add_arc(start, EPS, r, 0.0, st2(sil, r))
    # empty string accepted
    C.set_final(start, 0.0)
    for (l, c) in [(l, c) for l in range(1, P + 1) for c in range(1, P + 1)]:
        s = st2(l, c)
        for r in range(1, P + 1):
            C.add_arc(s, tbl.tri(l, c, r), r, 0.0, st2(c, r))
        # flush pending phone with right context sil
        C.add_arc(s, tbl.tri(l, c, sil), EPS, 0.0, final)
    # disambiguation pass-through on every context state (and start)
    for k in range(1, num_disambig + 1):
        dis_in = tbl.disambig(k)
        dis_out = P + k
        C.add_arc(start, dis_in, dis_out, 0.0, start)
        for s in idx.values():
            C.add_arc(s, dis_in, dis_out, 0.0, s)
    return C, tbl


def build_hmm_fst_tri(
    tbl: TriphoneTable,
    tree: DistribTree,
    phones: SymbolTable,
    num_disambig: int,
    states_per_phone: int = 2,
    self_lp: float = math.log(0.6),
    seen_tris: set | None = None,
) -> Wfst:
    """H_tri: tied-pdf sequences → triphone symbols (self-loop topology).

    Input labels are pdf+1 with pdf = tree.lookup(l, c, r, pos).  Only
    triphone symbols in `seen_tris` (or all P³ if None) get chains — the
    composed CLG only contains a small subset, so pass its symbol set.
    """
    adv = math.log1p(-math.exp(self_lp))
    H = Wfst()
    loop = H.add_state()
    H.set_start(loop)
    H.set_final(loop, 0.0)
    tris = seen_tris if seen_tris is not None else range(1, tbl.num_tri + 1)
    for sym in tris:
        l, c, r = tbl.untri(sym)
        cur = loop
        for k in range(states_per_phone):
            pdf = tree.lookup(phones.name(l), phones.name(c), phones.name(r), k)
            nxt = H.add_state()
            H.add_arc(cur, pdf + 1, sym if k == 0 else EPS, 0.0 if k == 0 else -adv, nxt)
            H.add_arc(nxt, pdf + 1, EPS, -self_lp, nxt)
            cur = nxt
        H.add_arc(cur, EPS, EPS, -adv, loop)
    for k in range(1, num_disambig + 1):
        H.add_arc(loop, EPS, tbl.disambig(k), 0.0, loop)
    return H


def compose_hclg_tri(L: Wfst, G: Wfst, phones: SymbolTable, tree: DistribTree,
                     num_disambig: int, states_per_phone: int = 2) -> Wfst:
    """Full triphone decoding graph (see module docstring)."""
    LG = L.compose(G).rmepsilon().determinize()
    C, tbl = build_context_fst(phones, num_disambig)
    CLG = C.compose(LG).rmepsilon().determinize().rmepsilon_input()
    seen = {a.ilabel for lst in CLG.arcs for a in lst
            if 1 <= a.ilabel <= tbl.num_tri}
    H = build_hmm_fst_tri(tbl, tree, phones, num_disambig, states_per_phone,
                          seen_tris=sorted(seen))
    HCLG = H.compose(CLG).rmepsilon().connect()
    HCLG.arcsort("ilabel")
    return HCLG


def build_clg_native(lexicon, phones: SymbolTable, words: SymbolTable, G: Wfst,
                     sil_phone: str = "sil"):
    """CLG through the native core: LG (late word labels) → det → C∘ →
    rmeps.  Returns (native CLG handle, TriphoneTable, seen triphone ids)
    — the caller builds a DistribTree (analytic or data-driven) over
    `seen`, then calls `finish_tri_hclg_native`.  Caller owns/frees the
    returned handle (finish_tri_hclg_native frees it)."""
    LG = build_lg_fst(lexicon, phones, words, G, sil_phone=sil_phone)
    nLG = _native.NativeFst.from_wfst(LG)
    nLGd = nLG.determinize()
    nLG.free()
    C, tbl = build_context_fst(phones, 0, sil_name=sil_phone)
    nC = _native.NativeFst.from_wfst(C)
    nCLG = nC.compose(nLGd)
    nC.free()
    nLGd.free()
    nCLGr = nCLG.rmepsilon()
    nCLG.free()
    _, il, _, _, _, _, _ = nCLGr.to_csr()
    seen = sorted({int(x) for x in np.unique(il) if 1 <= x <= tbl.num_tri})
    return nCLGr, tbl, seen


def finish_tri_hclg_native(nCLGr, tbl: TriphoneTable, tree: DistribTree,
                           phones: SymbolTable, states_per_phone: int,
                           seen_tris=None):
    """H_tri(tree) ∘ CLG → rmeps → packed CSR.  Frees `nCLGr`.
    Returns (PackedGraph, stats dict)."""
    H = build_hmm_fst_tri(tbl, tree, phones, 0, states_per_phone,
                          seen_tris=seen_tris)
    nH = _native.NativeFst.from_wfst(H)
    nHCLG = nH.compose(nCLGr)
    nH.free()
    nCLGr.free()
    nOut = nHCLG.rmepsilon()
    nHCLG.free()
    stats = {
        "num_states": nOut.num_states, "num_arcs": nOut.num_arcs,
        "max_outdeg": nOut.max_outdeg, "tied_pdfs": tree.num_leaves,
    }
    off, il, ol, w, nxt, start, fin = nOut.to_csr()
    nOut.free()
    return pack_csr(off, il, ol, w, nxt, start, fin), stats


def context_of_alignment(alignment_segments, phone_seq_len: int, states_per_phone: int):
    """Frame-level (phone_index_in_seq, hmm_pos) pairs from `path.Alignment`
    segments whose unit ids are monophone pdfs (phone-1)*spp + pos.

    Returns a list of (pi, pos) per frame, where pi indexes the utterance's
    phone sequence (segments appear in order; consecutive segments with the
    same phone advance `pi` only when pos resets).
    """
    frames = []
    for seg_idx, (unit, s, e) in enumerate(alignment_segments):
        # the linear alignment graph visits exactly spp states per phone
        pi = seg_idx // states_per_phone
        pos = unit % states_per_phone
        for _ in range(s, e):
            frames.append((min(pi, phone_seq_len - 1), pos))
    return frames
