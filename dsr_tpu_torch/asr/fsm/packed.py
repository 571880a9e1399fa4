"""Freeze a WFST to packed int32/float32 arc arrays for the decoders.

The port's copy of `dsr_tpu/asr/fsm/packed.py`.  The decoders consume flat
arrays in which every arc is emitting (ilabel > 0 = pdf+1); packing
asserts that invariant.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dsr_tpu_torch.asr.fsm.wfst import EPS, Wfst


class PackedGraph(NamedTuple):
    src: np.ndarray      # (A,) int32 arc source state
    pdf: np.ndarray      # (A,) int32 acoustic pdf index (ilabel - 1)
    olabel: np.ndarray   # (A,) int32 word id (0 = eps)
    weight: np.ndarray   # (A,) float32 -log prob
    dst: np.ndarray      # (A,) int32 arc dest state
    start: int
    final_weight: np.ndarray  # (S,) float32 (+inf if non-final)
    num_states: int

    @property
    def num_arcs(self) -> int:
        return len(self.src)


def pack_csr(off, il, ol, w, nxt, start: int, fin) -> PackedGraph:
    """Vectorised pack from CSR arrays (NativeFst.to_csr output) — the
    LVCSR-scale path; `pack` below is the small-graph `Wfst` convenience."""
    off = np.asarray(off, np.int64)
    il = np.asarray(il, np.int32)
    S = len(off) - 1
    if np.any(il == EPS):
        bad = int(np.argmax(il == EPS))
        raise ValueError(
            f"non-emitting arc #{bad} (ilabel=eps); run rmepsilon before packing"
        )
    src = np.repeat(np.arange(S, dtype=np.int32), np.diff(off))
    return PackedGraph(
        src,
        il - 1,
        np.asarray(ol, np.int32),
        np.asarray(w, np.float32),
        np.asarray(nxt, np.int32),
        int(start),
        np.asarray(fin, np.float32),
        S,
    )


def pack(fst: Wfst) -> PackedGraph:
    S = fst.num_states
    src, pdf, ola, wgt, dst = [], [], [], [], []
    for s in range(S):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                raise ValueError(
                    f"non-emitting arc {s}→{a.nextstate} (ilabel=eps, olabel={a.olabel});"
                    " run rmepsilon before packing"
                )
            src.append(s)
            pdf.append(a.ilabel - 1)
            ola.append(a.olabel)
            wgt.append(a.weight)
            dst.append(a.nextstate)
    fin = np.full(S, np.inf, np.float32)
    for s, w in fst.finals.items():
        fin[s] = w
    return PackedGraph(
        np.asarray(src, np.int32),
        np.asarray(pdf, np.int32),
        np.asarray(ola, np.int32),
        np.asarray(wgt, np.float32),
        np.asarray(dst, np.int32),
        fst.start,
        fin,
        S,
    )
