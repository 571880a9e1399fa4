"""Forced-alignment paths: state-level Viterbi alignments for training and
adaptation, with their segmentations (PyTorch).

Counterpart of `dsr_tpu/asr/path.py`.  On CUDA tensors a linear chain (the
alignment graphs of `SmallVocabTask` and `PhoneTask`) goes to the banded
Viterbi kernel (`ops/cuda/viterbi.py`), as the JAX package sends it to its
Pallas kernel off the CPU; on the CPU, and for any graph that is not a
chain, it runs the dense `viterbi`.  The two break exact-score ties
differently (banded: to the self loop; dense: to the lowest previous state,
the advance), so the card's and the CPU's alignments can differ at such a
tie, as the JAX package's do between its TPU and its CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import viterbi as vit
from dsr_tpu_torch.ops.cuda import viterbi as cvit

NEG = -1e30


def _is_linear_chain(A: np.ndarray, init: np.ndarray, final: np.ndarray) -> bool:
    """True iff the graph is a strict left-to-right chain (self + advance
    only, start at 0, final at the last state) — the banded kernel's
    structure.  Host-side O(L²) check on the numpy graph."""
    L = A.shape[0]
    off = np.asarray(A, np.float64).copy()
    np.fill_diagonal(off, NEG)
    if L > 1:
        off[np.arange(L - 1), np.arange(1, L)] = NEG
    return (
        bool(np.all(off <= NEG / 2))
        and init[0] > NEG / 2 and bool(np.all(init[1:] <= NEG / 2))
        and final[L - 1] > NEG / 2 and bool(np.all(final[:-1] <= NEG / 2))
    )


@dataclass
class Alignment:
    states: np.ndarray        # (T,) global pdf/state ids
    score: float
    segments: list            # [(unit_id, start_frame, end_frame)]


def force_align(task, params: gmm.GmmParams, feats, words: list[str]) -> Alignment:
    """Viterbi forced alignment of one utterance against its transcript, on
    the device of `params`.  `task` provides align_graph(words) → (ids,
    logA, init, final), as `SmallVocabTask` and `PhoneTask` do."""
    ids, A, init, final = task.align_graph(words)
    dev = params.means.device
    ll = gmm.loglik(params, torch.as_tensor(np.array(feats, np.float32), device=dev))
    ll_graph = ll[:, torch.as_tensor(ids, dtype=torch.int64, device=dev)].contiguous()
    if dev.type == "cuda" and _is_linear_chain(A, init, final):
        L = len(ids)
        self_lp = torch.as_tensor(np.diag(A).astype(np.float32), device=dev)
        adv_lp = torch.as_tensor(np.concatenate([[np.float32(NEG)], np.diag(A, 1)])
                                 .astype(np.float32), device=dev)
        path, score = cvit.banded_path(ll_graph, self_lp, adv_lp)
        score = np.float32(score) + np.float32(init[0]) + np.float32(final[L - 1])
    else:
        path, score = vit.viterbi(ll_graph, np.asarray(A, np.float32),
                                  np.asarray(init, np.float32), np.asarray(final, np.float32))
        path = path.cpu().numpy()
    gpath = np.asarray(ids)[path]
    # segment boundaries: runs of equal graph POSITION (not state id)
    segs = []
    start = 0
    for t in range(1, len(path) + 1):
        if t == len(path) or path[t] != path[t - 1]:
            segs.append((int(gpath[start]), start, t))
            start = t
    return Alignment(gpath, float(score), segs)
