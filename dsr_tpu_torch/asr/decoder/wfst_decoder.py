"""Dense batched WFST Viterbi decoder over packed arc tensors (PyTorch).

Counterpart of `dsr_tpu/asr/decoder/wfst_decoder.py`: EVERY arc is expanded
every frame,

    cand[a]   = score[src[a]] + weight[a] + loglik[t, pdf[a]]
    score'[s] = max over arcs with dst == s        (scatter_reduce "amax")

exact Viterbi with no pruning, and the winning arc per state is the largest
arc id with cand >= score'[dst] - 1e-6, as the JAX package's `.at[].max`
takes it.  The frame loop is a Python loop of tensor operations on the
graph's device; the backpointers ((T, S) int32 per utterance) are copied to
the host once and traced back there.  The top-K token-passing decoders
(`topk_decoder`, `split_decoder`) are the large-vocabulary path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsr_tpu_torch.asr.fsm.packed import PackedGraph
from dsr_tpu_torch.utils.device import resolve

NEG = -1e30


class DeviceGraph(NamedTuple):
    src: torch.Tensor          # (A,) int64
    pdf: torch.Tensor          # (A,) int64
    weight: torch.Tensor       # (A,) float32 log-prob (max-plus)
    dst: torch.Tensor          # (A,) int64
    start: int
    final_weight: torch.Tensor  # (S,) float32 (-inf → NEG)
    num_states: int
    src_host: np.ndarray       # (A,) for the host traceback
    olabel_host: np.ndarray    # (A,) word ids (0 = eps)


def to_device(g: PackedGraph, device=None) -> DeviceGraph:
    """The packed graph's arc tensors on `device` (the card unless "cpu")."""
    dev = resolve(device)
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight, NEG).astype(np.float32)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return DeviceGraph(
        put(g.src, torch.int64), put(g.pdf, torch.int64),
        put(-np.asarray(g.weight, np.float32), torch.float32), put(g.dst, torch.int64),
        int(g.start), put(fin, torch.float32), int(g.num_states),
        np.asarray(g.src, np.int64), np.asarray(g.olabel, np.int64),
    )


def decode_batch(graph: DeviceGraph, loglik: torch.Tensor, lengths=None):
    """loglik (U, T, P), lengths (U,) → (olabels (U, T) int64, arc paths
    (U, T) int64, scores (U,) float32), the first two on the host.
    olabels[u, t] is the word emitted entering frame t's state (0 = eps)."""
    U, T, _ = loglik.shape
    S = graph.num_states
    dev = loglik.device
    lens = (np.full(U, T, np.int64) if lengths is None
            else np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths,
                            np.int64).reshape(U))
    A = graph.src.shape[0]
    arc_ids = torch.arange(A, device=dev)
    dst = graph.dst.expand(U, A)
    scores = torch.full((U, S), NEG, dtype=torch.float32, device=dev)
    scores[:, graph.start] = 0.0
    bps = torch.empty((T, U, S), dtype=torch.int64, device=dev)
    for t in range(T):
        cand = scores[:, graph.src] + graph.weight + loglik[:, t][:, graph.pdf]   # (U, A)
        new = torch.full((U, S), NEG, dtype=torch.float32, device=dev).scatter_reduce(
            1, dst, cand, "amax", include_self=True)
        is_best = cand >= torch.gather(new, 1, dst) - 1e-6
        best_arc = torch.full((U, S), -1, dtype=torch.int64, device=dev).scatter_reduce(
            1, dst, torch.where(is_best, arc_ids, -1), "amax", include_self=True)
        keep = torch.as_tensor(t < lens, device=dev)[:, None]
        scores = torch.where(keep, new, scores)
        bps[t] = torch.where(keep, best_arc, -1)
    total = scores + graph.final_weight
    best = total.amax(dim=1, keepdim=True)
    idx = torch.arange(S, device=dev)
    best_end = torch.where(total == best, idx, S).amin(dim=1)       # ties: lowest state
    # the traceback, on the host after one copy
    bp = bps.cpu().numpy()
    state = best_end.cpu().numpy()
    rows = np.arange(U)
    olabs = np.zeros((U, T), np.int64)
    arcs = np.full((U, T), -1, np.int64)
    for t in range(T - 1, -1, -1):
        arc = bp[t, rows, state]
        valid = (t < lens) & (arc >= 0)
        safe = np.maximum(arc, 0)
        olabs[:, t] = np.where(valid, graph.olabel_host[safe], 0)
        arcs[:, t] = np.where(valid, arc, -1)
        state = np.where(valid, graph.src_host[safe], state)
    return torch.as_tensor(olabs), torch.as_tensor(arcs), best.squeeze(1)


def decode(graph: DeviceGraph, loglik: torch.Tensor, length=None):
    """loglik (T, num_pdfs) → (olabels (T,), arc path (T,), score ()); read
    the word sequence with `words_from_olabels`."""
    olabs, arcs, scores = decode_batch(graph, loglik[None],
                                       None if length is None else [int(length)])
    return olabs[0], arcs[0], scores[0]


def words_from_olabels(olabs, words_table) -> list[str]:
    return [words_table.name(int(o)) for o in olabs if int(o) != 0]
