"""Graph-sharded WFST decoding over the `model` mesh axis (config 4).

Counterpart of `dsr_tpu/parallel/decoder.py`.  The HCLG's dense (S, A_max)
arc tables are split by state range over the ranks of `model`
(`shard_token_graph` builds one rank's rows straight from the packed
arcs, on the host, and places only those on its device: no rank ever
holds the whole tables).  Active tokens are replicated over the graph
shards; each frame every shard

  1. expands only the tokens whose SOURCE state it owns (the others get
     NEG arc weights),
  2. recombines, beam-prunes and keeps its top kcap through the select
     kernel (`ops/cuda/select.recombine_topk`, its plain twin on CPU
     tensors),
  3. all-gathers the (score, dst, arc) triples of every shard over
     `model`, as one int32 plane with the scores' bits (an id's bits never
     pass through a float path),

and the frame loop's own select (`topk_decoder.token_pass`) merges the
n_model·kcap gathered candidates.  So the select runs twice a frame.
Utterances ride the `data` axis: each data rank decodes its block and the
outputs are all-gathered at the end.

Exactness: equal to the single-device top-K decode, token for token.  The
global best candidate for any destination state is made on exactly one
shard (the owner of its source state), where it outranks every candidate
it beats globally, so it survives that shard's top kcap; the local beam
threshold is never above the global one (the local maximum is never above
the global maximum); and every candidate is the same float32 sum
(score + weight + log-likelihood) as in `topk_decoder.candidates`.

The traceback runs on the host from the token tables; the final weights
and the traced arcs' olabels come from their owner shards, merged by one
all-reduce MAX over `model` each.

`simulate_sharded_kernel_decode` runs the same arithmetic for n shards in
one process on one device: the shards ride the select's utterance axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.asr.decoder.topk_decoder import NEG, TokenGraph, token_pass
from dsr_tpu_torch.asr.fsm.packed import PackedGraph
from dsr_tpu_torch.ops.cuda.select import recombine_topk
from dsr_tpu_torch.parallel import sharding
from dsr_tpu_torch.parallel.mesh import axis_size, mesh_device
from dsr_tpu_torch.utils.device import resolve


class GraphShard(NamedTuple):
    """Rows [offset, offset + rows) of the dense token tables."""
    pdf: torch.Tensor           # (rows, A_max) int32
    olabel: torch.Tensor        # (rows, A_max) int32
    weight: torch.Tensor        # (rows, A_max) float32 log-prob (NEG where invalid)
    dst: torch.Tensor           # (rows, A_max) int32
    final_weight: torch.Tensor  # (rows,) float32 log-prob (NEG non-final)
    offset: int
    rows: int
    start: int
    a_max: int                  # of the whole graph


def _check_arc_ids(states: int, a_max: int) -> None:
    if states * a_max >= 2**31:
        raise ValueError(f"{states} states x {a_max} arcs overflow the int32 arc ids")


def pad_token_graph_states(g: TokenGraph, shards: int) -> TokenGraph:
    """Pad S to a multiple of `shards` so state ranges split evenly: rows
    beyond S get weight NEG, dst, pdf and olabel 0 and final weight NEG."""
    S = g.num_states
    pad = -S % shards
    if pad == 0:
        return g
    rows = lambda t, v: F.pad(t, (0, 0, 0, pad), value=v)  # noqa: E731
    return TokenGraph(rows(g.pdf, 0), rows(g.olabel, 0), rows(g.weight, NEG), rows(g.dst, 0),
                      g.start, F.pad(g.final_weight, (0, pad), value=NEG), S + pad, g.a_max)


def shard_token_graph(g: PackedGraph, rank: int, n: int, device=None) -> GraphShard:
    """Rank `rank` of `n`'s rows of the dense token tables, built on the host
    from the packed arcs with `topk_decoder.build_token_graph`'s slot order
    (each state's arcs in their packed order) and placed on `device` (the
    card unless `device="cpu"`).  Each shard has ceil(S/n) rows; those
    beyond S are padding (no arcs, not final).  The host holds one plane
    of the shard at a time."""
    dev = resolve(device)
    S = g.num_states
    rows = -(-S // n)
    lo, hi = rank * rows, min((rank + 1) * rows, S)
    counts = np.bincount(g.src, minlength=S)
    a_max = max(1, int(counts.max()))
    _check_arc_ids(n * rows, a_max)
    sel = np.flatnonzero((g.src >= lo) & (g.src < hi))
    order = sel[np.argsort(g.src[sel], kind="stable")]
    del sel
    r = g.src[order].astype(np.int64) - lo
    run = counts[lo:hi]
    slots = np.arange(len(order), dtype=np.int64) - (np.cumsum(run) - run)[r]

    def plane(values, fill, dtype):
        host = np.full((rows, a_max), fill, dtype)
        host[r, slots] = values[order]
        return torch.from_numpy(host).to(dev)

    fin = np.full(rows, NEG, np.float32)
    fw = g.final_weight[lo:hi]
    fin[:hi - lo] = np.where(np.isfinite(fw), -fw, NEG)
    return GraphShard(plane(g.pdf, 0, np.int32), plane(g.olabel, 0, np.int32),
                      plane(-g.weight, NEG, np.float32), plane(g.dst, 0, np.int32),
                      torch.from_numpy(fin).to(dev), lo, rows, int(g.start), a_max)


def _owned(shard: GraphShard, states: torch.Tensor):
    """(mine, local row clamped into the shard) of global states."""
    local = states - shard.offset
    return (local >= 0) & (local < shard.rows), local.clamp(0, shard.rows - 1)


def make_sharded_decode(mesh: DeviceMesh, graph: PackedGraph, kcap: int = 256,
                        beam: float = 1e9, return_tokens: bool = False):
    """Build the sharded decode: (loglik (U, T, P), lengths (U,)) →
    (olabels (U, T) int32, scores (U,) float32, spill_frames (U,) int32),
    CPU tensors, on every rank [+ the token tables (tok_states, tok_arcs,
    tok_scores), each (U, T, kcap), on this rank's device, when
    `return_tokens`].

    Every rank passes the same global batch; each data rank decodes its
    contiguous block of U / data utterances (U must be a multiple of the
    data size).  The arc tables are split over `model` by state range and
    placed once, here.  spill_frames is all zeros: the select is exact.
    """
    axis = sharding.ARCS[0]
    n_model = axis_size(mesh, axis)
    n_data = axis_size(mesh, "data")
    group = mesh.get_group(axis)
    dev = mesh_device(mesh)
    shard = shard_token_graph(graph, mesh.get_local_rank(axis), n_model, dev)
    kcap = min(kcap, graph.num_states)
    A = shard.a_max
    slot = torch.arange(A, dtype=torch.int32, device=dev)

    def final_of(states):
        mine, li = _owned(shard, states)
        f = torch.where(mine, shard.final_weight[li], NEG)
        dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
        return f

    def olabel_of(arcs):
        mine, li = _owned(shard, arcs // A)
        o = torch.where(mine, shard.olabel[li, arcs % A], -1)
        dist.all_reduce(o, op=dist.ReduceOp.MAX, group=group)
        return o

    def run(loglik, lengths):
        ll = torch.as_tensor(loglik, dtype=torch.float32)
        U = ll.shape[0]
        if U % n_data:
            raise ValueError(f"make_sharded_decode: {U} utterances do not split over "
                             f"{n_data} data ranks")
        lens = torch.as_tensor(np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                                          else lengths, np.int64).reshape(U))
        ll = sharding.local_block(ll, mesh, sharding.SCORES).to(dev)
        lens = sharding.local_block(lens, mesh, sharding.SCORES).numpy()
        Ul = ll.shape[0]
        utt = torch.arange(Ul, device=dev)[:, None, None]
        beam_t = torch.full((Ul,), float(beam), dtype=torch.float32, device=dev)

        def expand(states, scores, ll_t):
            mine, li = _owned(shard, states)
            w = torch.where(mine[..., None], shard.weight[li], NEG)
            cand = scores[:, :, None] + w + ll_t[utt, shard.pdf[li]]
            arcs = states[:, :, None] * A + slot
            v, d, a = recombine_topk(cand.reshape(Ul, -1), shard.dst[li].reshape(Ul, -1),
                                     arcs.reshape(Ul, -1), beam_t, kcap)
            plane = torch.stack([v.view(torch.int32), d, a])               # (3, Ul, kcap)
            every = sharding.all_gather_dim(plane, group, 0).view(n_model, 3, Ul, kcap)
            merged = every.permute(1, 2, 0, 3).reshape(3, Ul, n_model * kcap)
            return merged[0].view(torch.float32), merged[1], merged[2]

        states, scores = tk.start_tokens(shard, Ul, kcap)
        sf, scf, ts, ta, tsc, _, _ = token_pass(expand, ll, lens, states, scores, beam, kcap)
        olabs, best = tk.traceback_lookups(ts, ta, sf, scf, lens, lambda a: a // A, final_of,
                                           olabel_of)
        gather = lambda x, spec: sharding.gather_block(x.to(dev), mesh, spec)  # noqa: E731
        out = (gather(olabs, sharding.TOKENS).cpu(), gather(best, sharding.SCORES).cpu(),
               torch.zeros(U, dtype=torch.int32))
        if return_tokens:
            out += tuple(gather(x.transpose(0, 1), sharding.TOKENS) for x in (ts, ta, tsc))
        return out

    return run


def simulate_sharded_kernel_decode(graph: TokenGraph, loglik, n_shards: int, kcap: int = 128,
                                   beam: float = 1e9, return_tokens: bool = False):
    """The sharded frame loop for `n_shards` shards in one process on the
    graph's device: the shards ride the select's utterance axis, so every
    frame is one local select over n_shards rows (each shard's own
    candidates) and one merge select over the n_shards·kcap survivors.

    loglik: (T, P) one utterance.  Returns (olabels (T,), score,
    spill_count = 0) [+ (tok_states, tok_arcs, tok_scores), each (T, kcap),
    when `return_tokens`]."""
    g = pad_token_graph_states(graph, n_shards)
    _check_arc_ids(g.num_states, g.a_max)
    rows, A = g.num_states // n_shards, g.a_max
    dev = g.weight.device
    ll = torch.as_tensor(loglik, dtype=torch.float32, device=dev)
    T = ll.shape[0]
    kcap = min(kcap, graph.num_states)
    offs = torch.arange(n_shards, dtype=torch.int32, device=dev)[:, None] * rows
    slot = torch.arange(A, dtype=torch.int32, device=dev)
    beam_n = torch.full((n_shards,), float(beam), dtype=torch.float32, device=dev)

    def expand(states, scores, ll_t):
        local = states - offs                                          # (n_shards, kcap)
        mine = (local >= 0) & (local < rows)
        li = local.clamp(0, rows - 1) + offs
        w = torch.where(mine[..., None], g.weight[li], NEG)
        cand = scores[:, :, None] + w + ll_t[0][g.pdf[li]]
        arcs = (states * A)[:, :, None] + slot
        v, d, a = recombine_topk(cand.reshape(n_shards, -1), g.dst[li].reshape(n_shards, -1),
                                 arcs.reshape(1, -1).repeat(n_shards, 1), beam_n, kcap)
        return v.reshape(1, -1), d.reshape(1, -1), a.reshape(1, -1)

    states, scores = tk.start_tokens(g, 1, kcap)
    sf, scf, ts, ta, tsc, _, _ = token_pass(expand, ll[None], [T], states, scores, beam, kcap)
    olabs, score = tk.traceback_tables(g, ts, ta, sf, scf, [T], lambda a: a // A)
    out = (olabs[0], float(score[0]), 0)
    if return_tokens:
        out += (ts[:, 0], ta[:, 0], tsc[:, 0])
    return out
