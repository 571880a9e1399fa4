"""Sequence-parallel attention for long audio, on a process group.

Counterpart of `dsr_tpu/parallel/longctx.py`.  Time is split into
contiguous blocks, one a rank in rank order, over a process group (the
mesh's axis group, `mesh.get_group(axis)`):

  - `ring_attention`: K/V blocks rotate around the ring by point-to-point
    sends while each rank streams flash-style (running max / denominator)
    softmax accumulation over its local Q block — full exact attention,
    O(T/n) activation memory a rank.
  - `ulysses_attention`: an all-to-all re-shards time → heads so each rank
    holds the FULL sequence for H/n heads, computes plain attention, and
    scatters back.  Needs heads % n == 0.
  - `exchange_halo`: each block gains `halo` frames from each neighbour,
    zeros at the sequence's edges.

Both attentions take the Conformer's bucketed relative-position bias with
GLOBAL time indices (each rank knows its offset from its rank in the
group).  `ppermute` is the JAX collective of that name; a group of one rank
is handled by identity, with no self-send.  The products are
`torch.einsum`, as the JAX module computes them outside any kernel.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from dsr_tpu_torch.parallel.sharding import all_gather_dim


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Send `x` along the (source, destination) group-rank pairs of `perm`:
    each rank returns what its source sent, or zeros if no pair ends at
    it.  One batch of point-to-point operations."""
    rank = dist.get_rank(group)
    src = [s for s, d in perm if d == rank]
    dst = [d for s, d in perm if s == rank]
    if src == [rank] and dst == [rank]:
        return x
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = torch.zeros_like(wire)
    ops = [dist.P2POp(dist.isend, wire, dist.get_global_rank(group, d), group) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.dtype)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled `all_to_all`: `split_dim` cut into n blocks, block j sent
    to rank j, the blocks received concatenated along `concat_dim` in rank
    order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    shape = list(x.shape)
    blocks = x.unflatten(split_dim, (n, shape[split_dim] // n)).movedim(split_dim, 0)
    out = torch.empty_like(blocks, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, blocks.contiguous(), group=group)
    # out[j] is rank j's block, laid out as x: put j in front of the concat dimension
    out = out.movedim(0, concat_dim)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return out.reshape(shape)


def relpos_bias_block(bias_table: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
                      max_dist: int) -> torch.Tensor:
    """Bucketed relative-position bias for a (q-block, k-block) pair.

    bias_table: (2*max_dist+1, H); qpos: (Tq,), kpos: (Tk,) global frame
    indices → (H, Tq, Tk).
    """
    rel = torch.clamp(qpos[:, None] - kpos[None, :], -max_dist, max_dist) + max_dist
    return bias_table[rel].permute(2, 0, 1)


def ring_attention(q, k, v, group, bias_table=None, max_dist: int = 128, kv_mask=None):
    """Exact attention with time split over `group`.

    q, k, v: (..., Tl, H, dh) local blocks (global T = n * Tl, contiguous
    blocks in rank order).  bias_table: optional (2*max_dist+1, H) bucketed
    relative-position table.  kv_mask: optional (..., Tl) bool — True =
    valid key frame (rotates with K/V).  Returns (..., Tl, H, dh).
    """
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    Tl, H, dh = q.shape[-3:]
    scale = 1.0 / math.sqrt(dh)
    frames = torch.arange(Tl, device=q.device)
    qpos = rank * Tl + frames
    m = torch.full((*q.shape[:-3], H, Tl), -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    if kv_mask is None:
        kv_mask = torch.ones((*k.shape[:-3], Tl), dtype=torch.bool, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for j in range(n):
        src = (rank - j) % n                     # rank whose K/V block we hold
        logits = torch.einsum("...thd,...shd->...hts", q, k) * scale
        if bias_table is not None:
            logits = logits + relpos_bias_block(bias_table, qpos, src * Tl + frames, max_dist)
        valid = kv_mask[..., None, None, :]
        logits = torch.where(valid, logits, -math.inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # keep -inf rows (fully masked so far) from producing NaNs
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(valid, torch.exp(logits - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.movedim(-2, -1)[..., None] + torch.einsum("...hts,...shd->...thd",
                                                                   p, v)
        m = m_new
        if j < n - 1:
            k, v, kv_mask = (ppermute(t, group, perm) for t in (k, v, kv_mask))
    return acc / torch.clamp_min(l.movedim(-2, -1)[..., None], 1e-30)


def exchange_halo(x, group, halo: int, time_axis: int = -2):
    """Concatenate `halo` boundary frames from each ring neighbour onto a
    time-split tensor: (..., Tl, D) → (..., halo + Tl + halo, D).

    The edge ranks receive zeros, which equals global zero 'SAME' padding,
    so a local VALID convolution over the haloed block reproduces the
    unsplit SAME convolution exactly."""
    n = dist.get_world_size(group)
    Tl = x.shape[time_axis]
    fwd = [(i, i + 1) for i in range(n - 1)]   # rank r receives from r-1
    bwd = [(i + 1, i) for i in range(n - 1)]   # rank r receives from r+1
    left = ppermute(x.narrow(time_axis, Tl - halo, halo), group, fwd)
    right = ppermute(x.narrow(time_axis, 0, halo), group, bwd)
    return torch.cat([left, x, right], dim=time_axis)


def ulysses_attention(q, k, v, group, bias_table=None, max_dist: int = 128, kv_mask=None):
    """all_to_all head-scatter attention (DeepSpeed-Ulysses scheme).

    q, k, v: (..., Tl, H, dh) time-split → all_to_all to (..., T, H/n, dh)
    head-split, plain softmax attention with global relative-position
    bias, all_to_all back.  Requires H % group size == 0.
    """
    n = dist.get_world_size(group)
    Tl, H, dh = q.shape[-3:]
    if H % n:
        raise ValueError(f"ulysses_attention: {H} heads do not split over {n} ranks")
    qg, kg, vg = (all_to_all(x, group, -2, -3) for x in (q, k, v))
    T = qg.shape[-3]
    logits = torch.einsum("...thd,...shd->...hts", qg, kg) * (1.0 / math.sqrt(dh))
    if bias_table is not None:
        pos = torch.arange(T, device=q.device)
        hs = H // n
        table = bias_table[:, dist.get_rank(group) * hs:(dist.get_rank(group) + 1) * hs]
        logits = logits + relpos_bias_block(table, pos, pos, max_dist)
    if kv_mask is not None:
        kmg = all_gather_dim(kv_mask, group, kv_mask.dim() - 1)
        logits = torch.where(kmg[..., None, None, :], logits, -1e30)
    out = torch.einsum("...hts,...shd->...thd", torch.softmax(logits, dim=-1), vg)
    return all_to_all(out, group, -3, -2)
