"""Streaming Conformer-CTC (PyTorch): chunked causal inference with
carried state.

Counterpart of `dsr_tpu/models/streaming_conformer.py`:

  - attention is chunk-causal: a query sees every frame of its own
    `chunk` plus `left` whole chunks of left context, served from a
    per-layer cache of the layer input (everything outside attention and
    the depthwise conv is frame-local, so k/v of cached frames are
    recomputed from the cached inputs);
  - the depthwise conv is causal: VALID over a (k−1)-frame carried tail of
    its post-GLU input (offline, a tail of zeros);
  - the 4x subsampler is VALID: subsampled frame t needs raw frames
    4t..4t+6, so `step` n consumes raw chunk n (4·chunk frames) and emits
    attention chunk n−1; `finish` flushes the last chunk − 1 frames.

`forward(feats)` is the offline chunk-causal pass; `init_state`, `step`
and `finish` stream it, and the streamed rows equal the offline ones to
float tolerance.  The JAX `step` has fixed shapes (`where(started, ...)`);
here the state carries `pos` and `started` as host values, the first
`step` only buffers its chunk (it returns `n_new = 0` and zero logits),
and later steps compute what the JAX step keeps.  Single utterance:
feats (T, feat_dim).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsr_tpu_torch.models.conformer import (NEG, FeedForward, _generator, conv, conv_frames,
                                            dense, layer_norm)
from dsr_tpu_torch.parallel import longctx
from dsr_tpu_torch.utils.device import resolve


class StreamState(NamedTuple):
    """The carried streaming state."""
    raw: torch.Tensor             # (4·chunk, D) the previous raw chunk
    xin: list[torch.Tensor]       # per layer (left·chunk, dim) layer-input tail
    conv: list[torch.Tensor]      # per layer (k−1, dim) post-GLU conv tail
    pos: int                      # absolute index of the next emitted frame
    started: bool                 # one raw chunk already buffered


class _ChunkCausalAttention(nn.Module):
    """q from `x`, k/v from `xkv` (one LayerNorm for both: the cached path
    feeds xkv = cache ++ x, so the x rows are normalised identically),
    bucketed relative-position bias, and an `allow` (Tq, Tk) mask."""

    def __init__(self, dim: int, heads: int, max_dist: int = 128, *, device, generator):
        super().__init__()
        self.heads, self.max_dist = heads, max_dist
        self.ln = layer_norm(dim, device)
        self.q, self.k, self.v = (dense(dim, dim // heads * heads, device, generator)
                                  for _ in range(3))
        self.rel_bias = nn.Parameter(torch.zeros(2 * max_dist + 1, heads, device=device))
        self.o = dense(dim // heads * heads, dim, device, generator)

    def forward(self, x, xkv, q_pos, kv_pos, allow):
        h, hkv = self.ln(x), self.ln(xkv)
        q = self.q(h).unflatten(-1, (self.heads, -1))
        k, v = (p(hkv).unflatten(-1, (self.heads, -1)) for p in (self.k, self.v))
        logits = torch.einsum("thd,shd->hts", q, k) / math.sqrt(q.shape[-1])
        logits = logits + longctx.relpos_bias_block(self.rel_bias, q_pos, kv_pos, self.max_dist)
        logits = torch.where(allow[None], logits, NEG)
        out = torch.einsum("hts,shd->thd", torch.softmax(logits, dim=-1), v)
        return self.o(out.flatten(-2))


class StreamingConformerCtc(nn.Module):
    """Chunk-causal Conformer-CTC.  chunk and left are in subsampled frames
    (one = 4 raw frames).  Offline: `forward(feats (T, D))` → (T', vocab+1),
    T' = (T − 7)//4 + 1.  Streaming: `init_state()` → `step(raw (4·chunk,
    D), state)` per raw chunk → `finish(state)` for the tail."""

    def __init__(self, vocab: int, dim: int = 144, layers: int = 4, heads: int = 4,
                 chunk: int = 8, left: int = 2, kernel_size: int = 15, feat_dim: int = 13, *,
                 device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.vocab, self.dim, self.layers = vocab, dim, layers
        self.chunk, self.left, self.kernel_size, self.feat_dim = chunk, left, kernel_size, feat_dim
        d4 = max(dim // 4, 1)
        self.sub1 = conv(nn.Conv2d, 1, d4, 3, device, g, stride=2)
        self.sub2 = conv(nn.Conv2d, d4, d4, 3, device, g, stride=2)
        f_sub = ((feat_dim - 3) // 2 + 1 - 3) // 2 + 1      # the feature axis after 2 VALID convs
        self.sub_out = dense(f_sub * d4, dim, device, g)
        # frame-local normalisation after the subsampler: real-scale MFCCs
        # otherwise ride the residual stream unnormalised
        self.sub_ln = layer_norm(dim, device)
        kw = dict(device=device, generator=g)
        rep = lambda make: nn.ModuleList(make() for _ in range(layers))  # noqa: E731
        self.ff1s = rep(lambda: FeedForward(dim, **kw))
        self.atts = rep(lambda: _ChunkCausalAttention(dim, heads, **kw))
        self.conv_lns = rep(lambda: layer_norm(dim, device))
        self.conv_ins = rep(lambda: dense(dim, 2 * dim, device, g))
        self.conv_dws = rep(lambda: conv(nn.Conv1d, dim, dim, kernel_size, device, g, groups=dim))
        self.conv_post_lns = rep(lambda: layer_norm(dim, device))
        self.conv_outs = rep(lambda: dense(dim, dim, device, g))
        self.ff2s = rep(lambda: FeedForward(dim, **kw))
        self.block_lns = rep(lambda: layer_norm(dim, device))
        self.out = dense(dim, vocab + 1, device, g)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    def _subsample(self, raw):
        h = F.relu(self.sub1(raw[None, None]))
        h = F.relu(self.sub2(h))
        h = h[0].permute(1, 2, 0).flatten(1)        # (C, T', F') → flax's (T', F'·C), C fastest
        return self.sub_ln(self.sub_out(h))

    def _block(self, i, x, kv_tail, conv_tail, q_pos, kv_pos, allow):
        """One block over chunk rows `x`; kv_tail (L, dim) is the cached
        layer input (None offline), conv_tail (k−1, dim) the post-GLU
        history.  Returns (y, this layer's new conv tail)."""
        x1 = x + 0.5 * self.ff1s[i](x)
        if kv_tail is None:
            xkv = x1
        else:
            # cached rows re-derive x1 from the cached layer input
            xkv = torch.cat([kv_tail + 0.5 * self.ff1s[i](kv_tail), x1])
        x2 = x1 + self.atts[i](x1, xkv, q_pos, kv_pos, allow)
        h = F.glu(self.conv_ins[i](self.conv_lns[i](x2)), dim=-1)
        hist = torch.cat([conv_tail, h])
        c = F.silu(self.conv_post_lns[i](conv_frames(self.conv_dws[i], hist)))
        x3 = x2 + self.conv_outs[i](c)
        y = self.block_lns[i](x3 + 0.5 * self.ff2s[i](x3))
        return y, hist[-(self.kernel_size - 1):]

    def forward(self, feats):
        """Offline chunk-causal pass: feats (T, D) → logits (T', vocab+1)."""
        h = self._subsample(feats)
        pos = torch.arange(h.shape[0], device=h.device)
        cq, cs = pos[:, None] // self.chunk, pos[None, :] // self.chunk
        allow = (cs == cq) | ((cq - cs >= 1) & (cq - cs <= self.left))
        tail = torch.zeros((self.kernel_size - 1, self.dim), device=h.device)
        for i in range(self.layers):
            h, _ = self._block(i, h, None, tail, pos, pos, allow)
        return self.out(h)

    def init_state(self) -> StreamState:
        z = lambda n: torch.zeros((n, self.dim), device=self.device)  # noqa: E731
        return StreamState(
            raw=torch.zeros((4 * self.chunk, self.feat_dim), device=self.device),
            xin=[z(self.left * self.chunk) for _ in range(self.layers)],
            conv=[z(self.kernel_size - 1) for _ in range(self.layers)],
            pos=0, started=False)

    def _stream_blocks(self, h, state: StreamState, C: int):
        """The block stack on C chunk rows with the carried caches →
        (logits, new layer-input tails, new conv tails)."""
        L = self.left * self.chunk
        q_pos = state.pos + torch.arange(C, device=h.device)
        kv_pos = torch.cat([state.pos - L + torch.arange(L, device=h.device), q_pos])
        allow = (kv_pos >= 0)[None, :].expand(C, L + C)
        new_xin, new_conv = [], []
        for i in range(self.layers):
            new_xin.append(torch.cat([state.xin[i], h])[-L:] if C < L else h[-L:])
            h, ctail = self._block(i, h, state.xin[i], state.conv[i], q_pos, kv_pos, allow)
            new_conv.append(ctail)
        return self.out(h), new_xin, new_conv

    def step(self, raw_chunk, state: StreamState):
        """raw_chunk (4·chunk, D) → (logits (chunk, V+1), n_new, new state).
        n_new is 0 on the first call (its chunk is only buffered, the
        logits are zeros) and `chunk` afterwards."""
        C = self.chunk
        if not state.started:
            return (torch.zeros((C, self.vocab + 1), device=self.device), 0,
                    state._replace(raw=raw_chunk, started=True))
        window = torch.cat([state.raw, raw_chunk])[:4 * C + 3]
        logits, xin, conv_tails = self._stream_blocks(self._subsample(window), state, C)
        return logits, C, StreamState(raw_chunk, xin, conv_tails, state.pos + C, True)

    def finish(self, state: StreamState):
        """Flush the last buffered chunk → (logits (chunk − 1, V+1), n_new):
        after n steps of 4·chunk raw frames the offline pass has exactly
        chunk − 1 more subsampled frames."""
        C = self.chunk
        logits, _, _ = self._stream_blocks(self._subsample(state.raw), state, C - 1)
        return logits, (C - 1 if state.started else 0)


def greedy_ctc_stream(logits_chunks) -> np.ndarray:
    """Incremental best-path decode over emitted chunks: collapse repeats
    and drop blanks across chunk boundaries (the previous label carried)."""
    out, prev = [], -1
    for lg in logits_chunks:
        for i in torch.as_tensor(lg).argmax(dim=-1).tolist():
            if i != prev and i != 0:
                out.append(i)
            prev = i
    return np.asarray(out, np.int32)
