"""Conformer-CTC acoustic model (PyTorch) — BASELINE.json config 5.

Counterpart of `dsr_tpu/models/conformer.py`: a 4x strided-conv
subsampler, Conformer blocks (half-step feed-forwards, self-attention with
a bucketed relative-position bias, a depthwise-conv module), a CTC head
with blank 0, the CTC loss and the greedy and prefix-beam decodes.
Attention is the explicit matmul, bias, mask (−1e30), softmax, matmul of
the JAX module.

Parameters are created on the model's device (the card unless the caller
names another) and initialised as flax initialises them: Dense and conv
kernels `lecun_normal`, biases and the relative-position table zero,
LayerNorm scales one.  The values come from a CPU `torch.Generator`, so a
model built on the card and one built on the CPU from the same seed hold
the same numbers.

Long audio: with a process group `sp_group` (time split into contiguous
blocks, one a rank) the attention is the parallel layer's exact
`ring_attention` and the depthwise conv exchanges halo frames with the
ring neighbours (`parallel/longctx.py`).  The subsampler is strided, so
time is split after it: run the blocks, not `ConformerCtc`, on the blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsr_tpu_torch.parallel import longctx
from dsr_tpu_torch.utils.device import resolve

NEG = -1e30
LN_EPS = 1e-6          # flax's LayerNorm epsilon (torch's default is 1e-5)


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def lecun_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's `lecun_normal`: a normal truncated at ±2σ with σ =
    sqrt(1/fan_in) / 0.8796 (the truncation's own std).  Drawn on the CPU
    by the inverse CDF of float64 uniforms, not `nn.init.trunc_normal_`,
    whose numbers for one generator differ between torch releases."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    e = math.erf(math.sqrt(2.0))                        # erf(2 / √2): the ±2σ cut
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv((2.0 * u - 1.0) * e)
    with torch.no_grad():
        w.copy_(std * x.clamp(-2.0, 2.0))


def dense(fan_in: int, out: int, device, generator) -> nn.Linear:
    m = nn.utils.skip_init(nn.Linear, fan_in, out, device=device)
    lecun_(m.weight, fan_in, generator)
    nn.init.zeros_(m.bias)
    return m


def conv(cls, cin: int, cout: int, kernel, device, generator, **kw):
    """A `Conv1d` / `Conv2d` initialised as flax's `nn.Conv` (fan_in =
    kernel elements x cin / groups)."""
    m = nn.utils.skip_init(cls, cin, cout, kernel, device=device, **kw)
    lecun_(m.weight, m.weight[0].numel(), generator)
    nn.init.zeros_(m.bias)
    return m


def layer_norm(dim: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


def conv_frames(c: nn.Conv1d, h: torch.Tensor) -> torch.Tensor:
    """A `Conv1d` over the time axis of (..., T, C)."""
    lead, (T, C) = h.shape[:-2], h.shape[-2:]
    y = c(h.reshape(-1, T, C).transpose(1, 2)).transpose(1, 2)
    return y.reshape(*lead, *y.shape[-2:])


class FeedForward(nn.Module):
    """LayerNorm → Dense(mult·dim) → swish → Dense(dim).  (The JAX module's
    dropout is 0 wherever it is built, so it is not ported.)"""

    def __init__(self, dim: int, mult: int = 4, *, device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.ln = layer_norm(dim, device)
        self.up = dense(dim, dim * mult, device, g)
        self.down = dense(dim * mult, dim, device, g)

    def forward(self, x):
        return self.down(F.silu(self.up(self.ln(x))))


class RelPosSelfAttention(nn.Module):
    """Multi-head self-attention with a bucketed relative-position bias;
    `mask` (..., T) marks the valid key frames."""

    def __init__(self, dim: int, heads: int = 4, max_dist: int = 128, sp_group=None, *,
                 device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.heads, self.max_dist, self.sp_group = heads, max_dist, sp_group
        self.ln = layer_norm(dim, device)
        # flax's DenseGeneral kernels (dim, H, dh) as Linear(dim, H·dh)
        self.q, self.k, self.v = (dense(dim, dim // heads * heads, device, g)
                                  for _ in range(3))
        self.rel_bias = nn.Parameter(torch.zeros(2 * max_dist + 1, heads, device=device))
        self.o = dense(dim // heads * heads, dim, device, g)

    def forward(self, x, mask=None):
        T = x.shape[-2]
        h = self.ln(x)
        q, k, v = (p(h).unflatten(-1, (self.heads, -1)) for p in (self.q, self.k, self.v))
        if self.sp_group is not None:
            out = longctx.ring_attention(q, k, v, self.sp_group, self.rel_bias, self.max_dist,
                                         kv_mask=mask)
            return self.o(out.flatten(-2))
        dh = q.shape[-1]
        logits = torch.einsum("...thd,...shd->...hts", q, k) / math.sqrt(dh)
        pos = torch.arange(T, device=x.device)
        logits = logits + longctx.relpos_bias_block(self.rel_bias, pos, pos, self.max_dist)
        if mask is not None:
            logits = torch.where(mask[..., None, None, :], logits, NEG)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("...hts,...shd->...thd", attn, v)
        return self.o(out.flatten(-2))


class ConvModule(nn.Module):
    """LayerNorm → Dense(2·dim) → GLU → depthwise conv (SAME) → LayerNorm
    (the JAX module's stand-in for batchnorm) → swish → Dense(dim)."""

    def __init__(self, dim: int, kernel_size: int = 15, sp_group=None, *, device=None,
                 generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.kernel_size, self.sp_group = kernel_size, sp_group
        self.ln = layer_norm(dim, device)
        self.pw_in = dense(dim, 2 * dim, device, g)
        self.dw = conv(nn.Conv1d, dim, dim, kernel_size, device, g, groups=dim)
        self.post_ln = layer_norm(dim, device)
        self.pw_out = dense(dim, dim, device, g)

    def forward(self, x):
        h = F.glu(self.pw_in(self.ln(x)), dim=-1)
        half = self.kernel_size // 2
        if self.sp_group is not None:
            # global SAME zero padding == halo frames from the ring
            # neighbours (zeros at the sequence's edges), then VALID
            h = longctx.exchange_halo(h, self.sp_group, half)
        else:
            h = F.pad(h, (0, 0, half, half))
        h = F.silu(self.post_ln(conv_frames(self.dw, h)))
        return self.pw_out(h)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, sp_group=None, *, device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        kw = dict(device=device, generator=g)
        self.ff1 = FeedForward(dim, **kw)
        self.att = RelPosSelfAttention(dim, heads, sp_group=sp_group, **kw)
        self.conv = ConvModule(dim, sp_group=sp_group, **kw)
        self.ff2 = FeedForward(dim, **kw)
        self.ln = layer_norm(dim, device)

    def forward(self, x, mask=None):
        x = x + 0.5 * self.ff1(x)
        x = x + self.att(x, mask)
        x = x + self.conv(x)
        x = x + 0.5 * self.ff2(x)
        return self.ln(x)


def _same_pad(n: int) -> tuple[int, int]:
    """XLA's SAME padding of one axis for kernel 3, stride 2: total
    max((ceil(n/2) − 1)·2 + 3 − n, 0), the smaller half before ((0, 1) for
    even n, (1, 1) for odd; torch's symmetric padding=1 would shift even
    lengths by a sample)."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def _same_conv(conv2d: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    (t0, t1), (f0, f1) = _same_pad(h.shape[-2]), _same_pad(h.shape[-1])
    return conv2d(F.pad(h, (f0, f1, t0, t1)))


class ConformerCtc(nn.Module):
    """features (…, T, feat_dim) → CTC logits (…, ceil(T/4), vocab+1), blank 0.

    `feat_dim` sizes the Dense after the subsampler (flax infers it from
    the first input)."""

    def __init__(self, vocab: int, dim: int = 144, layers: int = 4, heads: int = 4,
                 feat_dim: int = 13, *, device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        d4 = dim // 4
        self.sub1 = conv(nn.Conv2d, 1, d4, 3, device, g, stride=2)
        self.sub2 = conv(nn.Conv2d, d4, d4, 3, device, g, stride=2)
        f_sub = math.ceil(math.ceil(feat_dim / 2) / 2)      # the feature axis after 2 SAME convs
        self.sub_out = dense(f_sub * d4, dim, device, g)
        self.blocks = nn.ModuleList(ConformerBlock(dim, heads, device=device, generator=g)
                                    for _ in range(layers))
        self.out = dense(dim, vocab + 1, device, g)

    def forward(self, feats, mask=None):
        lead, (T, D) = feats.shape[:-2], feats.shape[-2:]
        h = F.relu(_same_conv(self.sub1, feats.reshape(-1, 1, T, D)))
        h = F.relu(_same_conv(self.sub2, h))
        # (N, C, T', F') → flax's (N, T', F', C), flattened with C fastest
        h = h.permute(0, 2, 3, 1).flatten(2)
        h = self.sub_out(h.reshape(*lead, *h.shape[1:]))
        sub_mask = None
        if mask is not None:
            sub_mask = mask[..., ::2][..., ::2][..., :h.shape[-2]]
        for blk in self.blocks:
            h = blk(h, sub_mask)
        return self.out(h)


def ctc_loss(logits, logit_lens, labels, label_lens) -> torch.Tensor:
    """Mean over the batch of each sequence's CTC negative log-likelihood:
    logits (B, T, V+1) with blank 0, labels (B, L) padded.  (torch's
    `reduction="mean"` would divide each loss by its label length first;
    optax's loss, the JAX package's, does not.)"""
    dev = logits.device
    lp = F.log_softmax(logits, dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(lp, torch.as_tensor(labels, dtype=torch.long, device=dev),
                         torch.as_tensor(logit_lens, dtype=torch.long, device=dev),
                         torch.as_tensor(label_lens, dtype=torch.long, device=dev),
                         blank=0, reduction="none")
    return per_seq.mean()


def greedy_ctc_decode(logits, length=None) -> np.ndarray:
    """Best-path decode: collapse repeats, drop blanks (id 0)."""
    out, prev = [], -1
    for t, i in enumerate(torch.as_tensor(logits).argmax(dim=-1).tolist()):
        if length is not None and t >= length:
            break
        if i != prev and i != 0:
            out.append(i)
        prev = i
    return np.asarray(out, np.int32)


def _lse(a, b):
    m = torch.maximum(a, b)
    live = m > NEG / 2
    ms = torch.where(live, m, 0.0)
    return torch.where(live, ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms)), NEG)


def beam_ctc_decode(logits, beam: int = 8, length=None, lm_logprobs=None,
                    lm_weight: float = 0.3, bonus: float = 0.0, max_len: int = 64):
    """CTC prefix beam search with optional n-gram shallow fusion, the JAX
    package's fixed-width contract: every frame scores all beam·(V+1)
    extensions (column 0 = stay on the prefix through a blank or a repeat
    of its last label; a repeated label only extends across a blank) and
    keeps the top `beam`, equal scores in index order as `lax.top_k`
    keeps them.  Prefixes are not merged across parents; a prefix of
    `max_len` labels only stays.  Frames from `length` on change nothing.

    lm_logprobs: (V+1, V+1), [prev, c] = log P(c | prev), row and column 0
    the start / blank sentinel; each emitted label adds `lm_weight ·
    lm[last, c] + bonus`.  A frame loop of tensor ops on the logits'
    device.  Returns (ids (np int32, ≤ max_len), total log-probability)."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    dev = logits.device
    T, V1 = logits.shape
    logp = F.log_softmax(logits, dim=-1)
    lm = (torch.zeros((V1, V1), device=dev) if lm_logprobs is None else
          torch.as_tensor(np.asarray(lm_logprobs, np.float32), device=dev))
    n = T if length is None else min(int(length), T)
    prefixes = torch.zeros((beam, max_len), dtype=torch.long, device=dev)
    lens = torch.zeros(beam, dtype=torch.long, device=dev)
    last = torch.zeros(beam, dtype=torch.long, device=dev)     # 0 = <s>/blank sentinel
    pb = torch.full((beam,), NEG, device=dev)
    pb[0] = 0.0
    pnb = torch.full((beam,), NEG, device=dev)
    labels = torch.arange(1, V1, device=dev)
    rows = torch.arange(beam, device=dev)
    for t in range(n):
        lp = logp[t]
        tot = _lse(pb, pnb)
        pb_stay = tot + lp[0]
        pnb_stay = pnb + lp[last]
        stay_tot = _lse(pb_stay, pnb_stay)
        base = torch.where(labels[None, :] == last[:, None], pb[:, None], tot[:, None])
        base = torch.where((lens < max_len)[:, None], base, NEG)
        ext = base + lp[1:][None, :] + lm_weight * lm[last, 1:] + bonus
        scores = torch.cat([stay_tot[:, None], ext], dim=1).flatten()
        top, idx = torch.sort(scores, descending=True, stable=True)
        top, idx = top[:beam], idx[:beam]
        parent, col = idx // V1, idx % V1
        stay = col == 0
        new_prefixes = prefixes[parent]
        ext_prefixes = new_prefixes.clone()
        ext_prefixes[rows, lens[parent].clamp(0, max_len - 1)] = col
        prefixes = torch.where(stay[:, None], new_prefixes, ext_prefixes)
        lens = torch.where(stay, lens[parent], lens[parent] + 1)
        last = torch.where(stay, last[parent], col)
        pb = torch.where(stay, pb_stay[parent], NEG)
        pnb = torch.where(stay, pnb_stay[parent], top)
    total = _lse(pb, pnb)
    b = int(total.argmax())
    ids = prefixes[b, :int(lens[b])].to(torch.int32).cpu().numpy()
    return ids, float(total[b])
