"""Oversampled DFT analysis/synthesis filterbank (PyTorch).

Counterpart of `dsr_tpu/ops/filterbank.py`, same conventions and layouts:
(..., S) float32 signals, (..., T, M//2+1) complex64 subbands, prototypes
from `utils.design.get_prototypes` (shipped or designed).  On a CUDA
tensor `analysis` and `synthesis` launch the hand-written kernels of
`ops/cuda/filterbank.py` for every config; on a CPU tensor they run the
plain versions beside those kernels, which follow the JAX package's XLA
paths.  `analysis_beamform` is the fused analysis + fixed-weight beamform
of the serving path (the JAX package's
`ops/pallas/filterbank.analysis_beamform`); `stage_for_beamform` and
`analysis_beamform_staged` run it over a bank of signals staged once on
the device, addressed by buffer index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops.cuda import filterbank as _kern
from dsr_tpu_torch.utils import design, profiling
from dsr_tpu_torch.utils.design import get_prototypes
from dsr_tpu_torch.utils.device import resolve

__all__ = ["analysis", "analysis_beamform", "analysis_beamform_staged", "get_prototypes",
           "num_frames", "stage_for_beamform", "synthesis"]


def as_f32(h, device: torch.device) -> torch.Tensor:
    """A prototype (numpy array or tensor) as a contiguous float32 tensor."""
    if isinstance(h, torch.Tensor):
        return h.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(h, np.float32), device=device)


@functools.lru_cache(maxsize=32)
def prototype_tensors(cfg: FilterbankConfig, device: torch.device):
    """The config's (hf, gf) as float32 tensors on `device`, and the delay,
    copied to the device once rather than on every call.  Shared between
    callers: do not write to them."""
    hf, gf, delay = get_prototypes(cfg)
    return as_f32(hf, device), as_f32(gf, device), delay


def num_frames(num_samples: int, cfg: FilterbankConfig) -> int:
    """Frames produced by `analysis` for a signal of `num_samples` samples."""
    return design.num_frames(num_samples, cfg.M, cfg.m, cfg.r)


def analysis(x: torch.Tensor, cfg: FilterbankConfig, hf=None) -> torch.Tensor:
    """Subband analysis: (..., S) real → (..., T, M//2+1) complex64."""
    x = x.to(torch.float32)
    hf = prototype_tensors(cfg, x.device)[0] if hf is None else as_f32(hf, x.device)
    T = num_frames(x.shape[-1], cfg)
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    out = _kern.analysis(flat, hf, cfg.M, cfg.m, cfg.r, T)
    return out.reshape(*x.shape[:-1], T, cfg.num_bins)


def analysis_beamform(x: torch.Tensor, w: torch.Tensor, cfg: FilterbankConfig,
                      hf=None) -> torch.Tensor:
    """Fused subband analysis + fixed-weight beamform.

    x: (C, S) float32 multi-channel signal; w: (K, C) complex weights
    (`apply_weights` convention) → (T, K) complex64 beamformed subbands,
    equal to `apply_weights(analysis(x), w)` without materialising the
    per-channel (C, T, K) subband tensor.  The DS/MVDR serving path.
    """
    x = x.to(torch.float32).contiguous()
    hf = prototype_tensors(cfg, x.device)[0] if hf is None else as_f32(hf, x.device)
    T = num_frames(x.shape[-1], cfg)
    return _kern.analysis_beamform(x, hf, w.to(torch.complex64).contiguous(),
                                   cfg.M, cfg.m, cfg.r, T)


def stage_for_beamform(x, device=None) -> torch.Tensor:
    """Stage (..., C, S) signals once, at ingest, as the bank the fused
    kernel reads: a contiguous float32 (B, C, S) tensor on `device` (the
    card unless "cpu"; a tensor's own device when it is one).  The JAX
    package padded each buffer into its kernel's (C·rows, 128) frame grid
    for a given config; the port's kernel needs no padded grid, so the bank
    is the signals as they are, whatever the config."""
    dev = x.device if isinstance(x, torch.Tensor) and device is None else resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return x.reshape(-1, *x.shape[-2:]).contiguous()


def analysis_beamform_staged(xp: torch.Tensor, idx, w: torch.Tensor, cfg: FilterbankConfig,
                             num_samples: int, hf=None) -> torch.Tensor:
    """Fused analysis + beamform of buffer `idx` of a staged bank.

    xp: `stage_for_beamform`'s (B, C, S) bank; idx: a Python int or a 0-d
    int32 tensor on the bank's device (read by the kernel, the counterpart
    of the TPU kernel's scalar prefetch: a serving loop over the bank needs
    no host readback); w: (K, C) complex weights → (T, K) complex64 for
    T = num_frames(num_samples), equal to `analysis_beamform(xp[idx], w)`
    when num_samples is the bank's S.
    """
    with profiling.scope("filterbank.analysis_beamform"):
        hf = prototype_tensors(cfg, xp.device)[0] if hf is None else as_f32(hf, xp.device)
        return _kern.analysis_beamform_staged(xp, idx, hf, w.to(torch.complex64).contiguous(),
                                              cfg.M, cfg.m, cfg.r, num_frames(num_samples, cfg))


def synthesis(
    A: torch.Tensor,
    cfg: FilterbankConfig,
    out_len: int,
    gf=None,
    delay: int | None = None,
) -> torch.Tensor:
    """Subband synthesis: (..., T, M//2+1) complex → (..., out_len) float32.

    The output starts `delay` samples after the analysis front pad; like the
    JAX package's slice, the start is clamped so that `out_len` samples fit
    in the overlap-added stream.
    """
    with profiling.scope("filterbank.synthesis"):
        A = A.to(torch.complex64)
        if gf is None or delay is None:
            _, gf_, delay_ = prototype_tensors(cfg, A.device)
            gf = gf_ if gf is None else gf
            delay = delay_ if delay is None else delay
        T = A.shape[-2]
        ylen = (T - 1) * cfg.D + cfg.L
        if out_len > ylen:
            raise ValueError(f"out_len={out_len} exceeds the {ylen} samples that {T} frames give")
        start = min(max(cfg.L - cfg.D + int(delay), 0), ylen - out_len)
        flat = A.reshape(-1, T, A.shape[-1]).contiguous()
        y = _kern.synthesis(flat, as_f32(gf, A.device), cfg.M, cfg.m, cfg.r, start, out_len)
        return y.reshape(*A.shape[:-2], out_len)
