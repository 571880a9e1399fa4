"""Filterbank kernels for Hopper, their plain PyTorch twins, and wrappers.

Counterpart of `dsr_tpu/ops/pallas/filterbank.py`.  Three CUDA kernels,
each D-parametric, so one kernel serves every (M, m, r) where the TPU had
a D == 128 kernel and a general one, all on one mixed-radix Stockham FFT
(`csrc/fft.cuh`): the analysis and the fused analysis + fixed-weight
beamform, a real FFT of each folded frame (`csrc/analysis.cu`: several
frames a block at small M; the fused kernel splits a tile's channels over
a thread-block cluster), and the synthesis, an inverse real FFT of each
frame and the overlap-add as a gather (`csrc/filterbank.cu`: tiles of
frames in shared memory, or every frame through device memory when a tile
does not fit).  The sources say what bounds each kernel on the card and
how its design answers that.  The fused kernel also runs over a
staged bank of B signals (`analysis_beamform_staged`), with the buffer's
index an int or read from device memory.

Each wrapper dispatches on the device of the tensor it is given: on a CPU
tensor it runs the plain version (torch.fft, `index_add_`, einsum), on a
CUDA tensor it launches the kernel and adds one to `launches[<name>]`, or
raises.  There is no fallback from the kernel to the plain version.

The wrappers take the kernels' own layout: 2-D float32 signals (C, S),
complex64 spectra (C, T, K), prototypes as float32 tensors on the same
device.  `dsr_tpu_torch.ops.filterbank` holds the config-level API.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

# Kernel launches since the last `reset_launches()`, by kernel.
launches = {"analysis": 0, "analysis_beamform": 0, "analysis_beamform_staged": 0,
            "synthesis": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------- plain twins


def analysis_plain(x: torch.Tensor, hf: torch.Tensor, M: int, r: int, T: int) -> torch.Tensor:
    """(..., S) real → (..., T, M//2+1) complex; the XLA path of
    `dsr_tpu.ops.filterbank._analysis_impl`."""
    L = hf.shape[-1]
    D = M // r
    P = L - D
    S = x.shape[-1]
    xp = torch.nn.functional.pad(x, (P, (T - 1) * D + L - P - S))
    frames = xp.unfold(-1, L, D)                               # (..., T, L)
    u = (frames * hf).reshape(*frames.shape[:-1], L // M, M).sum(-2)
    return torch.fft.rfft(u, dim=-1)


def analysis_beamform_plain(x: torch.Tensor, hf: torch.Tensor, w: torch.Tensor,
                            M: int, r: int, T: int) -> torch.Tensor:
    """(C, S), w (K, C) → (T, K): `apply_weights(analysis(x), w)`."""
    return torch.einsum("kn,ntk->tk", w.conj(), analysis_plain(x, hf, M, r, T))


def synthesis_plain(A: torch.Tensor, gf: torch.Tensor, M: int, r: int, start: int,
                    out_len: int) -> torch.Tensor:
    """(..., T, K) complex → (..., out_len) real; the XLA path of
    `dsr_tpu.ops.filterbank._synthesis_impl`, with the overlap-add as
    `index_add_`.  Output sample j is padded-stream sample start + j."""
    L = gf.shape[-1]
    D = M // r
    T = A.shape[-2]
    v = torch.fft.irfft(A, n=M, dim=-1)                        # (..., T, M)
    tile = torch.arange(L, device=A.device) % M
    frames = gf * v[..., tile]                                 # (..., T, L)
    idx = (torch.arange(T, device=A.device)[:, None] * D
           + torch.arange(L, device=A.device)[None, :]).reshape(-1)
    lead = frames.shape[:-2]
    y = torch.zeros((*lead, (T - 1) * D + L), dtype=frames.dtype, device=A.device)
    y.index_add_(y.ndim - 1, idx, frames.reshape(*lead, T * L))
    return y[..., start:start + out_len]


# -------------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _analysis_kernel() -> ctypes.CDLL:
    lib = build.library("analysis")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsr_fb_analysis_scratch.argtypes = [i, i, i, i, i, p]
    lib.dsr_fb_analysis.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.dsr_fb_analysis_beamform_scratch.argtypes = [i, i, i, i, i, p]
    lib.dsr_fb_analysis_beamform.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dsr_fb_analysis_beamform_staged.argtypes = [p, p, i, i, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.dsr_fb_analysis_scratch, lib.dsr_fb_analysis,
               lib.dsr_fb_analysis_beamform_scratch, lib.dsr_fb_analysis_beamform,
               lib.dsr_fb_analysis_beamform_staged):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    lib = build.library("filterbank")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dsr_fb_synthesis_scratch.argtypes = [i, i, i, i, ll, i, p]
    lib.dsr_fb_synthesis.argtypes = [p, p, p, p, i, i, i, i, i, ll, i, p]
    for fn in (lib.dsr_fb_synthesis_scratch, lib.dsr_fb_synthesis):
        fn.restype = ctypes.c_int
    return lib


def _scratch(query, name: str, device: torch.device, C: int, T: int, M: int, m: int,
             r: int) -> torch.Tensor | None:
    """The device memory a kernel's FFTs need (M above 32,768, where a block
    cannot hold one), or None."""
    nbytes = ctypes.c_longlong()
    _raise_on(query(C, T, M, m, M // r, ctypes.byref(nbytes)), name, M, m, r)
    return torch.empty(nbytes.value, dtype=torch.uint8, device=device) if nbytes.value else None


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, name: str, M: int, m: int, r: int) -> None:
    if rc == -1:
        raise ValueError(f"{name}: the config M={M} m={m} r={r} needs more shared memory "
                         "per block than this card has, even in the smallest layout")
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {rc}")


def analysis(x: torch.Tensor, hf: torch.Tensor, M: int, m: int, r: int, T: int) -> torch.Tensor:
    """x (C, S) float32, hf (m·M,) float32 → (C, T, M//2+1) complex64."""
    if not on_cuda("analysis", x, hf):
        return analysis_plain(x, hf, M, r, T)
    C, S = x.shape
    K, D = M // 2 + 1, M // r
    check("analysis x", x, torch.float32, (C, S))
    check("analysis hf", hf, torch.float32, (m * M,))
    out = torch.empty((C, T, K), dtype=torch.complex64, device=x.device)
    if out.numel() == 0:
        return out
    lib = _analysis_kernel()
    scratch = _scratch(lib.dsr_fb_analysis_scratch, "analysis", x.device, C, T, M, m, r)
    rc = lib.dsr_fb_analysis(x.data_ptr(), hf.data_ptr(), out.data_ptr(), _ptr(scratch),
                             C, S, T, M, m, D, stream())
    _raise_on(rc, "analysis", M, m, r)
    launches["analysis"] += 1
    return out


def analysis_beamform(x: torch.Tensor, hf: torch.Tensor, w: torch.Tensor,
                             M: int, m: int, r: int, T: int) -> torch.Tensor:
    """x (C, S) float32, hf (m·M,) float32, w (K, C) complex64 → (T, K)
    complex64, equal to `apply_weights(analysis(x), w)`."""
    if not on_cuda("analysis_beamform", x, hf, w):
        return analysis_beamform_plain(x, hf, w, M, r, T)
    C, S = x.shape
    K, D = M // 2 + 1, M // r
    check("analysis_beamform x", x, torch.float32, (C, S))
    check("analysis_beamform hf", hf, torch.float32, (m * M,))
    check("analysis_beamform w", w, torch.complex64, (K, C))
    y = torch.empty((T, K), dtype=torch.complex64, device=x.device)
    if C == 0:
        return y.zero_()
    lib = _analysis_kernel()
    scratch = _scratch(lib.dsr_fb_analysis_beamform_scratch, "analysis_beamform", x.device,
                       C, T, M, m, r)
    rc = lib.dsr_fb_analysis_beamform(x.data_ptr(), hf.data_ptr(), w.data_ptr(), y.data_ptr(),
                                      _ptr(scratch), C, S, T, M, m, D, stream())
    _raise_on(rc, "analysis_beamform", M, m, r)
    launches["analysis_beamform"] += 1
    return y


def analysis_beamform_staged(xp: torch.Tensor, idx, hf: torch.Tensor, w: torch.Tensor,
                             M: int, m: int, r: int, T: int) -> torch.Tensor:
    """The fused kernel over buffer `idx` of a staged bank xp (B, C, S)
    float32: equal to `analysis_beamform(xp[idx], ...)`.  idx: a Python
    int, or a 0-d int32 tensor on the bank's device, which the kernel reads
    itself (no host readback); an out-of-range device index gives NaN."""
    B, C, S = xp.shape
    if isinstance(idx, torch.Tensor):
        if idx.dim() != 0 or idx.dtype != torch.int32:
            raise ValueError(f"analysis_beamform_staged: idx must be a 0-d int32 tensor, got "
                             f"{idx.dtype} of shape {tuple(idx.shape)}")
        tensors = (xp, hf, w, idx)
    else:
        idx = int(idx)
        if not 0 <= idx < B:
            raise IndexError(f"analysis_beamform_staged: buffer {idx} of a bank of {B}")
        tensors = (xp, hf, w)
    if not on_cuda("analysis_beamform_staged", *tensors):
        return analysis_beamform_plain(xp[int(idx)], hf, w, M, r, T)
    K, D = M // 2 + 1, M // r
    check("analysis_beamform_staged xp", xp, torch.float32, (B, C, S))
    check("analysis_beamform_staged hf", hf, torch.float32, (m * M,))
    check("analysis_beamform_staged w", w, torch.complex64, (K, C))
    y = torch.empty((T, K), dtype=torch.complex64, device=xp.device)
    if C == 0:
        return y.zero_()
    dev_idx = isinstance(idx, torch.Tensor)
    lib = _analysis_kernel()
    scratch = _scratch(lib.dsr_fb_analysis_beamform_scratch, "analysis_beamform_staged",
                       xp.device, C, T, M, m, r)
    rc = lib.dsr_fb_analysis_beamform_staged(
        xp.data_ptr(), idx.data_ptr() if dev_idx else None, 0 if dev_idx else idx, B,
        hf.data_ptr(), w.data_ptr(), y.data_ptr(), _ptr(scratch), C, S, T, M, m, D, stream())
    _raise_on(rc, "analysis_beamform_staged", M, m, r)
    launches["analysis_beamform_staged"] += 1
    return y


def synthesis(A: torch.Tensor, gf: torch.Tensor, M: int, m: int, r: int, start: int,
              out_len: int) -> torch.Tensor:
    """A (C, T, M//2+1) complex64, gf (m·M,) float32 → (C, out_len) float32;
    output sample j is padded-stream sample start + j."""
    if not on_cuda("synthesis", A, gf):
        return synthesis_plain(A, gf, M, r, start, out_len)
    C, T, K = A.shape
    D = M // r
    check("synthesis A", A, torch.complex64, (C, T, M // 2 + 1))
    check("synthesis gf", gf, torch.float32, (m * M,))
    if start < 0 or start + out_len > (T - 1) * D + m * M:
        raise ValueError(f"synthesis: samples [{start}, {start + out_len}) lie outside "
                         f"the {(T - 1) * D + m * M}-sample output stream")
    y = torch.empty((C, out_len), dtype=torch.float32, device=A.device)
    if y.numel() == 0:
        return y
    lib = _kernels()
    # device memory for the inverse FFT of every frame the output needs,
    # for configs whose tile does not fit a block (large M or m·r); none
    # otherwise
    floats = ctypes.c_longlong()
    rc = lib.dsr_fb_synthesis_scratch(C, M, m, D, start, out_len, ctypes.byref(floats))
    _raise_on(rc, "synthesis", M, m, r)
    scratch = (torch.empty(floats.value, dtype=torch.float32, device=A.device)
               if floats.value else None)
    rc = lib.dsr_fb_synthesis(A.data_ptr(), gf.data_ptr(), y.data_ptr(), _ptr(scratch), C, T,
                              M, m, D, start, out_len, stream())
    _raise_on(rc, "synthesis", M, m, r)
    launches["synthesis"] += 1
    return y
