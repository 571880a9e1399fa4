"""Steering + delay-and-sum kernel for Hopper, its plain PyTorch twin, and
the wrapper.

Counterpart of `dsr_tpu/ops/pallas/steering.py` (`ds_beamform`): the
steering phases e^{-2πi f_k τ_n} evaluated inside the kernel and applied as
delay-and-sum weights in the same pass (`csrc/steering.cu`), for static
delays (N,) or a per-frame trajectory (T, N), as a tracker produces.

`ds_beamform` dispatches on the device of its tensors: on CPU tensors it
runs the plain twin (the composed steering vectors, DS weights and apply of
`dsr_tpu/ops/beamforming.py`), on CUDA tensors it launches the kernel and
adds one to `launches["steering"]`, or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

# Kernel launches since the last `reset_launches()`.
launches = {"steering": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def ds_beamform_plain(X: torch.Tensor, taus: torch.Tensor, M: int,
                      sample_rate: float) -> torch.Tensor:
    """X (N, T, K) complex64, taus (N,) or (T, N) float32 seconds → (T, K):
    `apply_weights(X, ds_weights(steering_vectors(taus)))`, per frame for a
    trajectory."""
    f = torch.arange(M // 2 + 1, dtype=torch.float32, device=X.device) * (sample_rate / M)
    phase = -2.0 * math.pi * f[:, None] * taus[..., None, :]
    v = torch.complex(torch.cos(phase), torch.sin(phase))      # (..., K, N)
    if taus.ndim == 1:
        return torch.einsum("kn,ntk->tk", (v / X.shape[0]).conj(), X)
    return torch.einsum("tkn,ntk->tk", v.conj(), X) / X.shape[0]


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("steering")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dsr_ds_beamform.argtypes = [p, p, p, i, i, i, i, f, p]
    lib.dsr_ds_beamform.restype = ctypes.c_int
    return lib


def ds_beamform(X: torch.Tensor, taus: torch.Tensor, M: int, sample_rate: float) -> torch.Tensor:
    """Steering + delay-and-sum: X (N, T, K) complex64 with K = M//2+1, taus
    (N,) or (T, N) float32 seconds → Y (T, K) complex64."""
    N, T, K = X.shape
    if taus.shape not in ((N,), (T, N)):
        raise ValueError(f"ds_beamform: delays must be ({N},) or ({T}, {N}), "
                         f"got {tuple(taus.shape)}")
    if not on_cuda("ds_beamform", X, taus):
        return ds_beamform_plain(X, taus, M, sample_rate)
    check("ds_beamform X", X, torch.complex64, (N, T, M // 2 + 1))
    check("ds_beamform taus", taus, torch.float32, tuple(taus.shape))
    Y = torch.empty((T, K), dtype=torch.complex64, device=X.device)
    stride = N if taus.ndim == 2 else 0
    rc = _kernel().dsr_ds_beamform(X.data_ptr(), taus.data_ptr(), Y.data_ptr(), N, T, K,
                                   stride, float(sample_rate / M), stream())
    if rc != 0:
        raise RuntimeError(f"steering kernel failed to launch: CUDA error {rc}")
    launches["steering"] += 1
    return Y
