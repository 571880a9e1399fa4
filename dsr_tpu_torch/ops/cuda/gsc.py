"""GSC-NLMS kernel for Hopper, its plain PyTorch twin, and the wrapper.

Counterpart of `dsr_tpu/ops/pallas/gsc.py` (`gsc_nlms`): the generalised
sidelobe canceller's whole frame recurrence (`csrc/gsc.cu`, two launches:
the front work yc = wq^H x, z = B^H x, |z|^2 and the NLMS gain for every
frame in parallel into a scratch array, then the serial chain a warp per
group of bins, the active weights in registers, a bin on 1 lane up to 4
channels and on a group of 2 to 32 lanes above; above 513 channels a warp
a bin with the weights in device memory).
The kernel's layout is the JAX wrapper's batched form, complex64 throughout:
X (U, N, T, K), wq (U, K, N), B (U, K, N, N-1), wa0 (U, K, N-1) or None
→ (Y (U, T, K), wa (U, K, N-1)).

`gsc_nlms` dispatches on the device of its tensors: on CPU tensors it runs
the plain twin, on CUDA tensors it launches the kernel and adds one to
`launches["gsc"]`, or raises.  `dsr_tpu_torch.ops.beamforming.gsc_nlms`
holds the (N, T, K) form.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

# Kernel launches since the last `reset_launches()` (one a call: the front
# work's launch and the chain's).
launches = {"gsc": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def gsc_nlms_plain(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, mu: float,
                   eps: float, cap: float, wa0: torch.Tensor | None = None):
    """The recurrence of `dsr_tpu.ops.beamforming._gsc_scan`, batched over
    utterances: yc and z for every frame first (they do not depend on the
    active weights), then a Python loop over frames for y and the update."""
    U, N, T, K = X.shape
    yc = torch.einsum("ukn,untk->utk", wq.conj(), X)
    z = torch.einsum("uknm,untk->utkm", B.conj(), X)
    znorm = torch.sum(z.real ** 2 + z.imag ** 2, dim=-1, keepdim=True)
    wa = (torch.zeros((U, K, N - 1), dtype=X.dtype, device=X.device) if wa0 is None
          else wa0.clone())
    Y = torch.empty((U, T, K), dtype=X.dtype, device=X.device)
    for t in range(T):
        zt = z[:, t]
        y = yc[:, t] - torch.sum(wa.conj() * zt, dim=-1)
        Y[:, t] = y
        wa = wa + mu * zt * y.conj()[..., None] / (znorm[:, t] + eps)
        nrm = torch.linalg.vector_norm(wa, dim=-1, keepdim=True)
        wa = wa * torch.clamp(cap / torch.clamp(nrm, min=1e-30), max=1.0)
    return Y, wa


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("gsc")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dsr_gsc_nlms.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f, f, p, p]
    lib.dsr_gsc_nlms.restype = ctypes.c_int
    lib.dsr_gsc_scratch.argtypes = [i, i, i, i]
    lib.dsr_gsc_scratch.restype = ctypes.c_longlong
    return lib


def gsc_nlms(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, mu: float = 0.1,
             eps: float = 1e-6, cap: float = 10.0, wa0: torch.Tensor | None = None):
    """GSC-NLMS over U utterances (module docstring for the layouts)."""
    U, N, T, K = X.shape
    tensors = (X, wq, B) if wa0 is None else (X, wq, B, wa0)
    if not on_cuda("gsc_nlms", *tensors):
        return gsc_nlms_plain(X, wq, B, mu, eps, cap, wa0)
    if N < 2 or T < 1:
        raise ValueError(f"gsc_nlms: need at least 2 channels and one frame, got N={N}, T={T}")
    check("gsc_nlms X", X, torch.complex64, (U, N, T, K))
    check("gsc_nlms wq", wq, torch.complex64, (U, K, N))
    check("gsc_nlms B", B, torch.complex64, (U, K, N, N - 1))
    if wa0 is not None:
        check("gsc_nlms wa0", wa0, torch.complex64, (U, K, N - 1))
    Y = torch.empty((U, T, K), dtype=torch.complex64, device=X.device)
    wa = torch.empty((U, K, N - 1), dtype=torch.complex64, device=X.device)
    if U * K == 0:
        return Y, wa
    lib = _kernel()
    # the front work's records (yc, z, the gain) of every frame and bin
    scratch = torch.empty(lib.dsr_gsc_scratch(U, N, T, K), dtype=torch.complex64, device=X.device)
    rc = lib.dsr_gsc_nlms(X.data_ptr(), wq.data_ptr(), B.data_ptr(),
                          None if wa0 is None else wa0.data_ptr(), Y.data_ptr(), wa.data_ptr(),
                          U, N, T, K, float(mu), float(eps), float(cap), scratch.data_ptr(),
                          stream())
    if rc != 0:
        raise RuntimeError(f"gsc kernel failed to launch: CUDA error {rc}")
    launches["gsc"] += 1
    return Y, wa
