"""Banded (left-to-right) Viterbi for Hopper, its plain PyTorch twin, and
the wrapper.

Counterpart of `dsr_tpu/ops/pallas/viterbi.py` (`banded_viterbi`): the
forced-alignment recursion over a linear chain of S states (self loop and
advance only),

    delta_0[s] = init[s] + ll[0, s]      (init 0 at state 0, -1e30 elsewhere)
    delta_t[s] = max(delta_{t-1}[s] + w_self[s], delta_{t-1}[s-1] + w_adv[s]) + ll[t, s]
    bp_t[s]    = 1 where the advance is strictly larger (ties go to self)

for U utterances at once (`csrc/viterbi.cu`, one block per utterance: up
to 1,024 states lanes of one to four consecutive states, one warp up to
128 states, more warps above; a block striding over the states beyond).
State 0 has no predecessor.  (The TPU kernel rolls delta across its padded
(R, 128) plane, so there state 0's "advance" reads the last padded state;
with the caller's adv_lp[0] = -1e30 both give state 0 no advance.)

`banded_viterbi(ll, self_lp, adv_lp)` dispatches on the device of its
tensors: on CPU tensors it runs the plain twin, on CUDA tensors it
launches the kernel and adds one to `launches["viterbi"]`, or raises.  It
returns the backpointer planes bp (U, T, S) uint8 (JAX: float32 0/1) and
the final delta (U, S) float32; ll is (U, T, S) float32 and the weights
(S,) or (U, S).  `best_path` traces the planes back on the host after one
copy, and `banded_path` is the JAX function's (path, score) contract.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

NEG = -1e30

# Kernel launches since the last `reset_launches()`.
launches = {"viterbi": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _weights(w: torch.Tensor, U: int) -> torch.Tensor:
    return w.expand(U, -1) if w.dim() == 1 else w


def banded_viterbi_plain(ll: torch.Tensor, self_lp: torch.Tensor, adv_lp: torch.Tensor):
    """The recursion of the module docstring with a Python loop over frames
    of (U, S) tensor operations, in the kernel's order of additions."""
    U, T, S = ll.shape
    ws, wa = _weights(self_lp, U), _weights(adv_lp, U)
    init = torch.full((S,), NEG, dtype=ll.dtype, device=ll.device)
    init[0] = 0.0
    delta = init + ll[:, 0]
    bp = torch.zeros((U, T, S), dtype=torch.uint8, device=ll.device)
    for t in range(1, T):
        stay = delta + ws
        adv = delta[:, :-1] + wa[:, 1:]
        took = adv > stay[:, 1:]
        bp[:, t, 1:] = took
        best = torch.cat([stay[:, :1], torch.where(took, adv, stay[:, 1:])], dim=1)
        delta = best + ll[:, t]
    return bp, delta


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("viterbi")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dsr_banded_viterbi.argtypes = [p, p, p, ll, p, p, p, i, i, i, p]
    lib.dsr_banded_viterbi.restype = ctypes.c_int
    lib.dsr_banded_needs_scratch.argtypes = [i]
    lib.dsr_banded_needs_scratch.restype = ctypes.c_int
    return lib


def banded_viterbi(ll: torch.Tensor, self_lp: torch.Tensor, adv_lp: torch.Tensor):
    """ll (U, T, S) float32, self_lp and adv_lp (S,) or (U, S) float32 →
    (bp (U, T, S) uint8, delta (U, S) float32)."""
    if ll.dim() != 3 or min(ll.shape) < 1:
        raise ValueError(f"banded_viterbi: need ll (U, T, S) with U, T, S >= 1, got "
                         f"{tuple(ll.shape)}")
    if not on_cuda("banded_viterbi", ll, self_lp, adv_lp):
        return banded_viterbi_plain(ll, self_lp, adv_lp)
    U, T, S = ll.shape
    wshape = (S,) if self_lp.dim() == 1 else (U, S)
    check("banded_viterbi ll", ll, torch.float32, (U, T, S))
    check("banded_viterbi self_lp", self_lp, torch.float32, wshape)
    check("banded_viterbi adv_lp", adv_lp, torch.float32, wshape)
    lib = _kernel()
    need = lib.dsr_banded_needs_scratch(S)
    if need < 0:
        raise RuntimeError(f"viterbi kernel: CUDA error {-need} reading the device")
    scratch = (torch.empty((U, 2, S), dtype=torch.float32, device=ll.device) if need
               else None)
    bp = torch.empty((U, T, S), dtype=torch.uint8, device=ll.device)
    delta = torch.empty((U, S), dtype=torch.float32, device=ll.device)
    rc = lib.dsr_banded_viterbi(ll.data_ptr(), self_lp.data_ptr(), adv_lp.data_ptr(),
                                0 if len(wshape) == 1 else S, bp.data_ptr(), delta.data_ptr(),
                                None if scratch is None else scratch.data_ptr(), U, T, S,
                                stream())
    if rc != 0:
        raise RuntimeError(f"viterbi kernel failed to launch: CUDA error {rc}")
    launches["viterbi"] += 1
    return bp, delta


def best_path(bp: torch.Tensor) -> np.ndarray:
    """Trace (U, T, S) backpointer planes back from state S-1 on the host
    (one device-to-host copy) → paths (U, T) int32."""
    planes = bp.cpu().numpy()
    U, T, S = planes.shape
    paths = np.empty((U, T), np.int32)
    state = np.full(U, S - 1, np.int64)
    rows = np.arange(U)
    paths[:, T - 1] = state
    for t in range(T - 1, 0, -1):
        state = state - planes[rows, t, state]
        paths[:, t - 1] = state
    return paths


def banded_path(loglik: torch.Tensor, self_lp: torch.Tensor, adv_lp: torch.Tensor):
    """The JAX `banded_viterbi` contract: loglik (T, S) → (path (T,) int32
    numpy, score float), the path ending in state S-1, score delta[S-1]."""
    bp, delta = banded_viterbi(loglik[None].contiguous(), self_lp, adv_lp)
    return best_path(bp)[0], float(delta[0, -1])
