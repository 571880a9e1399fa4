"""WPE multi-channel dereverberation (PyTorch).

Counterpart of `dsr_tpu/ops/dereverb.py`: all K subbands solve their
(N·taps × N·taps) weighted normal equations as one batched complex
`torch.linalg.solve`; the delayed-frame stacks are shifted copies; the
variance / filter alternation runs `iters` times.
"""

from __future__ import annotations

import torch


def wpe(Y: torch.Tensor, taps: int = 8, delay: int = 2, iters: int = 3,
        eps: float = 1e-10) -> torch.Tensor:
    """Y: (N, T, K) complex64 → dereverbed (N, T, K)."""
    N, T, K = Y.shape
    Yk = Y.permute(2, 0, 1)                                         # (K, N, T)
    F = torch.zeros((K, N * taps, T), dtype=Y.dtype, device=Y.device)
    for tau in range(taps):     # F[:, tau·N + n, t] = Y[n, t - delay - tau]
        shift = delay + tau
        if shift < T:
            F[:, tau * N:(tau + 1) * N, shift:] = Yk[:, :, :T - shift]
    D = Yk
    NT = N * taps
    eye = torch.eye(NT, dtype=Y.dtype, device=Y.device)
    for _ in range(iters):
        lam = torch.clamp((D.abs() ** 2).mean(dim=1), min=eps)      # (K, T)
        Fw = F / lam[:, None, :]
        R = torch.einsum("kit,kjt->kij", Fw, F.conj())              # (K, NT, NT)
        Pm = torch.einsum("kit,knt->kin", Fw, Yk.conj())            # (K, NT, N)
        tr = torch.diagonal(R, dim1=1, dim2=2).real.sum(dim=-1)[:, None, None]
        G = torch.linalg.solve(R + (eps * tr / NT) * eye, Pm)       # (K, NT, N)
        D = Yk - torch.einsum("kin,kit->knt", G.conj(), F)
    return D.permute(1, 2, 0)
