"""Time-delay estimation and source localisation (PyTorch).

Counterpart of `dsr_tpu/ops/tde.py`, float32 throughout, tensors on the
caller's device:

  - GCC-PHAT over all mic pairs at once: (P, K) PHAT cross-spectra, one
    batched `torch.fft.irfft`, a parabolic sub-sample peak;
  - SRP-PHAT as one product of the grid's steering matrix with the
    cross-spectra (the grid's delays are computed on the host);
  - Gauss-Newton TDOA localisation (`ls_position`) and the closed-form
    spherical intersection (`sx_position`).
"""

from __future__ import annotations

import numpy as np
import torch


def _parabolic_peak(cc: torch.Tensor) -> torch.Tensor:
    """cc: (..., L) → fractional peak index (...,)."""
    k = torch.argmax(cc, dim=-1)
    L = cc.shape[-1]
    km = torch.clamp(k - 1, 0, L - 1)
    kp = torch.clamp(k + 1, 0, L - 1)
    y0 = torch.gather(cc, -1, km[..., None])[..., 0]
    y1 = torch.gather(cc, -1, k[..., None])[..., 0]
    y2 = torch.gather(cc, -1, kp[..., None])[..., 0]
    denom = y0 - 2 * y1 + y2
    safe = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / safe, torch.zeros_like(denom))
    interior = (k > 0) & (k < L - 1)
    return k + torch.where(interior, delta, torch.zeros_like(delta))


def _pair_index(pairs_i, pairs_j, device):
    return (torch.as_tensor(np.asarray(pairs_i), dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(pairs_j), dtype=torch.long, device=device))


def _phat(R: torch.Tensor) -> torch.Tensor:
    return R / torch.clamp(R.abs(), min=1e-15)


def gcc_phat_pairs(x: torch.Tensor, pairs: list[tuple[int, int]], sample_rate: float,
                   max_tau: float, interp: int = 4) -> torch.Tensor:
    """x: (N, S) → TDOA (P,) seconds for each (i, j) pair (all at once)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    S = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    X = torch.fft.rfft(x, nfft, dim=-1)
    max_shift = min(int(interp * sample_rate * max_tau), interp * nfft // 2)
    pi, pj = _pair_index([p[0] for p in pairs], [p[1] for p in pairs], x.device)
    R = _phat(X[pi] * X[pj].conj())                                 # (P, K)
    cc = torch.fft.irfft(R, interp * nfft, dim=-1)
    cc = torch.cat([cc[:, -max_shift:], cc[:, :max_shift + 1]], dim=-1)
    lags = -(_parabolic_peak(cc) - max_shift)
    return lags / (interp * sample_rate)


def gcc_phat_subband_pairs(Y: torch.Tensor, pairs_i, pairs_j, *, M: int,
                           interp: int = 8) -> torch.Tensor:
    """Subband GCC-PHAT: Y (N, T, K) analysis frames → lag samples (P,);
    divide by sample_rate·interp for seconds."""
    pi, pj = _pair_index(pairs_i, pairs_j, Y.device)
    R = _phat(torch.sum(Y[pi] * Y[pj].conj(), dim=1))                # (P, K)
    cc = torch.fft.irfft(R, interp * M, dim=-1)
    half = interp * M // 2
    cc = torch.cat([cc[:, -half:], cc[:, :half + 1]], dim=-1)
    return -(_parabolic_peak(cc) - half)


def expected_tdoas(pos, mics, pairs_i, pairs_j, c):
    d = torch.linalg.vector_norm(mics - pos[None, :], dim=1)
    return (d[pairs_j] - d[pairs_i]) / c


def tdoa_jacobian(pos, mics, pairs_i, pairs_j, c):
    d = torch.linalg.vector_norm(mics - pos[None, :], dim=1)
    u = (pos[None, :] - mics) / torch.clamp(d[:, None], min=1e-9)
    return (u[pairs_j] - u[pairs_i]) / c


def srp_phat(x: torch.Tensor, mics: np.ndarray, grid: np.ndarray, sample_rate: float,
             c: float = 343.0) -> tuple[torch.Tensor, torch.Tensor]:
    """SRP-PHAT as one product.  x: (N, S); grid: (G, 3) → (argmax pos, power (G,)).

    P(g) = Σ_p Re Σ_f Φ_p(f) e^{jω_f τ_p(g)} = Re[E(g,·) · vec(Φ)], E the
    (G, P·F) steering matrix of the grid."""
    x = torch.as_tensor(x, dtype=torch.float32)
    N, S = x.shape
    nfft = 1 << int(np.ceil(np.log2(S)))
    X = torch.fft.rfft(x, nfft, dim=-1)                             # (N, F)
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    pi = np.asarray([p[0] for p in pairs])
    pj = np.asarray([p[1] for p in pairs])
    Phi = _phat(X[pi] * X[pj].conj())                               # (P, F)
    f = np.arange(nfft // 2 + 1) * sample_rate / nfft
    grid = np.asarray(grid)
    d = np.linalg.norm(np.asarray(mics)[None, :, :] - grid[:, None, :], axis=-1)  # (G, N)
    taus = (d[:, pj] - d[:, pi]) / c                                # (G, P)
    ang = (2 * np.pi * taus[..., None] * f[None, None, :]).reshape(len(grid), -1)  # (G, P·F)
    cosm = torch.as_tensor(np.cos(ang).astype(np.float32), device=x.device)
    sinm = torch.as_tensor(np.sin(ang).astype(np.float32), device=x.device)
    power = cosm @ Phi.real.reshape(-1) - sinm @ Phi.imag.reshape(-1)
    best = torch.as_tensor(grid, device=x.device)[torch.argmax(power)]
    return best, power


def ls_position(tdoas, mics, pairs_i, pairs_j, x0, c: float = 343.0,
                iters: int = 20) -> torch.Tensor:
    """Gauss-Newton TDOA localisation from x0 (3,), `iters` steps."""
    x = x0
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device)
    for _ in range(iters):
        h = expected_tdoas(x, mics, pairs_i, pairs_j, c)
        J = tdoa_jacobian(x, mics, pairs_i, pairs_j, c)
        JtJ = J.T @ J + 1e-12 * eye
        x = x + torch.linalg.solve(JtJ, J.T @ (tdoas - h))
    return x


def sx_position(tdoas0: torch.Tensor, mics: torch.Tensor, c: float = 343.0) -> torch.Tensor:
    """Closed-form spherical-intersection (SX) source position from the
    TDOAs (N-1,) of mics 1..N-1 relative to mic 0; mics (N, 3).  Of the two
    quadratic roots it keeps the one whose position best fits its range."""
    m0 = mics[0]
    Mr = mics[1:] - m0[None, :]
    d = c * tdoas0
    delta = 0.5 * (torch.sum(Mr ** 2, dim=1) - d ** 2)
    W = torch.linalg.pinv(Mr)
    a = W @ delta
    b = W @ d
    A = b @ b - 1.0
    Bq = -2.0 * (a @ b)
    Cq = a @ a
    disc = torch.sqrt(torch.clamp(Bq * Bq - 4.0 * A * Cq, min=0.0))
    flat = A.abs() < 1e-9
    safe_A = torch.where(flat, torch.ones_like(A), A)
    quad = torch.stack([(-Bq + disc) / (2.0 * safe_A), (-Bq - disc) / (2.0 * safe_A)])
    lin = torch.stack([Cq / torch.clamp(-Bq, min=1e-12)] * 2)
    roots = torch.clamp(torch.where(flat, lin, quad), min=0.0)      # (2,)
    xs = a[None, :] - roots[:, None] * b[None, :]                   # (2, 3)
    res = (torch.linalg.vector_norm(xs, dim=1) - roots).abs()
    return xs[torch.argmin(res)] + m0
