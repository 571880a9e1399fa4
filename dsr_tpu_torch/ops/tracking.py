"""Speaker tracking: an iterated extended Kalman filter (IEKF) over TDOA
observations, in covariance and square-root form (PyTorch).

Counterpart of `dsr_tpu/ops/tracking.py`.  A trajectory is a Python loop
over TDOA frames with (position, covariance) carried, each step a few 3×3
and P×P products and solves, float32, on the caller's device.  The tracked
position gives the beamformer's steering delays
(`steering_delays_from_position`): GCC-PHAT → IEKF → steering → GSC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsr_tpu_torch.ops.tde import expected_tdoas, tdoa_jacobian


class TrackerState(NamedTuple):
    x: torch.Tensor  # (3,) position
    P: torch.Tensor  # (3, 3) covariance


def _gain(H, P_pred, R):
    S = H @ P_pred @ H.T + R
    return torch.linalg.solve(S, H @ P_pred).T


def _iterate(x0, P_pred, R, tdoas, mics, pairs_i, pairs_j, c, iters):
    """The IEKF's Gauss-Newton iterations about the predicted position x0."""
    xi = x0
    for _ in range(iters):
        h = expected_tdoas(xi, mics, pairs_i, pairs_j, c)
        H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
        xi = x0 + _gain(H, P_pred, R) @ (tdoas - h - H @ (x0 - xi))
    return xi


def iekf_step(state: TrackerState, tdoas, mics, pairs_i, pairs_j, q, r, c: float = 343.0,
              iters: int = 3) -> TrackerState:
    """One predict + update.  tdoas: (P,) seconds."""
    eye = torch.eye(3, dtype=state.P.dtype, device=state.P.device)
    P_pred = state.P + q * eye
    R = r * torch.eye(tdoas.shape[0], dtype=state.P.dtype, device=state.P.device)
    xi = _iterate(state.x, P_pred, R, tdoas, mics, pairs_i, pairs_j, c, iters)
    H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
    K = _gain(H, P_pred, R)
    IKH = eye - K @ H
    return TrackerState(xi, IKH @ P_pred @ IKH.T + K @ R @ K.T)  # Joseph form


def track(tdoa_seq, x0, P0, mics, pairs_i, pairs_j, q: float, r: float, c: float = 343.0,
          iters: int = 3) -> torch.Tensor:
    """Track over a TDOA sequence (T, P) → positions (T, 3)."""
    state, xs = TrackerState(x0, P0), []
    for tdoas in tdoa_seq:
        state = iekf_step(state, tdoas, mics, pairs_i, pairs_j, q, r, c, iters)
        xs.append(state.x)
    return torch.stack(xs)


def steering_delays_from_position(pos, mics, c: float = 343.0) -> torch.Tensor:
    """Tracked position → per-mic steering delays τ_n (seconds), relative to
    the array origin, for `beamforming.steering_vectors`."""
    d = torch.linalg.vector_norm(mics - pos[None, :], dim=1)
    return (d - torch.linalg.vector_norm(pos)) / c


# ------------------------------------------------------------------ sqrt IEKF


class SqrtTrackerState(NamedTuple):
    x: torch.Tensor  # (3,) position
    S: torch.Tensor  # (3, 3) lower-triangular Cholesky factor, P = S Sᵀ


def _qr_lower(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular L with L Lᵀ = Mᵀ M (QR, diagonal made non-negative)."""
    R = torch.linalg.qr(M, mode="r").R
    s = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return (R * s[:, None]).T


def iekf_step_sqrt(state: SqrtTrackerState, tdoas, mics, pairs_i, pairs_j, q, r,
                   c: float = 343.0, iters: int = 3) -> SqrtTrackerState:
    """Square-root IEKF step: the covariance is carried as a Cholesky factor
    and the update is a QR of the Kailath pre-array, so P is never formed
    across steps."""
    n, m = state.S.shape[0], tdoas.shape[0]
    dt, dev = state.S.dtype, state.S.device
    eye_n = torch.eye(n, dtype=dt, device=dev)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    S_pred = _qr_lower(torch.cat([state.S.T, q ** 0.5 * eye_n]))
    P_pred = S_pred @ S_pred.T
    xi = _iterate(state.x, P_pred, r * eye_m, tdoas, mics, pairs_i, pairs_j, c, iters)
    H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
    pre = torch.zeros((m + n, m + n), dtype=dt, device=dev)
    pre[:m, :m] = r ** 0.5 * eye_m
    pre[:m, m:] = H @ S_pred
    pre[m:, m:] = S_pred
    post = _qr_lower(pre.T)  # [[S_yy, 0], [K̄, S_post]]
    return SqrtTrackerState(xi, post[m:, m:])


def track_sqrt(tdoa_seq, x0, S0, mics, pairs_i, pairs_j, q: float, r: float,
               c: float = 343.0, iters: int = 3) -> torch.Tensor:
    """Square-root tracking over (T, P) TDOAs → positions (T, 3)."""
    state, xs = SqrtTrackerState(x0, S0), []
    for tdoas in tdoa_seq:
        state = iekf_step_sqrt(state, tdoas, mics, pairs_i, pairs_j, q, r, c, iters)
        xs.append(state.x)
    return torch.stack(xs)
