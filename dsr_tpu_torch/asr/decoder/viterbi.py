"""Dense Viterbi decode / forced alignment and forward-backward (PyTorch).

Counterpart of `dsr_tpu/asr/decoder/viterbi.py` (XLA code there, no
Pallas kernel): the same recursions over a dense (S, S) transition matrix,
batched over utterances, as a Python loop over frames of (U, S, S) tensor
operations; the traceback runs on the host after one copy of the
backpointers.  Ties go to the lowest state index, as `jnp.argmax` takes
them.

Variable lengths: frames t >= length freeze the recursion (identity
update), so the final scores equal the length-exact result, and the path
past the length repeats its last state.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def _first_argmax(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, lowest index attaining it) along `dim`."""
    mx = x.amax(dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device).view(
        [-1 if d == dim % x.dim() else 1 for d in range(x.dim())])
    first = torch.where(x == mx, idx, x.shape[dim]).amin(dim=dim)
    return mx.squeeze(dim), first


def _lengths(lengths, U: int, T: int) -> np.ndarray:
    if lengths is None:
        return np.full(U, T, np.int64)
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu()
    return np.asarray(lengths, np.int64).reshape(U)


def viterbi_batch(loglik: torch.Tensor, logA, init, final, lengths=None):
    """loglik (U, T, S); logA (S, S) shared or (U, S, S); init and final
    (S,) or (U, S); lengths (U,) or None → (paths (U, T) int64, scores (U,)
    float32), both on the device of `loglik`."""
    U, T, S = loglik.shape
    dev = loglik.device
    A = torch.as_tensor(logA, dtype=torch.float32, device=dev)
    A = A.expand(U, S, S) if A.dim() == 2 else A
    ini = torch.as_tensor(init, dtype=torch.float32, device=dev).expand(U, S)
    fin = torch.as_tensor(final, dtype=torch.float32, device=dev).expand(U, S)
    lens = _lengths(lengths, U, T)
    delta = ini + loglik[:, 0]
    psis = torch.empty((max(T - 1, 0), U, S), dtype=torch.int64, device=dev)
    for t in range(1, T):
        cand = delta[:, :, None] + A                          # (U, S_prev, S)
        mx, psis[t - 1] = _first_argmax(cand, 1)
        new = mx + loglik[:, t]
        keep = torch.as_tensor(t < lens, device=dev)[:, None]
        delta = torch.where(keep, new, delta)
    total = delta + fin
    score, last = _first_argmax(total, 1)
    # the traceback, on the host: states past each length stay put
    psi = psis.cpu().numpy()
    paths = np.empty((U, T), np.int64)
    state = last.cpu().numpy()
    paths[:, T - 1] = state
    rows = np.arange(U)
    for t in range(T - 1, 0, -1):
        prev = psi[t - 1, rows, state]
        state = np.where(t < lens, prev, state)
        paths[:, t - 1] = state
    return torch.as_tensor(paths, device=dev), score


def viterbi(loglik: torch.Tensor, logA, init, final, length=None):
    """loglik (T, S); logA (S, S); init, final (S,) → (path (T,) int64,
    score ()).  With `length`, frames past it are frozen and the path is
    padded with its last state."""
    paths, scores = viterbi_batch(loglik[None], logA, init, final,
                                  None if length is None else [int(length)])
    return paths[0], scores[0]


def forward_backward_batch(loglik: torch.Tensor, logA, init, final, lengths=None):
    """Log-domain forward-backward over U utterances → (gamma (U, T, S),
    total log-likelihood (U,)); frames >= length get gamma 0."""
    U, T, S = loglik.shape
    dev = loglik.device
    A = torch.as_tensor(logA, dtype=torch.float32, device=dev)
    A = A.expand(U, S, S) if A.dim() == 2 else A
    ini = torch.as_tensor(init, dtype=torch.float32, device=dev).expand(U, S)
    fin = torch.as_tensor(final, dtype=torch.float32, device=dev).expand(U, S)
    lens = _lengths(lengths, U, T)
    alphas = torch.empty((U, T, S), dtype=torch.float32, device=dev)
    alpha = ini + loglik[:, 0]
    alphas[:, 0] = alpha
    for t in range(1, T):
        new = loglik[:, t] + torch.logsumexp(alpha[:, :, None] + A, dim=1)
        alpha = torch.where(torch.as_tensor(t < lens, device=dev)[:, None], new, alpha)
        alphas[:, t] = alpha
    betas = torch.empty((U, T, S), dtype=torch.float32, device=dev)
    beta = fin
    betas[:, T - 1] = beta
    for t in range(T - 2, -1, -1):
        # beta[t] from frame t + 1's emission; frozen past the length
        new = torch.logsumexp(A + (loglik[:, t + 1] + beta)[:, None, :], dim=2)
        beta = torch.where(torch.as_tensor(t + 1 < lens, device=dev)[:, None], new, beta)
        betas[:, t] = beta
    total = torch.logsumexp(alpha + fin, dim=1)
    gamma = torch.exp(alphas + betas - total[:, None, None])
    tmask = torch.as_tensor(np.arange(T)[None, :] < lens[:, None], device=dev)[..., None]
    return torch.where(tmask, gamma, 0.0), total


def forward_backward(loglik: torch.Tensor, logA, init, final, length=None):
    """loglik (T, S) → (gamma (T, S), total ()), as `forward_backward_batch`."""
    gamma, total = forward_backward_batch(loglik[None], logA, init, final,
                                          None if length is None else [int(length)])
    return gamma[0], total[0]
