"""ML (Viterbi or Baum-Welch) training of GMM-HMMs: the E-step accumulators
and the M-step (PyTorch).

Counterpart of `dsr_tpu/asr/train/ml.py`: the E-step is einsums over
(T, S, C) posteriors on the device of the features; `psum_accum` sums the
accumulators of data-parallel ranks over their process group (the mesh's
`data` group, `dsr_tpu_torch/parallel/`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from dsr_tpu_torch.asr.am.gmm import GmmParams, component_posteriors


class GmmAccum(NamedTuple):
    occ: torch.Tensor  # (S, C)
    sx: torch.Tensor   # (S, C, D)
    sxx: torch.Tensor  # (S, C, D)


def zero_accum(S: int, C: int, D: int, device=None) -> GmmAccum:
    return GmmAccum(
        torch.zeros((S, C), dtype=torch.float32, device=device),
        torch.zeros((S, C, D), dtype=torch.float32, device=device),
        torch.zeros((S, C, D), dtype=torch.float32, device=device),
    )


def accumulate(p: GmmParams, feats: torch.Tensor, gamma: torch.Tensor,
               acc: GmmAccum) -> GmmAccum:
    """E-step for one (batch of) utterance(s).

    feats: (..., T, D); gamma: (..., T, S) state occupancies.  Leading axes
    and T are summed into the accumulator.
    """
    _, post = component_posteriors(p, feats)            # (..., T, S, C)
    w = post * gamma[..., :, :, None]                   # (..., T, S, C)
    occ = w.reshape(-1, *w.shape[-2:]).sum(dim=0)
    sx = torch.einsum("...tsc,...td->scd", w, feats)
    sxx = torch.einsum("...tsc,...td->scd", w, feats**2)
    return GmmAccum(acc.occ + occ, acc.sx + sx, acc.sxx + sxx)


def psum_accum(acc: GmmAccum, group=None) -> GmmAccum:
    """Every field summed over the ranks of `group` (an all-reduce SUM of
    one flat buffer), the same result on each rank."""
    flat = torch.cat([a.reshape(-1) for a in acc])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return GmmAccum(*(part.view_as(a) for part, a in
                      zip(flat.split([a.numel() for a in acc]), acc)))


def mstep(acc: GmmAccum, var_floor: float = 1e-3, min_occ: float = 1e-2) -> GmmParams:
    occ = torch.clamp_min(acc.occ, min_occ)[..., None]
    means = acc.sx / occ
    variances = torch.clamp_min(acc.sxx / occ - means**2, var_floor)
    w = torch.clamp_min(acc.occ, 1e-8)
    logw = torch.log(w / torch.sum(w, dim=-1, keepdim=True))
    return GmmParams(means, variances, logw)
