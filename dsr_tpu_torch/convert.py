"""Parameters carried across from the JAX package.

Each function takes the JAX package's parameters as numpy arrays (or
anything `np.asarray` accepts) and returns the port's, so that both
packages compute with identical numbers.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr.am.gmm import GmmParams
from dsr_tpu_torch.asr.fsm.packed import PackedGraph


def gmm_params(p, device=None) -> GmmParams:
    """`dsr_tpu.asr.am.gmm.GmmParams` (means, variances, logweights) → port GMM."""
    means, variances, logweights = p
    return GmmParams(np.asarray(means), np.asarray(variances), np.asarray(logweights)).to(
        device or "cpu")


def packed_graph(g) -> PackedGraph:
    """`dsr_tpu.asr.fsm.packed.PackedGraph` → the port's, with its arrays
    copied (src, pdf, olabel, dst int32; weight, final_weight float32)."""
    i32 = lambda a: np.array(a, np.int32)  # noqa: E731
    return PackedGraph(i32(g.src), i32(g.pdf), i32(g.olabel), np.array(g.weight, np.float32),
                       i32(g.dst), int(g.start), np.array(g.final_weight, np.float32),
                       int(g.num_states))


def beamformer_weights(w, device=None) -> torch.Tensor:
    """Beamformer weights w (K, N) → complex64 tensor (K, N)."""
    return torch.as_tensor(np.array(w, np.complex64), device=device)


def prototypes(hf, gf, delay, device=None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Filterbank prototypes (hf, gf, delay) → (float32 hf, float32 gf, int delay)."""
    return (torch.as_tensor(np.array(hf, np.float32), device=device),
            torch.as_tensor(np.array(gf, np.float32), device=device),
            int(delay))
