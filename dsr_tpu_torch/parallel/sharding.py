"""Canonical layouts per array class, and the blocks a rank holds of them.

Counterpart of `dsr_tpu/parallel/sharding.py`: the same table under the
same names.  Each entry names, for each leading dimension of its array
class, the mesh axis it is split over, or None where it is replicated, as
a `PartitionSpec` does; dimensions beyond the entry are replicated.

`local_block` cuts this rank's block out of a global tensor
(`torch.tensor_split` over each named axis by the rank's coordinate: the
first blocks are one longer where a dimension does not divide);
`gather_block` is its inverse, an all-gather over each named axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dsr_tpu_torch.parallel.mesh import axis_size

# ---- front end ----------------------------------------------------------
# multi-channel waveforms (U, N, S): utterances over data
WAVEFORMS = ("data",)
# analysis-bank output (U, N, T, K): subbands are embarrassingly parallel
# between analysis and synthesis → natural sequence-parallel axis
SUBBAND_SNAPSHOTS = ("data", None, None, "subband")
# beamformed subbands (U, T, K)
BEAMFORMED = ("data", None, "subband")
# beamformer weights (K, N): per-subband
BEAM_WEIGHTS = ("subband",)
# features (U, T, D)
FEATURES = ("data",)

# ---- acoustic model -----------------------------------------------------
# GMM params (S_states, C, D): states over model when > 1 device
GMM_PARAMS = ("model",)
# GMM accumulators: same layout; reduced with psum_accum over data
GMM_ACCUM = ("model",)
# acoustic logliks (U, T, S_states)
LOGLIK = ("data", None, "model")

# ---- decoder ------------------------------------------------------------
# arc tables (S, A_max): state rows over model (graph sharding)
ARCS = ("model",)
# per-utterance scores (U,): utterances over data, replicated over model
SCORES = ("data",)
# token tables and olabels (U, ...)
TOKENS = ("data",)

# ---- neural AM (Conformer) ---------------------------------------------
CONFORMER_ATTN_QKV = (None, "model")       # (d_model, heads*dh) column-shard
CONFORMER_ATTN_OUT = ("model", None)       # row-shard
CONFORMER_FFN_UP = (None, "model")
CONFORMER_FFN_DOWN = ("model", None)
CONFORMER_ACTS = ("data", None, None)      # (U, T, d)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's equal-shaped `x` along `dim`, in rank order
    (a tiled all-gather).  Booleans travel as uint8."""
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0)
    wire = front.to(torch.uint8) if x.dtype == torch.bool else front
    out = wire.new_empty((n * wire.shape[0], *wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire.contiguous(), group=group)
    return out.to(x.dtype).movedim(0, dim)


def _named(spec, ndim: int):
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} names more dimensions than the tensor's {ndim}")
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def local_block(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `spec`."""
    for d, axis in _named(spec, x.dim()):
        x = torch.tensor_split(x, axis_size(mesh, axis), dim=d)[mesh.get_local_rank(axis)]
    return x


def gather_block(local: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """The global tensor from every rank's `local_block` under `spec`.  Block
    lengths are exchanged first, so uneven splits come back whole."""
    for d, axis in _named(spec, local.dim()):
        group = mesh.get_group(axis)
        n = axis_size(mesh, axis)
        size = torch.tensor([local.shape[d]], device=local.device)
        sizes = all_gather_dim(size, group, 0).tolist()
        top = max(sizes)
        padded = torch.cat([local, local.new_zeros(
            (*local.shape[:d], top - local.shape[d], *local.shape[d + 1:]))], dim=d)
        full = all_gather_dim(padded, group, d)
        local = torch.cat([full.narrow(d, i * top, sizes[i]) for i in range(n)], dim=d)
    return local
