"""Token recombination, beam prune and top-K select for Hopper, its plain
PyTorch twin, and the wrapper.

Counterpart of `dsr_tpu/ops/pallas/select.py` (`recombine_topk`).  Per
utterance, over N candidate arcs (score, destination state, arc id), the
function of the decoders' sort path (`dsr_tpu/asr/decoder/topk_decoder.py`,
the `select_mode="xla"` branch of `_make_step`):

  1. order the candidates by (dst asc, score desc, arc asc);
  2. the first candidate of each dst run keeps its score, the others
     become NEG (recombination: each state's best incoming arc, exact-score
     ties to the smallest arc id);
  3. beam prune: keep val > max(val) - beam (a per-utterance beam);
  4. the top kcap by (val desc, dst asc), the stable tie order of
     `lax.top_k` over the dst-sorted runs.

Slots whose score is not above NEG/2 carry dst 0 and arc -1 (their score
stays as computed: NEG, or a kept value that low), as the Pallas kernel
writes them.  The CUDA kernel (`csrc/select.cu`) computes this function
exactly, so unlike the TPU kernel it has no spill certificate.

`recombine_topk` dispatches on the device of its tensors: on CPU tensors
it runs the plain twin (`torch.sort`), on CUDA tensors it launches the
kernel and adds one to `launches["select"]` per launch, or raises.  The
kernel takes arc ids in [0, 2^31) and dst ids in [0, 2^31 - 1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

NEG = -1e30
# Candidates one thread block sorts in shared memory (a power of two; 13
# bytes each).  Pools above it take two launches: per-chunk top-kcap lists,
# then the same routine over those lists.
CHUNK = 16384

# Kernel launches since the last `reset_launches()`.
launches = {"select": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def recombine_topk_plain(cand: torch.Tensor, fdst: torch.Tensor, arcs: torch.Tensor,
                         beam: torch.Tensor, kcap: int):
    """The sort path, batched: cand (U, N) float32, fdst/arcs (U, N) int32,
    beam (U,) float32 → (scores (U, kcap) float32, dst (U, kcap) int32,
    arc (U, kcap) int32)."""
    U, N = cand.shape
    # lexicographic (dst, -score, arc): stable sorts from the last key to the first
    order = torch.sort(arcs, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(cand.gather(1, order), dim=1, descending=True,
                                       stable=True).indices)
    order = order.gather(1, torch.sort(fdst.gather(1, order), dim=1, stable=True).indices)
    sd, sv, sa = fdst.gather(1, order), cand.gather(1, order), arcs.gather(1, order)
    first = torch.ones_like(sd, dtype=torch.bool)
    first[:, 1:] = sd[:, 1:] != sd[:, :-1]
    neg = torch.tensor(NEG, dtype=cand.dtype, device=cand.device)
    val = torch.where(first, sv, neg)
    mx = val.max(dim=1, keepdim=True).values
    val = torch.where(val > mx - beam[:, None], val, neg)
    k = min(kcap, N)
    top = torch.sort(val, dim=1, descending=True, stable=True).indices[:, :k]
    scores = val.gather(1, top)
    alive = scores > NEG / 2
    dst = torch.where(alive, sd.gather(1, top), 0).to(torch.int32)
    arc = torch.where(alive, sa.gather(1, top), -1).to(torch.int32)
    if k < kcap:            # fewer candidates than slots: dead slots
        pad = kcap - k
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
        dst = torch.nn.functional.pad(dst, (0, pad), value=0)
        arc = torch.nn.functional.pad(arc, (0, pad), value=-1)
    return scores, dst, arc


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("select")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsr_select.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.dsr_select.restype = ctypes.c_int
    return lib


def recombine_topk(cand: torch.Tensor, fdst: torch.Tensor, arcs: torch.Tensor, beam,
                   kcap: int):
    """Recombine, beam-prune and select the top kcap of each utterance's
    candidates (module docstring).  cand (U, N) float32, fdst and arcs
    (U, N) int32, beam a (U,) float32 tensor or a number → (scores, dst,
    arc), each (U, kcap)."""
    if cand.dim() != 2 or cand.shape[1] < 1 or kcap < 1:
        raise ValueError(f"recombine_topk: need (U, N) candidates with N >= 1 and kcap >= 1, "
                         f"got shape {tuple(cand.shape)} and kcap={kcap}")
    U, N = cand.shape
    if not isinstance(beam, torch.Tensor):
        beam = torch.full((U,), float(beam), dtype=torch.float32, device=cand.device)
    if not on_cuda("recombine_topk", cand, fdst, arcs, beam):
        return recombine_topk_plain(cand, fdst, arcs, beam, kcap)
    check("recombine_topk cand", cand, torch.float32, (U, N))
    check("recombine_topk fdst", fdst, torch.int32, (U, N))
    check("recombine_topk arcs", arcs, torch.int32, (U, N))
    check("recombine_topk beam", beam, torch.float32, (U,))
    nchunks = -(-N // CHUNK)
    if nchunks > 1 and nchunks * kcap > CHUNK:
        raise ValueError(f"recombine_topk: {N} candidates need {nchunks} chunks, whose "
                         f"{nchunks * kcap} kept candidates exceed one block's {CHUNK}")
    dev = cand.device
    scores = torch.empty((U, kcap), dtype=torch.float32, device=dev)
    dst = torch.empty((U, kcap), dtype=torch.int32, device=dev)
    arc = torch.empty((U, kcap), dtype=torch.int32, device=dev)
    if nchunks > 1:     # the chunks' top-kcap lists and their duplicate flags
        tmp_s = torch.empty((U, nchunks * kcap), dtype=torch.float32, device=dev)
        tmp_d = torch.empty((U, nchunks * kcap), dtype=torch.int32, device=dev)
        tmp_a = torch.empty((U, nchunks * kcap), dtype=torch.int32, device=dev)
        tmp_f = torch.empty((U, nchunks), dtype=torch.int32, device=dev)
        tmp = [t.data_ptr() for t in (tmp_s, tmp_d, tmp_a, tmp_f)]
    else:
        tmp = [None] * 4
    rc = _kernel().dsr_select(cand.data_ptr(), fdst.data_ptr(), arcs.data_ptr(),
                              beam.data_ptr(), U, N, kcap, CHUNK, scores.data_ptr(),
                              dst.data_ptr(), arc.data_ptr(), *tmp, stream())
    if rc != 0:
        raise RuntimeError(f"select kernel failed to launch: CUDA error {rc}")
    launches["select"] += 1 if nchunks == 1 else 2
    return scores, dst, arc
