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
exactly, so unlike the TPU kernel it has no spill certificate, and it
sorts no pool: it recombines through a hash table of destinations
(atomicMin of each candidate's (score, arc) word), finds the top kcap of
the winners by radix select and sorts only those (one launch, one block
an utterance, the table in shared memory up to 12,288 candidates; larger
pools take two more grid-wide launches first, the table in device
memory).

Lattice mode (`nlat > 0`, the XLA path's `topk_decoder.py:233-248`): each
kept slot also gets its state's top `nlat` incoming arcs, the candidates
at positions idx[k] + j (j < nlat) of step 1's order, where idx[k] is the
start of slot k's dst run; an alternate is valid while it stays inside
the run and the pool, the slot is alive, and its raw score beats max(val)
- beam (the threshold of step 3).  Column 0 is the winner itself; invalid
alternates are arc -1 and score NEG.  The run is sorted by score, so the
valid alternates are the top nlat of the dst's candidates above the
threshold, in (score desc, arc asc) order: the kernel buckets the live
slots' candidates above it and ranks each bucket.  The result is the
1-best triple, unchanged, plus (U, kcap, nlat) score and arc planes; dst
stays (U, kcap) (the Pallas wrapper repeated it nlat times).  Any nlat >=
1 is taken, as the XLA path takes it (the TPU kernel took 2, 4 and 8).

`recombine_topk` dispatches on the device of its tensors: on CPU tensors
it runs the plain twin (`torch.sort`), on CUDA tensors it launches the
kernel and adds one to `launches["select"]` (1-best) or
`launches["select_lattice"]` per call, or raises.  The kernel takes arc
ids in [0, 2^31) and dst ids in [0, 2^31 - 1); candidates that tie on
dst, score and arc with one score -0 and the other +0 are the one place
where it may differ from the twin (the twin keeps the first, the kernel
the +0).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

NEG = -1e30

# Kernel launches since the last `reset_launches()`.
launches = {"select": 0, "select_lattice": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def recombine_topk_plain(cand: torch.Tensor, fdst: torch.Tensor, arcs: torch.Tensor,
                         beam: torch.Tensor, kcap: int, nlat: int = 0):
    """The sort path, batched: cand (U, N) float32, fdst/arcs (U, N) int32,
    beam (U,) float32 → (scores (U, kcap) float32, dst (U, kcap) int32,
    arc (U, kcap) int32) [+ (alt_scores, alt_arcs) (U, kcap, nlat) when
    nlat > 0]."""
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
    thr = val.max(dim=1, keepdim=True).values - beam[:, None]
    val = torch.where(val > thr, val, neg)
    k = min(kcap, N)
    top = torch.sort(val, dim=1, descending=True, stable=True).indices[:, :k]
    scores = val.gather(1, top)
    alive = scores > NEG / 2
    dst = torch.where(alive, sd.gather(1, top), 0).to(torch.int32)
    arc = torch.where(alive, sa.gather(1, top), -1).to(torch.int32)
    out = [scores, dst, arc]
    if nlat:
        # slot j's run starts at sorted position top[j]; its alternates are
        # the next nlat positions while they stay in the run
        pos = top[:, :, None] + torch.arange(nlat, device=cand.device)
        posc = pos.clamp(max=N - 1).reshape(U, -1)
        v = sv.gather(1, posc).reshape(U, k, nlat)
        ok = ((sd.gather(1, posc).reshape(U, k, nlat) == sd.gather(1, top)[:, :, None])
              & (pos < N) & alive[:, :, None] & (v > thr[:, :, None]))
        out += [torch.where(ok, v, neg),
                torch.where(ok, sa.gather(1, posc).reshape(U, k, nlat), -1).to(torch.int32)]
    if k < kcap:            # fewer candidates than slots: dead slots
        pad = kcap - k
        fills = (NEG, 0, -1, NEG, -1)
        out = [torch.nn.functional.pad(o, (0, 0, 0, pad) if o.dim() == 3 else (0, pad),
                                       value=f) for o, f in zip(out, fills)]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("select")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsr_select_scratch.argtypes = [i, i, i, i, p]
    lib.dsr_select_scratch.restype = ctypes.c_int
    lib.dsr_select.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p]
    lib.dsr_select.restype = ctypes.c_int
    return lib


def _launch(cand, fdst, arcs, beam, kcap, nlat):
    """The kernel over (U, N) candidates, with the device scratch it asks
    for (csrc/select.cu)."""
    U, N = cand.shape
    dev = cand.device
    lib = _kernel()
    nbytes = ctypes.c_longlong()
    rc = lib.dsr_select_scratch(U, N, kcap, nlat, ctypes.byref(nbytes))
    if rc != 0:
        raise ValueError(f"recombine_topk: the kernel does not take U={U} N={N} kcap={kcap} "
                         f"nlat={nlat} (code {rc})")
    scratch = (torch.empty(nbytes.value, dtype=torch.uint8, device=dev) if nbytes.value
               else None)
    out = [torch.empty((U, kcap), dtype=torch.float32, device=dev),
           torch.empty((U, kcap), dtype=torch.int32, device=dev),
           torch.empty((U, kcap), dtype=torch.int32, device=dev)]
    if nlat:
        out += [torch.empty((U, kcap, nlat), dtype=torch.float32, device=dev),
                torch.empty((U, kcap, nlat), dtype=torch.int32, device=dev)]
    alt = [t.data_ptr() for t in out[3:]] or [None, None]
    rc = lib.dsr_select(cand.data_ptr(), fdst.data_ptr(), arcs.data_ptr(), beam.data_ptr(),
                        U, N, kcap, nlat, *(t.data_ptr() for t in out[:3]), *alt,
                        None if scratch is None else scratch.data_ptr(), stream())
    if rc != 0:
        raise RuntimeError(f"select kernel failed to launch: CUDA error {rc}")
    launches["select_lattice" if nlat else "select"] += 1
    return tuple(out)


def recombine_topk(cand: torch.Tensor, fdst: torch.Tensor, arcs: torch.Tensor, beam,
                   kcap: int, nlat: int = 0):
    """Recombine, beam-prune and select the top kcap of each utterance's
    candidates (module docstring).  cand (U, N) float32, fdst and arcs
    (U, N) int32, beam a (U,) float32 tensor or a number → (scores, dst,
    arc), each (U, kcap) [+ (alt_scores, alt_arcs), each (U, kcap, nlat),
    when nlat > 0]."""
    if cand.dim() != 2 or cand.shape[1] < 1 or kcap < 1 or nlat < 0:
        raise ValueError(f"recombine_topk: need (U, N) candidates with N >= 1, kcap >= 1 and "
                         f"nlat >= 0, got shape {tuple(cand.shape)}, kcap={kcap}, nlat={nlat}")
    U, N = cand.shape
    if not isinstance(beam, torch.Tensor):
        beam = torch.full((U,), float(beam), dtype=torch.float32, device=cand.device)
    if not on_cuda("recombine_topk", cand, fdst, arcs, beam):
        return recombine_topk_plain(cand, fdst, arcs, beam, kcap, nlat)
    check("recombine_topk cand", cand, torch.float32, (U, N))
    check("recombine_topk fdst", fdst, torch.int32, (U, N))
    check("recombine_topk arcs", arcs, torch.int32, (U, N))
    check("recombine_topk beam", beam, torch.float32, (U,))
    return _launch(cand, fdst, arcs, beam, kcap, nlat)
