"""The top-K decoders' traceback for Hopper, its plain twin, and the
wrapper.

The walk behind every top-K token-passing decoder's words
(`asr/decoder/topk_decoder.traceback_lookups`): from the (T, U, K) token
tables (each frame's K surviving states and the arcs that reached them,
per utterance) and the final carry, each utterance's best path as arc ids.
Per utterance u:

  1. the best final token: the first slot of the largest score + final
     weight, or, when no sum is above NEG/2 (no token reached a final
     state: an utterance cut mid-word), of the largest score alone; its
     value is the utterance's score and its state starts the walk;
  2. for t = T - 1 down to 0: the first slot holding the current state
     (slot 0 if none does) gives the arc; while t < lengths[u] and the arc
     is >= 0 the arc is kept and the state becomes its source state,
     arc // a_div, or src_of_row[arc // a_div] where the graph's table rows
     are not its states (the degree-split graph's overflow rows).

Outputs: the arcs (U, T) int32, -1 where no arc is kept (t >= length, or
arc < 0), and the scores (U,) float32.

Counterpart of the JAX decoders' walks (`dsr_tpu/asr/decoder/
topk_decoder.py:335` `_traceback_impl` and `split_decoder.py:229`, each a
`lax.scan` on the device); the JAX package has no Pallas kernel for it.
`traceback` dispatches on the device of its tensors: on CPU tensors it
runs the plain twin (`traceback_plain`, the walk in NumPy), on CUDA
tensors it launches the kernel (`csrc/traceback.cu`: a warp an utterance,
each frame's two rows prefetched into a ring in shared memory by 4-byte
cp.async copies, the slot found by ballots, the best final token as step
0) and adds one to
`launches["traceback"]`, or raises.  The kernel only compares ints and
adds two floats a slot, so both give the same bits.

Bound on the card: the walk needs each walked frame's state row and one
arc, and writes one word a frame: at most U·T·(4K + 8) bytes, plus 12·U·K
of final carry, 0.86 GB at U = 1,024, T = 818, K = 256 (0.26 ms at
3.35 TB/s).  Frames at or past an utterance's length are not read, so the
v2k cells' batches, whose utterances run 166-818 frames, need 0.53 GB
(0.16 ms).  The kernel also reads each walked frame's whole arc row, so
that its chain of dependent steps waits on shared memory alone; that
chain, L steps for an utterance of L frames, bounds its time (about
0.5 ms at L = 818 on an H100, whatever U is).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from dsr_tpu_torch.ops.cuda import build
from dsr_tpu_torch.ops.cuda.launch import check, on_cuda, stream

NEG = -1e30
_NO_FIT = -1   # traceback.cu's kNoFit

# Kernel launches since the last `reset_launches()`.
launches = {"traceback": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _best_final(states_f: np.ndarray, scores_f: np.ndarray, final_f: np.ndarray):
    """(best state, best score) per utterance from the final carry
    (U, K) and its states' final weights final_f (U, K): score + final
    weight, or, when no token reaches a final state (an utterance cut
    mid-word), the best token without it."""
    total = scores_f + final_f
    dead = ~(total.max(axis=1) > NEG / 2)
    total[dead] = scores_f[dead]
    slot = np.argmax(total, axis=1)
    rows = np.arange(len(slot))
    return states_f[rows, slot], total[rows, slot]


def _backtrack(tok_states: np.ndarray, tok_arcs: np.ndarray, best_state: np.ndarray,
               lengths: np.ndarray, a_div: int, src_of_row) -> tuple[np.ndarray, np.ndarray]:
    """Walk the (T, U, K) token tables back from each utterance's best
    state → (arcs (T, U), valid (T, U)).  At frame t the token holding the
    current state (its first slot; slot 0 if none does) gives the arc;
    it is followed while t < length and the arc is >= 0, to its source
    state arc // a_div (through src_of_row when given)."""
    T, U, _ = tok_states.shape
    state = best_state.copy()
    rows = np.arange(U)
    arcs = np.zeros((T, U), np.int64)
    valid = np.zeros((T, U), bool)
    for t in range(T - 1, -1, -1):
        slot = np.argmax(tok_states[t] == state[:, None], axis=1)
        arc = tok_arcs[t, rows, slot].astype(np.int64)
        ok = (t < lengths) & (arc >= 0)
        arcs[t] = np.maximum(arc, 0)
        valid[t] = ok
        row = np.maximum(arc, 0) // a_div
        state = np.where(ok, row if src_of_row is None else src_of_row[row], state)
    return arcs, valid


def traceback_plain(tok_states: torch.Tensor, tok_arcs: torch.Tensor, states_f: torch.Tensor,
                    scores_f: torch.Tensor, final_f: torch.Tensor, lengths: torch.Tensor,
                    a_div: int, src_of_row: torch.Tensor | None = None):
    """The walk of the module docstring in NumPy, on CPU tensors →
    (arcs (U, T) int32, -1 where no arc is kept; scores (U,) float32), CPU
    tensors."""
    best_state, best_score = _best_final(states_f.numpy(), scores_f.numpy(), final_f.numpy())
    arcs, valid = _backtrack(tok_states.numpy(), tok_arcs.numpy(), best_state,
                             lengths.numpy(), a_div,
                             None if src_of_row is None else src_of_row.numpy())
    return (torch.from_numpy(np.ascontiguousarray(np.where(valid, arcs, -1).T, np.int32)),
            torch.from_numpy(best_score))


@functools.lru_cache(maxsize=None)
def _kernel() -> ctypes.CDLL:
    lib = build.library("traceback")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dsr_traceback.argtypes = [p, p, p, p, p, p, i, p, p, p, i, i, i, p]
    lib.dsr_traceback.restype = ctypes.c_int
    return lib


def traceback(tok_states: torch.Tensor, tok_arcs: torch.Tensor, states_f: torch.Tensor,
              scores_f: torch.Tensor, final_f: torch.Tensor, lengths: torch.Tensor, a_div: int,
              src_of_row: torch.Tensor | None = None):
    """Walk the token tables back (module docstring).  tok_states and
    tok_arcs (T, U, K) int32, states_f (U, K) int32, scores_f and final_f
    (U, K) float32, lengths (U,) int32, a_div >= 1, src_of_row int32 or
    None, all on one device → (arcs (U, T) int32, scores (U,) float32)
    there."""
    if tok_states.dim() != 3 or min(tok_states.shape[1:]) < 1 or a_div < 1:
        raise ValueError(f"traceback: need (T, U, K) tables with U, K >= 1 and a_div >= 1, got "
                         f"shape {tuple(tok_states.shape)}, a_div={a_div}")
    T, U, K = tok_states.shape
    rows = () if src_of_row is None else (src_of_row,)
    if not on_cuda("traceback", tok_states, tok_arcs, states_f, scores_f, final_f, lengths,
                   *rows):
        return traceback_plain(tok_states, tok_arcs, states_f, scores_f, final_f, lengths,
                               a_div, src_of_row)
    tok_states, tok_arcs = tok_states.contiguous(), tok_arcs.contiguous()
    check("traceback tok_states", tok_states, torch.int32, (T, U, K))
    check("traceback tok_arcs", tok_arcs, torch.int32, (T, U, K))
    check("traceback states_f", states_f, torch.int32, (U, K))
    check("traceback scores_f", scores_f, torch.float32, (U, K))
    check("traceback final_f", final_f, torch.float32, (U, K))
    check("traceback lengths", lengths, torch.int32, (U,))
    if src_of_row is not None:
        check("traceback src_of_row", src_of_row, torch.int32, tuple(src_of_row.shape[:1]))
    arcs = torch.empty((U, T), dtype=torch.int32, device=tok_states.device)
    best = torch.empty((U,), dtype=torch.float32, device=tok_states.device)
    rc = _kernel().dsr_traceback(
        tok_states.data_ptr(), tok_arcs.data_ptr(), states_f.data_ptr(), scores_f.data_ptr(),
        final_f.data_ptr(), lengths.data_ptr(), a_div,
        None if src_of_row is None else src_of_row.data_ptr(), arcs.data_ptr(), best.data_ptr(),
        U, T, K, stream())
    if rc == _NO_FIT:
        raise ValueError(f"traceback: the kernel does not take U={U} T={T} K={K}")
    if rc != 0:
        raise RuntimeError(f"traceback kernel failed to launch: CUDA error {rc}")
    launches["traceback"] += 1
    return arcs, best
