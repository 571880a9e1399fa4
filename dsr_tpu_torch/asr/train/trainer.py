"""Batched ML trainer (Viterbi or Baum-Welch E-step) and word-loop decode
for the small-vocabulary and phone tasks (PyTorch).

Counterpart of `dsr_tpu/asr/train/trainer.py`: utterances are padded to a
common (T_max, L_max), the alignment graphs are padded dense matrices, the
E-step aligns the whole corpus with the dense batched `viterbi` (or
`forward_backward`) and accumulates with batched einsums.  The trainer
keeps the dense recursion on every device, as the JAX trainer does on the
TPU; only `asr.path.force_align` reaches the banded kernel.

`train` and `decode` run on the card unless the caller passes
`device="cpu"` (`decode` runs where its `params` are).
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import smallvocab
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import viterbi as vit
from dsr_tpu_torch.asr.train import ml
from dsr_tpu_torch.utils.device import resolve

LOG0 = smallvocab.LOG0


def pad_corpus(feats_list: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """→ (feats (U, T_max, D) f32, lengths (U,) i32)."""
    T_max = max(len(f) for f in feats_list)
    D = feats_list[0].shape[1]
    out = np.zeros((len(feats_list), T_max, D), np.float32)
    lens = np.zeros(len(feats_list), np.int32)
    for i, f in enumerate(feats_list):
        out[i, : len(f)] = np.asarray(f)
        lens[i] = len(f)
    return out, lens


def pad_align_graphs(task, transcripts: list[list[str]]):
    """Padded per-utterance linear alignment graphs.

    → (ids (U, L_max) i32, logA (U, L_max, L_max) f32, init, final (U, L_max))
    Padding positions are unreachable self-loop states.
    """
    built = [task.align_graph(ws) for ws in transcripts]
    L_max = max(len(b[0]) for b in built)
    U = len(built)
    ids = np.zeros((U, L_max), np.int32)
    A = np.full((U, L_max, L_max), LOG0, np.float32)
    init = np.full((U, L_max), LOG0, np.float32)
    final = np.full((U, L_max), LOG0, np.float32)
    for u, (i_u, A_u, init_u, final_u) in enumerate(built):
        L = len(i_u)
        ids[u, :L] = i_u
        A[u, :L, :L] = A_u
        A[u, np.arange(L, L_max), np.arange(L, L_max)] = 0.0
        init[u, :L] = init_u
        final[u, :L] = final_u
    return ids, A, init, final


def init_gmm_from_feats(feats_list, state_splits, num_states, num_comp, rng):
    """Flat start (the port's copy of `golden/gmm_hmm.init_gmm_from_feats`,
    the same rng draws in the same order): uniformly segment each
    utterance's frames over its states, then per-state k-means-ish init of
    the components → (means, variances, logw) float64 numpy."""
    D = feats_list[0].shape[1]
    buckets = [[] for _ in range(num_states)]
    for feats, states in zip(feats_list, state_splits):
        T = len(feats)
        n = len(states)
        bounds = np.linspace(0, T, n + 1).astype(int)
        for i, s in enumerate(states):
            buckets[s].append(feats[bounds[i] : bounds[i + 1]])
    means = np.zeros((num_states, num_comp, D))
    variances = np.ones((num_states, num_comp, D))
    logw = np.full((num_states, num_comp), -np.log(num_comp))
    for s in range(num_states):
        if buckets[s]:
            xs = np.concatenate(buckets[s], axis=0)
        else:
            xs = rng.standard_normal((num_comp, D))
        mu, var = xs.mean(0), xs.var(0) + 1e-2
        for c in range(num_comp):
            pick = xs[rng.integers(0, len(xs))] if len(xs) else mu
            means[s, c] = 0.5 * (mu + pick)
            variances[s, c] = np.maximum(var, 1e-2)
    return means, variances, logw


def _graph_logliks(params, feats, ids):
    ll = gmm.loglik(params, feats)                                    # (U, T, S)
    return torch.gather(ll, 2, ids[:, None, :].expand(-1, ll.shape[1], -1))   # (U, T, L)


def _estep(params, feats, lengths, ids, logA, init, final, num_states):
    """One batched Viterbi-EM E-step → (accumulator, total score).  Tensors
    on one device; lengths a numpy array."""
    ll_graph = _graph_logliks(params, feats, ids)
    paths, scores = vit.viterbi_batch(ll_graph, logA, init, final, lengths)
    gpaths = torch.gather(ids.long(), 1, paths)                       # (U, T) global states
    mask = torch.as_tensor(np.arange(feats.shape[1])[None, :] < lengths[:, None],
                           device=feats.device)
    gamma = torch.nn.functional.one_hot(gpaths, num_states).to(torch.float32) * mask[..., None]
    acc = ml.zero_accum(num_states, params.means.shape[1], params.means.shape[2], feats.device)
    acc = ml.accumulate(params, feats, gamma, acc)
    return acc, torch.sum(torch.where(torch.isfinite(scores), scores, 0.0))


def _estep_bw(params, feats, lengths, ids, logA, init, final, num_states):
    """One batched Baum-Welch (soft forward-backward) E-step, the same
    contract as `_estep` with the exact state posteriors."""
    ll_graph = _graph_logliks(params, feats, ids)
    gamma_l, totals = vit.forward_backward_batch(ll_graph, logA, init, final, lengths)
    onehot = torch.nn.functional.one_hot(ids.long(), num_states).to(torch.float32)  # (U, L, S)
    gamma = torch.einsum("utl,uls->uts", gamma_l, onehot)             # scatter to global states
    acc = ml.zero_accum(num_states, params.means.shape[1], params.means.shape[2], feats.device)
    acc = ml.accumulate(params, feats, gamma, acc)
    return acc, torch.sum(torch.where(torch.isfinite(totals), totals, 0.0))


def estep_inputs(task, feats_list, transcripts, device):
    """The padded corpus and alignment graphs as tensors on `device`:
    (feats, lengths (numpy), ids, logA, init, final)."""
    feats, lengths = pad_corpus(feats_list)
    ids, A, init, final = pad_align_graphs(task, transcripts)
    return (torch.as_tensor(feats, device=device), lengths,
            *(torch.as_tensor(a, device=device) for a in (ids, A, init, final)))


def train(
    task: smallvocab.SmallVocabTask,
    feats_list: list[np.ndarray],
    transcripts: list[list[str]],
    num_comp: int = 2,
    iters: int = 4,
    seed: int = 0,
    verbose: bool = False,
    estep: str = "viterbi",
    device=None,
) -> gmm.GmmParams:
    """Flat-start + `iters` rounds of batched EM (`estep`: viterbi | bw)."""
    if estep not in ("viterbi", "bw"):
        raise ValueError(f"estep must be 'viterbi' or 'bw'; got {estep!r}")
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    state_seqs = [task.align_graph(ws)[0] for ws in transcripts]
    params = gmm.GmmParams(*init_gmm_from_feats(
        [np.asarray(f) for f in feats_list], state_seqs, task.num_states, num_comp, rng)).to(dev)
    inputs = estep_inputs(task, feats_list, transcripts, dev)
    estep_fn = {"viterbi": _estep, "bw": _estep_bw}[estep]
    for it in range(iters):
        acc, total = estep_fn(params, *inputs, task.num_states)
        params = ml.mstep(acc)
        if verbose:
            print(f"iter {it}: total {estep} loglik {float(total):.1f}")
    return params


def decode(task: smallvocab.SmallVocabTask, params: gmm.GmmParams,
           feats_list: list[np.ndarray]) -> list[list[str]]:
    """Batched word-loop Viterbi decode on the device of `params` → word
    sequences."""
    feats, lengths = pad_corpus(feats_list)
    A, init, final = task.decode_graph()
    ll = gmm.loglik(params, torch.as_tensor(feats, device=params.means.device))
    paths, _ = vit.viterbi_batch(ll, np.asarray(A, np.float32), np.asarray(init, np.float32),
                                 np.asarray(final, np.float32), lengths)
    paths = paths.cpu().numpy()
    return [task.path_to_words(paths[u, : lengths[u]]) for u in range(len(feats_list))]
