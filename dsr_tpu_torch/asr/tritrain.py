"""Tied-triphone acoustic-model training from audio (PyTorch).

The port's copy of `dsr_tpu/asr/tritrain.py`, the workflow the system
ships:

    monophone EM  →  forced alignment  →  per-context tree statistics
    →  likelihood-gain state tying (asr/tree.py)  →  tied-triphone EM
    (Viterbi or Baum-Welch realignment per iteration)  →  triphone HCLG
    decode.

The monophone alignments go through `asr.path.force_align` (on a CUDA
tensor each chain is one launch of the banded Viterbi kernel); the tied
E-step reuses `train.trainer`'s batched EM, whose alignment graphs are
linear chains over the tied leaf ids, padded to one (U, L_max) batch.
Both run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dsr_tpu_torch.asr import path as apath
from dsr_tpu_torch.asr import phone_task
from dsr_tpu_torch.asr import tree as ptree
from dsr_tpu_torch.asr import triphone
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.train import trainer
from dsr_tpu_torch.utils.device import resolve

LOG0 = phone_task.LOG0


class TriAlignTask:
    """trainer.train-compatible task over TIED triphone pdfs.

    `align_graph(words)` returns a linear chain whose state ids are the
    decision-tree leaves of the utterance's (left, center, right, pos)
    contexts — the tied-state analogue of PhoneTask's monophone chains,
    so the same batched EM trains tied-triphone GMMs with per-iteration
    realignment.
    """

    def __init__(self, base: phone_task.PhoneTask, tree: ptree.DistribTree):
        self.base = base
        self.tree = tree
        self.spp = base.spp
        self.self_lp = base.self_lp
        self.num_states = tree.num_leaves

    def phone_seq(self, words: list[str]) -> list[str]:
        seq = ["sil"]
        for w in words:
            seq.extend(self.base.lexicon[w])
            seq.append("sil")
        return seq

    def align_graph(self, words: list[str]):
        seq = self.phone_seq(words)
        ids = []
        for i, ph in enumerate(seq):
            l = seq[i - 1] if i > 0 else "sil"
            r = seq[i + 1] if i + 1 < len(seq) else "sil"
            for pos in range(self.spp):
                ids.append(self.tree.lookup(l, ph, r, pos))
        ids = np.asarray(ids, np.int32)
        L = len(ids)
        A = np.full((L, L), LOG0, np.float32)
        adv = float(np.log1p(-np.exp(self.self_lp)))
        for i in range(L):
            A[i, i] = self.self_lp
            if i + 1 < L:
                A[i, i + 1] = adv
        init = np.full(L, LOG0, np.float32)
        init[0] = 0.0
        final = np.full(L, LOG0, np.float32)
        final[L - 1] = 0.0
        return ids, A, init, final


@dataclass
class TriSystem:
    tree: ptree.DistribTree
    params: gmm.GmmParams            # tied-leaf GMMs
    task: TriAlignTask
    stats_contexts: int               # distinct (l,c,r,pos) seen in data


def train_tied_triphone(
    base_task: phone_task.PhoneTask,
    mono_params: gmm.GmmParams,
    feats_list: list[np.ndarray],
    transcripts: list[list[str]],
    questions: dict | None = None,
    min_gain: float = 30.0,
    min_count: float = 20.0,
    max_leaves: int = 500,
    num_comp: int = 2,
    iters: int = 3,
    estep: str = "viterbi",
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> TriSystem:
    """The full data-driven tying + training pass (module docstring).

    Tree statistics are accumulated from MONOPHONE forced alignments of
    the training audio (never analytic); the tied GMMs are then estimated
    by `iters` rounds of batched EM over tied-leaf alignment chains, on
    `device` (the card by default; the monophone parameters are copied
    there).
    """
    dev = resolve(device)
    mono_params = gmm.GmmParams(mono_params.means, mono_params.variances,
                                mono_params.logweights).to(dev)
    aligns, seqs = [], []
    for f, ws in zip(feats_list, transcripts):
        al = apath.force_align(base_task, mono_params, f, ws)
        seq = ["sil"]
        for w in ws:
            seq.extend(base_task.lexicon[w])
            seq.append("sil")
        frames = triphone.context_of_alignment(al.segments, len(seq),
                                               base_task.spp)
        if len(frames) != len(f):
            raise RuntimeError(
                f"alignment covers {len(frames)} frames of {len(f)}")
        aligns.append(frames)
        seqs.append(seq)
    stats = ptree.accumulate_tree_stats(aligns, feats_list, seqs,
                                        base_task.spp)
    tree = ptree.build_tree(stats, questions=questions, min_gain=min_gain,
                            min_count=min_count, max_leaves=max_leaves)
    task = TriAlignTask(base_task, tree)
    if verbose:
        print(f"tree: {len(stats)} contexts → {tree.num_leaves} tied leaves")
    params = trainer.train(task, feats_list, transcripts, num_comp=num_comp,
                           iters=iters, seed=seed, verbose=verbose,
                           estep=estep, device=dev)
    return TriSystem(tree, params, task, len(stats))
