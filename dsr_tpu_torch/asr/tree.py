"""Phonetic decision trees for context-dependent state tying.

The port's copy of `dsr_tpu/asr/tree.py` (numpy only): triphone state
tying by greedy likelihood-gain splitting on phone-class context
questions.

Stats: per (left, center, right, hmm-position) single-Gaussian sufficient
statistics from a monophone forced alignment.  Splitting: each (center,
position) root is split greedily with questions "is the left/right context
in class Q?", maximising the diagonal-Gaussian log-likelihood gain, until
min_gain / min_count / max_leaves stops.  `lookup` maps any (l, c, r, pos)
— including unseen contexts — to its tied pdf id by walking the tree.

The tree is the reference's leaf for leaf: a near-tie between two
questions is decided by the rounding of the pooled sums, so `build_tree`
pools each node's statistics in the reference's order (left to right,
sequentially, in float64; the statistics are float64, as
`accumulate_tree_stats` makes them).  It stacks each root's statistics
once and pools a subset with `np.cumsum(...)[-1]`, which adds row after
row as Python's `sum` does, where `np.sum`'s pairwise order would not.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# phone classes over the synthetic corpus inventory (+ sil, + BOS/EOS ≈ sil)
DEFAULT_QUESTIONS = {
    "vowel": {"aa", "iy", "uw", "eh", "ow"},
    "front": {"iy", "eh"},
    "back": {"uw", "ow", "aa"},
    "fric": {"sh", "ss"},
    "nasal": {"mm", "nn"},
    "stop": {"kk", "tt"},
    "liquid": {"rr"},
    "sil": {"sil"},
}


def _gauss_ll(count, sx, sxx, floor=1e-3):
    """Max log-likelihood of `count` points under a single diag Gaussian."""
    if count < 1e-6:
        return 0.0
    mu = sx / count
    var = np.maximum(sxx / count - mu**2, floor)
    D = len(sx)
    return -0.5 * count * (np.sum(np.log(2 * np.pi * var)) + D)


@dataclass
class _Node:
    leaf_id: int = -1
    question: tuple | None = None  # ("L"|"R", frozenset)
    yes: "_Node" = None
    no: "_Node" = None


@dataclass
class DistribTree:
    roots: dict = field(default_factory=dict)   # (center, pos) → _Node
    num_leaves: int = 0
    questions: dict = field(default_factory=dict)

    def lookup(self, l: str, c: str, r: str, pos: int) -> int:
        node = self.roots.get((c, pos))
        if node is None:
            return 0
        while node.leaf_id < 0:
            side, cls = node.question
            ctx = l if side == "L" else r
            node = node.yes if ctx in cls else node.no
        return node.leaf_id


def accumulate_tree_stats(alignments, feats_list, phone_seqs, states_per_phone: int):
    """→ stats {(l, c, r, pos): [count, sx, sxx]}.

    alignments: per-utterance frame-level (phone_idx_in_seq, pos) pairs —
    produced by `triphone.context_of_alignment`; phone_seqs: per-utterance
    phone-name sequences (incl. 'sil' entries).
    """
    stats: dict = {}
    for (frames, feats, seq) in zip(alignments, feats_list, phone_seqs):
        for t, (pi, pos) in enumerate(frames):
            c = seq[pi]
            l = seq[pi - 1] if pi > 0 else "sil"
            r = seq[pi + 1] if pi + 1 < len(seq) else "sil"
            key = (l, c, r, pos)
            if key not in stats:
                D = feats.shape[1]
                stats[key] = [0.0, np.zeros(D), np.zeros(D)]
            st = stats[key]
            x = feats[t]
            st[0] += 1.0
            st[1] += x
            st[2] += x * x
    return stats


def _pooled(z, idx):
    """Sequential sums of the rows `idx` (ascending) of z = [count | sx |
    sxx]: Python's `sum` order, → (count, sx, sxx)."""
    tot = np.cumsum(z[idx], axis=0)[-1]
    D = (len(tot) - 1) // 2
    return float(tot[0]), tot[1:1 + D], tot[1 + D:]


def build_tree(
    stats: dict,
    questions: dict | None = None,
    min_gain: float = 50.0,
    min_count: float = 10.0,
    max_leaves: int = 500,
) -> DistribTree:
    questions = DEFAULT_QUESTIONS if questions is None else questions
    tree = DistribTree(questions=questions)
    # group stats by (center, pos), each group's items in the stats' order
    groups: dict = {}
    for (l, c, r, pos), st in stats.items():
        groups.setdefault((c, pos), []).append(((l, r), st))

    def grow(items):
        z = np.asarray([np.concatenate([[s[0]], s[1], s[2]]) for _, s in items], np.float64)
        # per side and question, which items' context is in the class
        member = [(side, cls, np.asarray([(lr[0] if side == "L" else lr[1]) in cls
                                          for lr, _ in items]))
                  for side in ("L", "R") for cls in questions.values()]

        def split(node, idx):
            if tree.num_leaves >= max_leaves:
                node.leaf_id = tree.num_leaves - 1
                return
            base = _gauss_ll(*_pooled(z, idx))
            best = None
            for side, cls, inq in member:
                m = inq[idx]
                yes, no = idx[m], idx[~m]
                if not len(yes) or not len(no):
                    continue
                cy, sy, ssy = _pooled(z, yes)
                cn, sn, ssn = _pooled(z, no)
                if cy < min_count or cn < min_count:
                    continue
                gain = _gauss_ll(cy, sy, ssy) + _gauss_ll(cn, sn, ssn) - base
                if best is None or gain > best[0]:
                    best = (gain, side, cls, yes, no)
            if best is None or best[0] < min_gain:
                node.leaf_id = tree.num_leaves
                tree.num_leaves += 1
                return
            _, side, cls, yes, no = best
            node.question = (side, frozenset(cls))
            node.yes = _Node()
            node.no = _Node()
            split(node.yes, yes)
            split(node.no, no)

        root = _Node()
        split(root, np.arange(len(items)))
        return root

    for key in sorted(groups):
        tree.roots[key] = grow(groups[key])
    return tree
