"""Parameters carried across from the JAX package.

Each function takes the JAX package's parameters as numpy arrays (or
anything `np.asarray` accepts), or its objects read by their attributes,
and returns the port's, so that both packages compute with identical
numbers.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import tree as ptree
from dsr_tpu_torch.asr.adapt import mllr
from dsr_tpu_torch.asr.am.gmm import GmmParams
from dsr_tpu_torch.asr.fsm.packed import PackedGraph
from dsr_tpu_torch.ops.cmfb import CmfbDesign


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


def cmfb_design(d) -> CmfbDesign:
    """`golden.cmfb.CmfbDesign` (ha, hs, M, delay, gain) → the port's, with
    its filters copied as float64 arrays."""
    return CmfbDesign(np.array(d.ha, np.float64), np.array(d.hs, np.float64), int(d.M),
                      int(d.delay), float(d.gain))


def distrib_tree(t) -> ptree.DistribTree:
    """`dsr_tpu.asr.tree.DistribTree` → the port's, node for node (each
    node's `leaf_id`, `question`, `yes`, `no`; the tree's `roots`,
    `num_leaves` and `questions`)."""
    def node(n):
        if n.leaf_id >= 0:
            return ptree._Node(leaf_id=int(n.leaf_id))
        side, cls = n.question
        return ptree._Node(question=(side, frozenset(cls)), yes=node(n.yes), no=node(n.no))

    return ptree.DistribTree({key: node(root) for key, root in t.roots.items()},
                             int(t.num_leaves), {k: set(v) for k, v in t.questions.items()})


def regression_tree(t) -> mllr.RegressionTree:
    """`dsr_tpu.asr.adapt.mllr.RegressionTree` → the port's (arrays copied)."""
    return mllr.RegressionTree(np.array(t.leaf_of, np.int64), np.array(t.parent, np.int64),
                               int(t.n_nodes))


def transform(W, device=None) -> torch.Tensor:
    """An MLLR or fMLLR transform W (..., D, D+1) → float32 tensor."""
    return torch.as_tensor(np.array(W, np.float32), device=device)


def class_transforms(W_node, class_W, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Regression-class MLLR transforms (W_node (n, D, D+1), class_W (G,))
    → (float32 tensor, int64 tensor), as `mllr.estimate_mllr_regclass`
    returns them."""
    return (transform(W_node, device),
            torch.as_tensor(np.array(class_W, np.int64), device=device))
