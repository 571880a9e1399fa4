"""MLLR mean-transform adaptation (PyTorch).

Counterpart of `dsr_tpu/asr/adapt/mllr.py`.  Per regression class, the
mean transform W (D × D+1) maximising the EM auxiliary for
diagonal-covariance GMMs has the classic row-wise closed form: for each
dim d,   w_d = G_d⁻¹ k_d   with
    G_d = Σ_g occ_g / σ²_{g,d} · ξ_g ξ_gᵀ          (ξ_g = [1, μ_g])
    k_d = Σ_g sx_{g,d} / σ²_{g,d} · ξ_g
computed straight from the standard ML accumulators (occ, Σγx) that
`train.ml.accumulate` produces.  Adapted means: μ' = W ξ.  The sums are
float32 einsums over the (S·C) Gaussians on the device of the parameters;
the D row-solves are one batched `torch.linalg.solve`.

Regression classes: Gaussians are clustered into a binary regression tree
by acoustic similarity of their means (geometric 2-means splits, the
largest-occupancy leaf split first); each leaf with enough adaptation data
gets its own W, data-poor leaves back off to the closest ancestor with
sufficient occupancy — the root is the global transform.  Building the
tree and aggregating its statistics up the tree are host numpy, as in the
reference; the per-leaf statistics and the application are einsums over
(G, L) one-hot class masks on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsr_tpu_torch.asr.am.gmm import GmmParams
from dsr_tpu_torch.asr.train.ml import GmmAccum


def _xi(params: GmmParams) -> torch.Tensor:
    """ξ_g = [1, μ_g] over the G = S·C Gaussians → (G, D+1)."""
    mu = params.means.reshape(-1, params.means.shape[-1])
    ones = torch.ones((mu.shape[0], 1), dtype=mu.dtype, device=mu.device)
    return torch.cat([ones, mu], dim=1)


def _gaussians(params: GmmParams, acc: GmmAccum):
    """→ (ξ (G, D+1), 1/σ² (G, D), occ (G,), sx (G, D))."""
    D = params.means.shape[-1]
    return (_xi(params), (1.0 / params.variances).reshape(-1, D), acc.occ.reshape(-1),
            acc.sx.reshape(-1, D))


def estimate_mllr(params: GmmParams, acc: GmmAccum, reg: float = 1e-4) -> torch.Tensor:
    """→ W (D, D+1) global-class MLLR mean transform."""
    xi, inv_v, occ, sx = _gaussians(params, acc)
    D = sx.shape[1]
    Gd = torch.einsum("g,gd,gi,gj->dij", occ, inv_v, xi, xi)
    kd = torch.einsum("gd,gd,gi->di", sx, inv_v, xi)
    Gd = Gd + reg * torch.eye(D + 1, dtype=Gd.dtype, device=Gd.device)
    return torch.linalg.solve(Gd, kd[..., None])[..., 0]


def apply_mllr(params: GmmParams, W: torch.Tensor) -> GmmParams:
    """Transform all means: μ' = W [1, μ]."""
    return GmmParams((_xi(params) @ W.T).reshape(params.means.shape), params.variances,
                     params.logweights)


class RegressionTree(NamedTuple):
    leaf_of: np.ndarray    # (G,) leaf NODE id per Gaussian
    parent: np.ndarray     # (n_nodes,) parent node id; root 0 has -1
    n_nodes: int

    @property
    def leaves(self) -> np.ndarray:
        return np.unique(self.leaf_of)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_regression_tree(params: GmmParams, occ, n_leaves: int = 4,
                          iters: int = 10, seed: int = 0) -> RegressionTree:
    """Occupancy-weighted binary splitting of the Gaussian means into
    `n_leaves` regression classes; returns the full tree for back-off."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1 (got {iters}): the 2-means "
                         "refinement defines the split assignment")
    S, C, D = params.means.shape
    mu = _host(params.means).reshape(S * C, D)
    w = np.maximum(_host(occ).reshape(S * C), 1e-8)
    rng = np.random.default_rng(seed)
    node_of = np.zeros(len(mu), np.int64)      # current leaf node per gauss
    parent = [-1]
    leaf_nodes = [0]

    def split(idx):
        """UNWEIGHTED 2-means of mu[idx] → boolean right-half mask.
        Clustering is geometric on purpose: classes encode acoustic
        similarity; occupancy decides only split order and back-off
        (weighting here makes k-means bisect the data-RICH cluster,
        mixing acoustically distant low-count Gaussians into it)."""
        x = mu[idx]
        m = x.mean(axis=0)
        d = x - m
        v = d[np.argmax(np.einsum("gd,gd->g", d, d))]
        c = np.stack([m - 0.5 * v, m + 0.5 * v])
        for _ in range(iters):
            assign = (np.linalg.norm(x - c[0], axis=1)
                      > np.linalg.norm(x - c[1], axis=1))
            for h in (0, 1):
                sel = assign == bool(h)
                if sel.any():
                    c[h] = x[sel].mean(axis=0)
        if assign.all() or not assign.any():    # degenerate: force a split
            assign = np.zeros(len(idx), bool)
            assign[rng.permutation(len(idx))[: len(idx) // 2]] = True
        return assign

    while len(leaf_nodes) < n_leaves:
        occs = [w[node_of == ln].sum() if (node_of == ln).sum() > 1 else -1.0
                for ln in leaf_nodes]
        pick = int(np.argmax(occs))
        if occs[pick] <= 0:
            break                                # nothing splittable left
        ln = leaf_nodes.pop(pick)
        idx = np.nonzero(node_of == ln)[0]
        right = split(idx)
        a, b = len(parent), len(parent) + 1
        parent.extend([ln, ln])
        node_of[idx[~right]] = a
        node_of[idx[right]] = b
        leaf_nodes.extend([a, b])
    return RegressionTree(node_of, np.asarray(parent), len(parent))


def _node_stats(params: GmmParams, acc: GmmAccum, leaf_onehot: torch.Tensor):
    """Per-LEAF MLLR statistics (G_d, k_d, occ) via one masked einsum per
    quantity; ancestors aggregate these on the host (the tree is tiny)."""
    xi, inv_v, occ, sx = _gaussians(params, acc)
    Gd = torch.einsum("gl,g,gd,gi,gj->ldij", leaf_onehot, occ, inv_v, xi, xi)
    kd = torch.einsum("gl,gd,gd,gi->ldi", leaf_onehot, sx, inv_v, xi)
    o = torch.einsum("gl,g->l", leaf_onehot, occ)
    return Gd, kd, o


def estimate_mllr_regclass(params: GmmParams, acc: GmmAccum,
                           tree: RegressionTree, min_occ: float = 100.0,
                           reg: float = 1e-4):
    """Per-regression-class MLLR transforms with occupancy back-off.

    Returns (W_node (n_nodes, D, D+1) float32, class_W (G,) int64: the node
    whose W each Gaussian uses), on the device of the parameters.  A leaf
    with occ ≥ min_occ gets its own transform; otherwise it walks up the
    tree to the first ancestor with enough occupancy (the root aggregates
    everything = the global transform)."""
    dev = params.means.device
    leaves = tree.leaves
    L = len(leaves)
    leaf_pos = {int(l): i for i, l in enumerate(leaves)}
    oh = np.zeros((len(tree.leaf_of), L), np.float32)
    oh[np.arange(len(tree.leaf_of)),
       [leaf_pos[int(l)] for l in tree.leaf_of]] = 1.0
    Gd_l, kd_l, occ_l = map(_host, _node_stats(params, acc, torch.as_tensor(oh, device=dev)))
    D = kd_l.shape[-1] - 1
    # aggregate leaf stats to every ancestor node (float32, as they came)
    Gd_n = np.zeros((tree.n_nodes,) + Gd_l.shape[1:], Gd_l.dtype)
    kd_n = np.zeros((tree.n_nodes,) + kd_l.shape[1:], kd_l.dtype)
    occ_n = np.zeros(tree.n_nodes, occ_l.dtype)
    for i, ln in enumerate(leaves):
        node = int(ln)
        while node >= 0:
            Gd_n[node] += Gd_l[i]
            kd_n[node] += kd_l[i]
            occ_n[node] += occ_l[i]
            node = int(tree.parent[node])
    Gd_n = Gd_n + reg * np.eye(D + 1)[None, None]             # float64 from here
    W_node = np.linalg.solve(Gd_n, kd_n[..., None])[..., 0]  # (n, D, D+1)
    # back-off: node used by each leaf
    use = {}
    for ln in leaves:
        node = int(ln)
        while tree.parent[node] >= 0 and occ_n[node] < min_occ:
            node = int(tree.parent[node])
        use[int(ln)] = node
    class_W = np.asarray([use[int(l)] for l in tree.leaf_of], np.int64)
    return (torch.as_tensor(W_node.astype(np.float32), device=dev),
            torch.as_tensor(class_W, device=dev))


def apply_mllr_regclass(params: GmmParams, W_node: torch.Tensor,
                        class_W: torch.Tensor) -> GmmParams:
    """μ'_g = W_{class(g)} [1, μ_g] — per-Gaussian transform selection."""
    mu2 = torch.einsum("gdi,gi->gd", W_node[class_W.long()], _xi(params))
    return GmmParams(mu2.reshape(params.means.shape), params.variances, params.logweights)
