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


# ---- the models' flax parameters → state_dicts -------------------------------

def _t(a) -> torch.Tensor:
    """A copy of a leaf in its own float dtype (float32; float64 where JAX ran in x64)."""
    return torch.as_tensor(np.array(a))


def _params(p) -> dict:
    """The `params` collection of a flax variables dict (or the dict itself)."""
    return p["params"] if "params" in p else p


def _dense(p, name: str) -> dict:
    # flax kernel (in, out) → torch weight (out, in)
    return {f"{name}.weight": _t(p["kernel"]).T, f"{name}.bias": _t(p["bias"])}


def _dense_heads_in(p, name: str) -> dict:
    # DenseGeneral kernel (dim, H, dh), bias (H, dh) → Linear(dim, H·dh)
    k = _t(p["kernel"])
    return {f"{name}.weight": k.reshape(k.shape[0], -1).T, f"{name}.bias": _t(p["bias"]).flatten()}


def _dense_heads_out(p, name: str) -> dict:
    # DenseGeneral kernel (H, dh, dim) over axes (-2, -1) → Linear(H·dh, dim)
    k = _t(p["kernel"])
    return {f"{name}.weight": k.reshape(-1, k.shape[-1]).T, f"{name}.bias": _t(p["bias"])}


def _layer_norm(p, name: str) -> dict:
    return {f"{name}.weight": _t(p["scale"]), f"{name}.bias": _t(p["bias"])}


def _conv(p, name: str) -> dict:
    # flax kernel (*spatial, in / groups, out) → torch (out, in / groups, *spatial);
    # both are cross-correlations, so nothing is flipped
    k = _t(p["kernel"])
    return {f"{name}.weight": k.permute(k.dim() - 1, k.dim() - 2, *range(k.dim() - 2)),
            f"{name}.bias": _t(p["bias"])}


def _attention(p, name: str) -> dict:
    ln = "ln" if "ln" in p else "LayerNorm_0"        # the streaming model names its LayerNorm
    return {**_layer_norm(p[ln], f"{name}.ln"),
            **{k: v for n in "qkv" for k, v in _dense_heads_in(p[n], f"{name}.{n}").items()},
            f"{name}.rel_bias": _t(p["rel_bias"]), **_dense_heads_out(p["o"], f"{name}.o")}


def _feed_forward(p, name: str) -> dict:
    return {**_layer_norm(p["LayerNorm_0"], f"{name}.ln"), **_dense(p["Dense_0"], f"{name}.up"),
            **_dense(p["Dense_1"], f"{name}.down")}


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def conformer_block(params) -> dict:
    """`dsr_tpu.models.conformer.ConformerBlock` params → `ConformerBlock` state_dict."""
    p = _params(params)
    c = p["ConvModule_0"]
    return {**_feed_forward(p["FeedForward_0"], "ff1"),
            **_attention(p["RelPosSelfAttention_0"], "att"),
            **_layer_norm(c["LayerNorm_0"], "conv.ln"), **_dense(c["Dense_0"], "conv.pw_in"),
            **_conv(c["Conv_0"], "conv.dw"), **_layer_norm(c["LayerNorm_1"], "conv.post_ln"),
            **_dense(c["Dense_1"], "conv.pw_out"),
            **_feed_forward(p["FeedForward_1"], "ff2"), **_layer_norm(p["LayerNorm_0"], "ln")}


def conformer_ctc(params) -> dict:
    """`dsr_tpu.models.conformer.ConformerCtc` params → `ConformerCtc` state_dict."""
    p = _params(params)
    sd = {**_conv(p["Conv_0"], "sub1"), **_conv(p["Conv_1"], "sub2"),
          **_dense(p["Dense_0"], "sub_out"), **_dense(p["Dense_1"], "out")}
    n = sum(k.startswith("ConformerBlock_") for k in p)
    for i in range(n):
        sd.update(_prefixed(conformer_block(p[f"ConformerBlock_{i}"]), f"blocks.{i}."))
    return sd


def streaming_conformer(params) -> dict:
    """`dsr_tpu.models.streaming_conformer.StreamingConformerCtc` params →
    `StreamingConformerCtc` state_dict (flax's `ff1s_0` is `ff1s.0`)."""
    p = _params(params)
    sd = {**_conv(p["sub1"], "sub1"), **_conv(p["sub2"], "sub2"),
          **_dense(p["sub_out"], "sub_out"), **_layer_norm(p["sub_ln"], "sub_ln"),
          **_dense(p["out"], "out")}
    per_layer = {"ff1s": _feed_forward, "atts": _attention, "conv_lns": _layer_norm,
                 "conv_ins": _dense, "conv_dws": _conv, "conv_post_lns": _layer_norm,
                 "conv_outs": _dense, "ff2s": _feed_forward, "block_lns": _layer_norm}
    n = sum(k.startswith("ff1s_") for k in p)
    for i in range(n):
        for name, fn in per_layer.items():
            sd.update(fn(p[f"{name}_{i}"], f"{name}.{i}"))
    return sd


def neural_beamformer(params) -> dict:
    """`dsr_tpu.models.neural_beamformer.NeuralBeamformer` params →
    `NeuralBeamformer` state_dict."""
    m = _params(params)["MaskEstimator_0"]
    return {**_dense(m["Dense_0"], "mask.inp"), **_conv(m["Conv_0"], "mask.conv1"),
            **_conv(m["Conv_1"], "mask.conv2"), **_dense(m["speech"], "mask.speech"),
            **_dense(m["noise"], "mask.noise")}


def joint(params) -> dict:
    """`dsr_tpu.models.joint.JointBeamformerCtc` (or `OracleMvdrCtc`)
    params → the port's state_dict: `frontend.*` and `am.*`."""
    p = _params(params)
    sd = _prefixed(conformer_ctc(p["am"]), "am.")
    if "frontend" in p:
        sd.update(_prefixed(neural_beamformer(p["frontend"]), "frontend."))
    return sd
