"""Pipeline parallelism over a `stage` mesh axis (the GPipe schedule).

Counterpart of `dsr_tpu/parallel/pipeline_parallel.py`: layers are split
over the ranks of a stage axis and microbatches flow through them; at step
t stage s processes microbatch t − s (if in range) and sends its
activation to stage s + 1 by a point-to-point hop.

Constraint: `fn(stage_params, x) -> y` must preserve the activation shape
(true for residual-block stacks — Conformer/Transformer layers).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dsr_tpu_torch.parallel.longctx import ppermute


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(mesh: DeviceMesh, stage_axis: str, fn, stage_params, xs: torch.Tensor):
    """Apply the stage composition fn(p[S-1], ... fn(p[1], fn(p[0], x)))
    to each microbatch, pipelined over the ranks of `stage_axis`.

    stage_params: a tree (dicts, lists, tuples) of tensors whose leading
    dimension is n_stages; each rank keeps only its own stage's slice.
    xs: (n_micro, ...) microbatches, the same on every rank.  Returns
    (n_micro, ...) outputs on every rank: the last stage's, summed over the
    stage group (the other stages contribute zeros).
    """
    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    params = _tree_map(lambda a: a[s], stage_params)
    n_micro = xs.shape[0]
    fwd = [(i, i + 1) for i in range(n_stages - 1)]
    ys = torch.zeros_like(xs)
    recv = torch.zeros_like(xs[0])
    for t in range(n_micro + n_stages - 1):
        mb = t - s                                   # my microbatch this step
        act = recv
        if 0 <= mb < n_micro:
            act = fn(params, xs[mb] if s == 0 else recv)
            if s == n_stages - 1:
                ys[mb] = act
        recv = ppermute(act, group, fwd)
    dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=group)
    return ys
