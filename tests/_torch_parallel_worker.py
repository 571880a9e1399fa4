"""Worker of tests/test_torch_parallel_dist.py: one gloo rank of the port's
parallel layer (`dsr_tpu_torch.parallel`) on the CPU.  Run standalone:

    python tests/_torch_parallel_worker.py <rank> <world> <store> <inputs.npz> <outdir> [mode]

The ranks meet through a FileStore at <store> (`file://` rendezvous).
Every input comes from <inputs.npz>, written by the test; imports torch,
numpy and the port only.

mode "run" (4 ranks, one spawn for every case):
  - `make_sharded_decode` on a (data 2, model 2) mesh over two batches of
    two utterances (`dec_a`, `dec_b`), with the token tables; a batch of 3
    utterances must raise ValueError;
  - `psum_accum` of each rank's Baum-Welch E-step over a 4-rank data group;
  - `ring_attention`, `ulysses_attention` (bias and ragged key mask) and
    `exchange_halo` over the subband axis of a (subband 4) mesh, and
    `pipeline_apply` over a 4-rank stage mesh; a `ConformerBlock` with
    `sp_group` over the subband group, and a 4-stage `pipeline_apply` of
    `ConformerBlock`s (`torch.func.functional_call` on each stage's
    weights), the weights converted from flax by the test;
  - `local_block` / `gather_block` of every spec of the sharding table on
    two meshes, and a mesh over part of the world;
  and writes outdir/rank<r>.npz.

mode "dryrun" (4 ranks, tests/test_torch_dryrun.py): the steps of
`entry.dryrun_multichip` that no other worker mode runs, on its 4-rank
(data 2, model 2) mesh: the GMM training step, the subband-sharded front
end (on a (data 2, subband 2) mesh, the 4-rank split has no subband
axis), the Conformer-CTC step (float32) and the joint step (float64) with
the test's converted weights, and the sharded GMM checkpoint under
<outdir>/ckpt with its resumed step; writes outdir/dryrun<r>.npz.

mode "hang" (2 ranks, heartbeat 5 s): rank 1 joins, then sleeps through
the collective; rank 0's all-reduce must raise, and it writes
outdir/drill.json with the error and the seconds it waited.
"""

import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dsr_tpu_torch.config import MeshConfig  # noqa: E402
from dsr_tpu_torch.parallel import make_mesh, sharding  # noqa: E402
from dsr_tpu_torch.parallel.mesh import initialize_distributed  # noqa: E402

MAXD = 16
SPECS = [name for name in dir(sharding) if name.isupper()]


def _layer(p, x):
    return x + torch.tanh(x @ p["W"] + p["b"])          # residual, shape-preserving


def run(rank, inp, out):
    from torch.distributed.device_mesh import DeviceMesh

    from dsr_tpu_torch.asr.am.gmm import GmmParams
    from dsr_tpu_torch.asr.fsm.packed import PackedGraph
    from dsr_tpu_torch.asr.train import ml, trainer
    from dsr_tpu_torch.models.conformer import ConformerBlock
    from dsr_tpu_torch.parallel import longctx
    from dsr_tpu_torch.parallel.decoder import make_sharded_decode
    from dsr_tpu_torch.parallel.pipeline_parallel import pipeline_apply

    res = {}
    t = lambda name: torch.as_tensor(inp[name])  # noqa: E731

    # ---- the graph-sharded decode on (data 2, model 2)
    mesh = make_mesh(MeshConfig(data=2, model=2), "cpu")
    graph = PackedGraph(*(inp["g_" + f] for f in ("src", "pdf", "olabel", "weight", "dst")),
                        int(inp["g_start"]), inp["g_final_weight"], int(inp["g_num_states"]))
    decode = make_sharded_decode(mesh, graph, kcap=int(inp["kcap"]), return_tokens=True)
    for case in ("a", "b"):
        outs = decode(inp[f"ll_{case}"], inp[f"lens_{case}"])
        for name, x in zip(("olabs", "scores", "spill", "ts", "ta", "tsc"), outs):
            res[f"dec_{case}_{name}"] = x.numpy()
    try:
        decode(np.concatenate([inp["ll_a"], inp["ll_a"][:1]]), [5, 5, 5])
        res["uneven_raises"] = False
    except ValueError:
        res["uneven_raises"] = True

    # ---- data-parallel Baum-Welch accumulators
    data = make_mesh(MeshConfig(data=4), "cpu")
    params = GmmParams(t("means"), t("variances"), t("logw"))
    block = lambda x: sharding.local_block(x, data, sharding.FEATURES)  # noqa: E731
    acc, _ = trainer._estep_bw(params, block(t("feats")), block(t("lengths")).numpy(),
                               *(block(t(n)) for n in ("ids", "logA", "init", "final")),
                               int(inp["num_states"]))
    acc = ml.psum_accum(acc, data.get_group("data"))
    res.update(acc_occ=acc.occ.numpy(), acc_sx=acc.sx.numpy(), acc_sxx=acc.sxx.numpy())

    # ---- sequence parallel over the subband axis, pipeline over a stage mesh
    sp = make_mesh(MeshConfig(subband=4), "cpu")
    seq = (None, "subband")
    group = sp.get_group("subband")
    q, k, v, mask = (sharding.local_block(t(n), sp, seq) for n in ("q", "k", "v", "mask"))
    bias = t("bias")
    for name, fn in (("ring", longctx.ring_attention), ("ulysses", longctx.ulysses_attention)):
        o = fn(q, k, v, group, bias, MAXD, kv_mask=mask)
        res[name] = sharding.gather_block(o, sp, seq).numpy()
    halo = longctx.exchange_halo(sharding.local_block(t("hx"), sp, seq), group, 3)
    res["halo"] = sharding.gather_block(halo, sp, seq).numpy()
    stages = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("stage",))
    res["pipe"] = pipeline_apply(stages, "stage", _layer, {"W": t("pW"), "b": t("pb")},
                                 t("pxs")).numpy()
    # a Conformer block with its time split over the group (16 frames a
    # rank), and a 4-stage pipeline of blocks, one block's weights a stage
    weights = lambda prefix: {k[len(prefix):]: t(k) for k in inp.files  # noqa: E731
                              if k.startswith(prefix)}
    blk = ConformerBlock(16, heads=4, sp_group=group, device="cpu")
    blk.load_state_dict(weights("cb_"), strict=True)
    stage_blk = ConformerBlock(16, heads=2, device="cpu")
    with torch.no_grad():
        res["cb_sp"] = sharding.gather_block(blk(sharding.local_block(t("cbx"), sp, seq)), sp,
                                             seq).numpy()
        res["cb_pipe"] = pipeline_apply(
            stages, "stage", lambda p, x: torch.func.functional_call(stage_blk, p, (x,)),
            weights("cbp_"), t("cbxs")).numpy()

    # ---- blocks of every spec, on two meshes and on part of the world
    x = t("blocks")
    for m_name, cfg in (("dm", MeshConfig(data=2, model=2)), ("ds", MeshConfig(data=2,
                                                                               subband=2))):
        m = make_mesh(cfg, "cpu")
        for spec in SPECS:
            local = sharding.local_block(x, m, getattr(sharding, spec))
            res[f"blk_{m_name}_{spec}"] = local.numpy()
            res[f"back_{m_name}_{spec}"] = sharding.gather_block(
                local, m, getattr(sharding, spec)).numpy()
    part = make_mesh(MeshConfig(data=2), "cpu")
    res["part_coord"] = np.asarray(part.get_coordinate() or [-1])
    if part.get_coordinate() is not None:
        res["part_back"] = sharding.gather_block(
            sharding.local_block(x, part, sharding.WAVEFORMS), part, sharding.WAVEFORMS).numpy()
    try:
        make_mesh(MeshConfig(data=8), "cpu")
        res["too_big_raises"] = False
    except ValueError:
        res["too_big_raises"] = True
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def dryrun(rank, inp, out):
    from dsr_tpu_torch import entry
    from dsr_tpu_torch.models.conformer import ConformerCtc
    from dsr_tpu_torch.models.joint import JointBeamformerCtc

    res = {}
    t = lambda name: torch.as_tensor(inp[name])  # noqa: E731
    weights = lambda prefix: {k[len(prefix):]: t(k) for k in inp.files  # noqa: E731
                              if k.startswith(prefix)}
    mesh = make_mesh(entry.mesh_split(4), "cpu")
    gmm_in = {k[4:]: inp[k] for k in inp.files if k.startswith("gmm_")}
    params, acc = entry.gmm_train_step(mesh, gmm_in, entry.gmm_params_block(mesh, gmm_in))
    for name, a in (("means", params.means), ("variances", params.variances),
                    ("logw", params.logweights), ("occ", acc.occ)):
        res[f"gmm_{name}"] = sharding.gather_block(a, mesh, sharding.GMM_PARAMS).numpy()
    resumed, straight = entry.gmm_checkpoint_resume(mesh, gmm_in, params, acc,
                                                    os.path.join(out, "ckpt"))
    res["resume_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        (resumed.means, resumed.variances, resumed.logweights),
        (straight.means, straight.variances, straight.logweights)))
    res["gmm2_means"] = sharding.gather_block(straight.means, mesh, sharding.GMM_PARAMS).numpy()

    fe_mesh = make_mesh(MeshConfig(data=2, subband=2), "cpu")
    Y = entry.frontend_step(fe_mesh, inp["xw"], inp["taus"])
    res["frontend"] = sharding.gather_block(Y, fe_mesh, sharding.BEAMFORMED).numpy()

    model = ConformerCtc(8, dim=32, layers=1, heads=2, device="cpu")
    model.load_state_dict(weights("cf_"), strict=True)
    res["cf_loss"] = entry.conformer_step(mesh, model, torch.optim.Adam(model.parameters(), 1e-3),
                                          inp["Xc"], inp["yc"]).numpy()
    res.update({f"cfg_{k}": p.grad.numpy() for k, p in model.named_parameters()})

    jm = JointBeamformerCtc(4, 64, dim=16, layers=1, heads=2, hidden=16, device="cpu").double()
    jm.load_state_dict({k: v.double() for k, v in weights("jt_").items()}, strict=True)
    res["jt_loss"] = entry.joint_step(mesh, jm, torch.optim.Adam(jm.parameters(), 1e-3),
                                      t("Xj"), inp["yj"]).numpy()
    res.update({f"jtg_{k}": p.grad.numpy() for k, p in jm.named_parameters()})
    np.savez(os.path.join(out, f"dryrun{rank}.npz"), **res)


def main():
    rank, world, store, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    mode = sys.argv[6] if len(sys.argv) > 6 else "run"
    torch.set_num_threads(1)
    # torch 2.13 calls all_gather_into_tensor deprecated; the card's torch
    # has no all_gather_single
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*")
    if mode == "hang":
        initialize_distributed(f"file://{store}", world, rank, heartbeat_timeout_s=5,
                               device="cpu")
        if rank == 1:
            time.sleep(120)          # the peer's all-reduce must fail first
            return
        t0 = time.time()
        try:
            dist.all_reduce(torch.ones(4))
            res = {"raised": False}
        except RuntimeError as e:
            res = {"raised": True, "error": str(e)[:2000]}
        res["seconds"] = time.time() - t0
        with open(os.path.join(out, "drill.json"), "w") as fh:
            json.dump(res, fh)
        os._exit(0)                  # no teardown collective with a dead peer
    initialize_distributed(f"file://{store}", world, rank, heartbeat_timeout_s=60, device="cpu")
    (dryrun if mode == "dryrun" else run)(rank, np.load(inputs), out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
