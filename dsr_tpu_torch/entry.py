"""Driver entry points: the single-device forward of the flagship front end,
and the multi-rank dry run.

`entry()` is the counterpart of `__graft_entry__._pipeline_fn`: an
8-channel circular array (radius 0.10 m), filterbank M=256 m=4 r=2,
superdirective MVDR towards (0, 2, 0) m, subband MFCC + CMN, and
diagonal-GMM log-likelihoods for 16 states of 2 components.  The GMM
parameters and the input come from the same seeded numpy generator, drawn
in the same order, so both packages compute with identical numbers.

    fwd, (x,) = entry()          # on the card; entry("cpu") for the CPU
    ll = fwd(x)                  # (T, 16) log-likelihoods

`dryrun_multichip(n)` is the counterpart of `__graft_entry__.dryrun_multichip`:
n ranks (NCCL on cards, gloo for `device="cpu"`) over a (data, model,
subband) mesh run the GMM training step, the graph-sharded decodes, the
subband-sharded front end, the Conformer-CTC and joint data-parallel
steps, the sequence- and pipeline-parallel blocks and a sharded
checkpoint of the trained GMM, restored and continued.  Each part is a
named step function of a mesh, so a caller can run the parts alone.

    dryrun_multichip(1)          # one rank on the card
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dsr_tpu_torch.asr import lvcsr, smallvocab
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import viterbi as vit
from dsr_tpu_torch.asr.train import ml, trainer
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig, MeshConfig
from dsr_tpu_torch.models import conformer as cfm
from dsr_tpu_torch.models import joint as mj
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.parallel import make_mesh
from dsr_tpu_torch.parallel import sharding as shd
from dsr_tpu_torch.parallel.decoder import make_sharded_decode
from dsr_tpu_torch.parallel.mesh import axis_size, initialize_distributed, mesh_device
from dsr_tpu_torch.parallel.pipeline_parallel import pipeline_apply
from dsr_tpu_torch.utils import checkpoint, corpus, profiling
from dsr_tpu_torch.utils.design import get_prototypes, steering_delays
from dsr_tpu_torch.utils.device import resolve


@dataclass
class Forward:
    """x_multi (N, S) waveforms → (T, S_states) acoustic log-likelihoods."""

    cfg: FilterbankConfig
    hf: torch.Tensor               # (L,) float32 analysis prototype
    w: torch.Tensor                # (K, N) complex64 MVDR weights
    params: gmm.GmmParams
    sample_rate: float

    def __call__(self, x_multi: torch.Tensor) -> torch.Tensor:
        A = fb.analysis(x_multi, self.cfg, self.hf)
        Y = bf.apply_weights(A, self.w)
        feats = ft.cmn(ft.mfcc_from_subbands(Y, self.cfg.M, self.sample_rate))
        return gmm.loglik(self.params, feats)


def _pipeline_fn(device=None) -> tuple[Forward, tuple[torch.Tensor]]:
    dev = resolve(device)
    SR = 16000.0
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (steering_delays(POS, np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR).astype(np.float32)
    hf, _, _ = get_prototypes(cfg)
    rng = np.random.default_rng(0)
    S_states, C, D = 16, 2, 13
    params = gmm.GmmParams(
        rng.standard_normal((S_states, C, D)),
        0.5 + rng.random((S_states, C, D)),
        np.log(np.full((S_states, C), 1.0 / C)),
    ).to(dev)
    Gamma = bf.diffuse_coherence(POS, cfg.M, SR, 343.0, dev)
    v = bf.steering_vectors(torch.as_tensor(taus, device=dev), cfg.M, SR)
    w = bf.mvdr_weights(v, Gamma, 1e-2)
    hf_t = torch.as_tensor(np.asarray(hf, np.float32), device=dev)
    x = rng.standard_normal((8, 16000)).astype(np.float32)
    return Forward(cfg, hf_t, w, params, SR), (torch.as_tensor(x, device=dev),)


def entry(device=None) -> tuple[Forward, tuple[torch.Tensor]]:
    """(forward, (x,)): the forward and its seeded 8 × 16000 input."""
    return _pipeline_fn(device)


# ---- the multi-rank dry run ----------------------------------------------

DRY_FB = FilterbankConfig(M=64, m=2, r=2)


def mesh_split(n: int):
    """The (data, model, subband) split of n ranks, as the JAX dry run takes it."""
    if n >= 8:
        return MeshConfig(2, 2, n // 4)
    if n >= 4:
        return MeshConfig(2, 2, 1)
    return MeshConfig(max(1, n), 1, 1)


def gmm_inputs(dp: int, device=None) -> dict:
    """The dry run's GMM corpus: 2·dp utterances of 1–2 words over the first
    4 words (seed 0), the first 0.5 s of each through the M = 64 analysis,
    MFCC + CMN; padded features and alignment graphs, and the flat-start
    GMMs (2 components, `default_rng(0)`) as float32 numpy arrays."""
    dev = resolve(device)
    task = smallvocab.SmallVocabTask(corpus.VOCAB[:4])
    feats, words = [], []
    for ws, x in corpus.make_corpus(2 * dp, min_words=1, max_words=2, seed=0):
        A = fb.analysis(torch.as_tensor(np.asarray(x[:8000], np.float32), device=dev), DRY_FB)
        feats.append(ft.cmn(ft.mfcc_from_subbands(A, DRY_FB.M, 16000.0)).cpu().numpy())
        words.append([w if w in task.vocab else task.vocab[0] for w in ws])
    f, lens = trainer.pad_corpus(feats)
    ids, logA, init, final = trainer.pad_align_graphs(task, words)
    means, variances, logw = trainer.init_gmm_from_feats(
        feats, [task.align_graph(ws)[0] for ws in words], task.num_states, 2,
        np.random.default_rng(0))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(feats=f, lengths=lens, ids=ids, logA=logA, init=init, final=final,
                means=f32(means), variances=f32(variances), logw=f32(logw),
                num_states=task.num_states)


def gmm_params_block(mesh, inp: dict):
    """This rank's block over `model` of the flat-start GMMs, the state axis
    padded to a multiple of the model size (means 0, variances 1, log
    weights −1e5 on the padding)."""
    tp = axis_size(mesh, "model")
    S0 = int(inp["num_states"])
    pad = -(-S0 // tp) * tp - S0
    padded = (np.pad(inp["means"], ((0, pad), (0, 0), (0, 0))),
              np.pad(inp["variances"], ((0, pad), (0, 0), (0, 0)), constant_values=1.0),
              np.pad(inp["logw"], ((0, pad), (0, 0)), constant_values=-1e5))
    dev = mesh_device(mesh)
    return gmm.GmmParams(*(shd.local_block(torch.as_tensor(a, device=dev), mesh,
                                           shd.GMM_PARAMS) for a in padded))


def gmm_train_step(mesh, inp: dict, params: gmm.GmmParams):
    """One GMM training step over the mesh: this rank's utterances (over
    `data`) are force-aligned with the full GMMs (gathered over `model`),
    accumulated into this rank's block of states, the accumulators summed
    over `data` (`psum_accum`), and the M-step run on the block.
    → (new params block, accumulator block)."""
    dev = mesh_device(mesh)
    S0 = int(inp["num_states"])
    S_pad = -(-S0 // axis_size(mesh, "model")) * axis_size(mesh, "model")
    mine = lambda name: shd.local_block(torch.as_tensor(inp[name], device=dev),  # noqa: E731
                                        mesh, shd.FEATURES)
    feats, ids, logA, init, final = (mine(n) for n in ("feats", "ids", "logA", "init", "final"))
    lengths = shd.local_block(torch.as_tensor(inp["lengths"]), mesh, shd.FEATURES).numpy()
    full = gmm.GmmParams(*(shd.gather_block(a, mesh, shd.GMM_PARAMS) for a in
                           (params.means, params.variances, params.logweights)))
    ll = gmm.loglik(full, feats)[..., :S0]
    ll_graph = torch.gather(ll, 2, ids.long()[:, None, :].expand(-1, ll.shape[1], -1))
    paths, _ = vit.viterbi_batch(ll_graph, logA, init, final, lengths)
    gpaths = torch.gather(ids.long(), 1, paths)
    mask = torch.as_tensor(np.arange(feats.shape[1])[None, :] < lengths[:, None], device=dev)
    gamma = torch.nn.functional.one_hot(gpaths, S_pad).to(torch.float32) * mask[..., None]
    gamma = shd.local_block(gamma, mesh, (None, None, "model"))         # this rank's states
    acc = ml.zero_accum(*params.means.shape, device=dev)
    acc = ml.psum_accum(ml.accumulate(params, feats, gamma, acc), mesh.get_group("data"))
    return ml.mstep(acc), acc


def gmm_checkpoint_resume(mesh, inp: dict, params: gmm.GmmParams, acc, path: str):
    """Save the trained GMM block and its accumulators as a sharded
    checkpoint (layout `GMM_PARAMS`), restore them into fresh blocks, and
    take the next step from both → (resumed params, uninterrupted params)."""
    checkpoint.save_sharded(path, {"params": params, "acc": acc}, mesh, shd.GMM_PARAMS)
    if dist.is_initialized():
        dist.barrier()
    blank = {"params": gmm.GmmParams(*(torch.zeros_like(a) for a in
                                       (params.means, params.variances, params.logweights))),
             "acc": ml.GmmAccum(*(torch.zeros_like(a) for a in acc))}
    restored = checkpoint.restore_sharded(path, blank, mesh, shd.GMM_PARAMS)
    same = all(torch.equal(a, b) for a, b in zip(
        (*restored["acc"], restored["params"].means, restored["params"].logweights),
        (*acc, params.means, params.logweights)))
    if not same:
        raise RuntimeError("dryrun: the restored GMM checkpoint differs from the saved one")
    return gmm_train_step(mesh, inp, restored["params"])[0], gmm_train_step(mesh, inp, params)[0]


def sharded_decode(mesh, graph, U: int, T: int, kcap: int, beam: float):
    """`make_sharded_decode` of `graph` on N(0, 1) scores (U, T, P) from
    `default_rng(1)` → (olabels, scores, spill frames)."""
    P = int(graph.pdf.max()) + 1
    ll = np.random.default_rng(1).standard_normal((U, T, P)).astype(np.float32)
    return make_sharded_decode(mesh, graph, kcap=min(kcap, graph.num_states), beam=beam)(
        ll, np.full(U, T))


def frontend_step(mesh, xw: np.ndarray, taus: np.ndarray) -> torch.Tensor:
    """The subband-sharded front end: this rank's utterances of xw (U, N, S)
    through the analysis kernel, this rank's subband block of the (U, N, T,
    K) snapshots, delay-and-sum weights towards `taus` → this rank's block
    of the beamformed subbands under `BEAMFORMED` (U / data, T, K /
    subband)."""
    dev = mesh_device(mesh)
    x = shd.local_block(torch.as_tensor(xw, device=dev), mesh, shd.WAVEFORMS)
    A = fb.analysis(x, DRY_FB)
    A = shd.local_block(A, mesh, (None, None, None, "subband"))
    v = bf.steering_vectors(torch.as_tensor(taus, device=dev), DRY_FB.M, 16000.0)
    return bf.apply_weights(A, bf.ds_weights(shd.local_block(v, mesh, shd.BEAM_WEIGHTS)))


def _mean_over_data(mesh, t: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(t, group=mesh.get_group("data"))
    return t.div_(axis_size(mesh, "data"))


def conformer_step(mesh, model, optimizer, X: np.ndarray, labels: np.ndarray) -> torch.Tensor:
    """One data-parallel Conformer-CTC step: this rank's utterances of X
    (B, T, 13) with labels (B, L) (every label counted), the gradients
    averaged over `data` (equal blocks: the gradient of the batch mean),
    then the optimiser's step → the batch's mean loss (before the step)."""
    dev = next(model.parameters()).device
    Xl = shd.local_block(torch.as_tensor(X, device=dev), mesh, shd.CONFORMER_ACTS)
    yl = shd.local_block(torch.as_tensor(labels), mesh, shd.TOKENS)
    optimizer.zero_grad()
    logits = model(Xl)
    B, T = logits.shape[:2]
    loss = cfm.ctc_loss(logits, torch.full((B,), T), yl, torch.full((B,), yl.shape[1]))
    loss.backward()
    for p in model.parameters():
        _mean_over_data(mesh, p.grad)
    optimizer.step()
    return _mean_over_data(mesh, loss.detach())


def joint_step(mesh, model, optimizer, X: torch.Tensor, labels: np.ndarray) -> torch.Tensor:
    """One data-parallel step of the joint mask-MVDR + Conformer-CTC model:
    this rank's utterances of the subbands X (U, N, T, K), the gradients
    averaged over `data`, clipped to a global norm of 1, then the
    optimiser's step → the batch's mean loss (before the step)."""
    Xl = shd.local_block(X, mesh, shd.SUBBAND_SNAPSHOTS[:1])
    yl = shd.local_block(torch.as_tensor(labels), mesh, shd.TOKENS)
    optimizer.zero_grad()
    logits = model(Xl)
    B, T = logits.shape[:2]
    loss = cfm.ctc_loss(logits, torch.full((B,), T), yl, torch.full((B,), yl.shape[1]))
    loss.backward()
    for p in model.parameters():
        _mean_over_data(mesh, p.grad)
    mj.apply_gradients(model, optimizer, clip_norm=1.0)
    return _mean_over_data(mesh, loss.detach())


def sequence_parallel_block(mesh, X: np.ndarray) -> float:
    """A `ConformerBlock` (dim 32) with its time axis split over `subband`
    against the dense block with the same weights → the largest absolute
    difference of the gathered output."""
    dev = mesh_device(mesh)
    dense = cfm.ConformerBlock(32, heads=2, device=dev,
                               generator=torch.Generator().manual_seed(2))
    sp = cfm.ConformerBlock(32, heads=2, sp_group=mesh.get_group("subband"), device=dev)
    sp.load_state_dict(dense.state_dict())
    x = torch.as_tensor(X, device=dev)
    seq = (None, "subband")
    with torch.no_grad():
        y = shd.gather_block(sp(shd.local_block(x, mesh, seq)), mesh, seq)
        return float((y - dense(x)).abs().max())


def pipeline_block(mesh) -> float:
    """A residual tanh layer a stage, pipelined over the `model` ranks (3
    microbatches) against the stages applied in turn → the largest
    absolute difference."""
    dev = mesh_device(mesh)
    tp, D = axis_size(mesh, "model"), 16
    rng = np.random.default_rng(5)
    p = {"W": torch.as_tensor(rng.standard_normal((tp, D, D)) * 0.3, dtype=torch.float32,
                              device=dev),
         "b": torch.as_tensor(rng.standard_normal((tp, D)) * 0.1, dtype=torch.float32,
                              device=dev)}
    xs = torch.as_tensor(rng.standard_normal((3, 2, D)), dtype=torch.float32, device=dev)

    def layer(q, x):
        return x + torch.tanh(x @ q["W"] + q["b"])

    ys = pipeline_apply(mesh, "model", layer, p, xs)
    ref = xs
    for s in range(tp):
        ref = layer({k: v[s] for k, v in p.items()}, ref)
    return float((ys - ref).abs().max())


def shard_bytes(graph, n: int) -> int:
    """Bytes of one of n shards' token tables (`shard_token_graph`'s
    ceil(S/n) rows of a_max int32 pdf, olabel, dst and float32 weight
    slots, and a float32 final weight)."""
    a_max = max(1, int(np.bincount(graph.src, minlength=graph.num_states).max()))
    return -(-graph.num_states // n) * (16 * a_max + 4)


def _launches() -> dict[str, int]:
    """This process's kernel launches so far, by kernel (the wrappers' counters)."""
    return {k: n for k, n in profiling.launches().items() if n}


def _dryrun_rank(rank: int, n: int, device_type: str, store: str, out: str) -> None:
    """One rank of `dryrun_multichip`: every step in order; rank 0 writes
    the summary (with its kernel launches) to `out`."""
    initialize_distributed(f"file://{store}/rendezvous", n, rank, heartbeat_timeout_s=1800,
                           device=device_type, always=True)
    try:
        cfg = mesh_split(n)
        mesh = make_mesh(cfg, device_type)
        dev = mesh_device(mesh)
        dp, tp, sp = cfg.data, cfg.model, cfg.subband
        seconds, res = {}, {"mesh": {"data": dp, "model": tp, "subband": sp}}

        def timed(name, fn):
            t0 = time.perf_counter()
            value = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds[name] = round(time.perf_counter() - t0, 3)
            return value

        # ---- GMM training step over (data, model)
        inp = gmm_inputs(dp, dev)
        params, acc = timed("gmm", lambda: gmm_train_step(mesh, inp, gmm_params_block(mesh, inp)))
        res["gmm_states"] = int(params.means.shape[0]) * tp
        if not all(bool(torch.isfinite(a).all()) for a in (params.means, params.variances)):
            raise RuntimeError("dryrun: the GMM step gave non-finite parameters")

        # ---- graph-sharded decodes: V = 300, the bench graph, V = 20k
        for name, lcfg, T in (
                ("V300", lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3), 24),
                ("V2000", lvcsr.LvcsrConfig(), 16),
                ("V20k", lvcsr.LvcsrConfig(vocab_size=20_000, n_tokens=300_000, branching=5), 8)):
            def decode(lcfg=lcfg, T=T):
                g = lvcsr.build_task(lcfg).graph
                return g, sharded_decode(mesh, g, dp, T, kcap=128, beam=40.0)
            g, (olabs, scores, spill) = timed(f"decode {name}", decode)
            if not bool(torch.isfinite(scores).all()):
                raise RuntimeError(f"dryrun: the {name} sharded decode gave non-finite scores")
            res[name] = {"states": g.num_states, "arcs": g.num_arcs,
                         "shard_bytes": shard_bytes(g, tp), "spill_frames": int(spill.sum())}
            del g

        # ---- subband-sharded front end
        POS = np.asarray(ArrayGeometry.linear(4, 0.05).positions)
        taus = (steering_delays(POS, np.array([0.0, 1.5, 0.0]), 343.0, 16000.0)
                / 16000.0).astype(np.float32)
        xw = np.random.default_rng(2).standard_normal((2 * dp, 4, 4096)).astype(np.float32)
        Y = timed("frontend", lambda: frontend_step(mesh, xw, taus))
        res["frontend_shape"] = list(shd.gather_block(Y, mesh, shd.BEAMFORMED).shape)

        # ---- Conformer-CTC and joint data-parallel steps
        model = cfm.ConformerCtc(8, dim=32, layers=1, heads=2, device=dev,
                                 generator=torch.Generator().manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        Xc = np.random.default_rng(3).standard_normal((2 * dp, 32, 13)).astype(np.float32)
        res["conformer_loss"] = float(timed("conformer", lambda: conformer_step(
            mesh, model, opt, Xc, np.ones((2 * dp, 3), np.int64))))
        jm = mj.JointBeamformerCtc(4, DRY_FB.M, dim=16, layers=1, heads=2, hidden=16, device=dev,
                                   generator=torch.Generator().manual_seed(5))
        jopt = torch.optim.Adam(jm.parameters(), lr=1e-3)
        Xj = fb.analysis(torch.as_tensor(xw, device=dev), DRY_FB)
        res["joint_loss"] = float(timed("joint", lambda: joint_step(
            mesh, jm, jopt, Xj, np.ones((2 * dp, 2), np.int64))))
        for k in ("conformer_loss", "joint_loss"):
            if not np.isfinite(res[k]):
                raise RuntimeError(f"dryrun: {k} is not finite")

        # ---- sequence- and pipeline-parallel blocks
        Xl = np.random.default_rng(4).standard_normal((2, 16 * sp, 32)).astype(np.float32)
        res["sp_err"] = timed("sequence parallel", lambda: sequence_parallel_block(mesh, Xl))
        if res["sp_err"] > 2e-4:
            raise RuntimeError(f"dryrun: the sequence-parallel block is {res['sp_err']} off")
        if tp >= 2:
            res["pp_err"] = timed("pipeline parallel", lambda: pipeline_block(mesh))
            if res["pp_err"] > 2e-5:
                raise RuntimeError(f"dryrun: the pipeline is {res['pp_err']} off")

        # ---- sharded checkpoint of the trained GMM, restored and continued
        resumed, straight = timed("checkpoint", lambda: gmm_checkpoint_resume(
            mesh, inp, params, acc, os.path.join(store, "ckpt")))
        res["resume_bitwise"] = all(torch.equal(a, b) for a, b in zip(
            (resumed.means, resumed.variances, resumed.logweights),
            (straight.means, straight.variances, straight.logweights)))
        if not res["resume_bitwise"]:
            raise RuntimeError("dryrun: the resumed GMM step differs from the uninterrupted one")
        res["seconds"] = seconds
        res["launches"] = _launches()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dry run on `n_devices` ranks, one process each (NCCL on the
    cards, rank r on card r % count; gloo when `device="cpu"`), and print
    one `dryrun_multichip OK: ...` line → rank 0's summary.  A failing
    step fails the run: the port builds every graph itself."""
    import torch.multiprocessing as mp

    dev = resolve(device)
    with tempfile.TemporaryDirectory(prefix="dsr_tpu_torch_dryrun_") as store:
        out = os.path.join(store, "summary.json")
        mp.start_processes(_dryrun_rank, args=(n_devices, dev.type, store, out),
                           nprocs=n_devices, start_method="spawn")
        with open(out) as f:
            res = json.load(f)
    big = res["V2000"]
    huge = res["V20k"]
    print(f"dryrun_multichip OK: mesh {res['mesh']}; GMM train ({res['gmm_states']} states over "
          f"'model'); HCLG {res['V300']['states']} states decoded sharded; "
          f"{big['states']}-state bench HCLG sharded decode ok (spill frames "
          f"{big['spill_frames']}); {huge['states']}-state/{huge['arcs']}-arc HCLG sharded "
          f"decode ok, per-shard tables {huge['shard_bytes']} bytes; subband-sharded frontend "
          f"{tuple(res['frontend_shape'])}; conformer-CTC step loss "
          f"{res['conformer_loss']:.2f}; joint beamformer+CTC step loss "
          f"{res['joint_loss']:.2f}; sequence-parallel block {res['sp_err']:.1e} off; "
          f"checkpoint resume bitwise {res['resume_bitwise']}; seconds {res['seconds']}")
    return res
