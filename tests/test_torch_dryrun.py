"""The steps of the port's `entry.dryrun_multichip` that are new to the
port, over 4 gloo ranks on the CPU, each held to the JAX function computed
on one device (the dry run's sharded decodes and its sequence- and
pipeline-parallel blocks are held by tests/test_torch_parallel_dist.py).

One spawn of 4 ranks (`tests/_torch_parallel_worker.py` in mode
"dryrun", FileStore rendezvous under tmp_path, one thread a rank) runs
every case; the JAX references are computed here while the ranks run.

Tolerances:
- the GMM training step (forced alignment, accumulation over `data`,
  M-step on each `model` block) against `__graft_entry__`'s train step on
  one device: occupancies and parameters 1e-5 of their largest magnitude
  (float32 sums over 2 ranks' utterances in another order);
- the 4-rank GMM checkpoint: the resumed step bitwise equal to the
  uninterrupted one; the checkpoint restores bitwise in the JAX package
  onto a (data 2, model 2) mesh;
- the subband-sharded front end against JAX's analysis + delay-and-sum:
  1e-5 of the largest magnitude (the filterbank's parity bound);
- the Conformer-CTC step (float32): the loss 1e-5 relative, each
  gradient averaged over `data` within 1e-3 of the JAX gradient leaf's
  largest magnitude (1e-6 floor for the k bias, `grads_match`);
- the joint step in float64 (the mask-MVDR solve amplifies float32
  rounding, tests/test_torch_joint.py): loss 1e-12 relative, the clipped
  gradients 1e-9.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import grads_match, randomized, rel

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_worker.py")


def _inputs():
    from dsr_tpu_torch import entry
    from dsr_tpu_torch.config import ArrayGeometry
    from dsr_tpu_torch.utils.design import steering_delays

    POS = np.asarray(ArrayGeometry.linear(4, 0.05).positions)
    taus = (steering_delays(POS, np.array([0.0, 1.5, 0.0]), 343.0, 16000.0)
            / 16000.0).astype(np.float32)
    return {**{f"gmm_{k}": v for k, v in entry.gmm_inputs(2, "cpu").items()},
            "xw": np.random.default_rng(2).standard_normal((4, 4, 4096)).astype(np.float32),
            "taus": taus,
            "Xc": np.random.default_rng(3).standard_normal((4, 32, 13)).astype(np.float32),
            "yc": np.ones((4, 3), np.int64), "yj": np.ones((4, 2), np.int64)}


def _jax_gmm_step(inp, tp):
    """`__graft_entry__.dryrun_multichip`'s train step on one device."""
    from dsr_tpu.asr.am import gmm as jgmm
    from dsr_tpu.asr.train import ml, trainer

    S0 = int(inp["gmm_num_states"])
    S_pad = -(-S0 // tp) * tp
    pad = S_pad - S0
    j = lambda n: jnp.asarray(inp["gmm_" + n])  # noqa: E731
    params = jgmm.GmmParams(jnp.pad(j("means"), ((0, pad), (0, 0), (0, 0))),
                            jnp.pad(j("variances"), ((0, pad), (0, 0), (0, 0)),
                                    constant_values=1.0),
                            jnp.pad(j("logw"), ((0, pad), (0, 0)), constant_values=-1e5))

    @jax.jit
    def step(params, feats, lengths, ids, A_g, init, final):
        ll = jgmm.loglik(params, feats)[..., :S0]
        ll_graph = jnp.take_along_axis(ll, ids[:, None, :], axis=2)
        paths, _ = trainer._viterbi_graphs(ll_graph, A_g, init, final, lengths)
        gpaths = jnp.take_along_axis(ids, paths, axis=1)
        mask = jnp.arange(feats.shape[1])[None, :] < lengths[:, None]
        gamma = jax.nn.one_hot(gpaths, S_pad, dtype=jnp.float32) * mask[..., None]
        acc = ml.accumulate(params, feats, gamma, ml.zero_accum(S_pad, *params.means.shape[1:]))
        return ml.mstep(acc), acc

    args = [j(n) for n in ("feats", "lengths", "ids", "logA", "init", "final")]
    p1, acc = step(params, *args)
    return p1, acc, step(p1, *args)[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
    from dsr_tpu.models import conformer as jcfm
    from dsr_tpu.models import joint as jmj
    from dsr_tpu.ops import filterbank as jfb
    from dsr_tpu_torch import convert

    tmp = str(tmp_path_factory.mktemp("dryrun"))
    inp = _inputs()
    cf = jcfm.ConformerCtc(vocab=8, dim=32, layers=1, heads=2)
    cf_params = randomized(jax.jit(cf.init)(jax.random.PRNGKey(0), inp["Xc"][:1]), 1)
    Xj = np.asarray(jfb.analysis(inp["xw"], JFilterbankConfig(M=64, m=2, r=2)))
    jm = jmj.JointBeamformerCtc(vocab=4, subbands_m=64, dim=16, layers=1, heads=2, hidden=16)
    jt_params = randomized(jax.jit(jm.init)(jax.random.PRNGKey(5), Xj[:1]), 2)
    np.savez(os.path.join(tmp, "inputs.npz"), **inp, Xj=Xj.astype(np.complex128),
             **{f"cf_{k}": v.numpy() for k, v in convert.conformer_ctc(cf_params).items()},
             **{f"jt_{k}": v.numpy() for k, v in convert.joint(jt_params).items()})
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "4", os.path.join(tmp, "store"),
                               os.path.join(tmp, "inputs.npz"), tmp, "dryrun"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(4)]
    try:
        refs = {"gmm": _jax_gmm_step(inp, 2)}
        refs["frontend"] = _jax_frontend(inp)
        refs["cf"] = _jax_ctc_step(cf, cf_params, inp)
        refs["jt"] = _jax_joint_step(jm, jt_params, Xj, inp)
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    ranks = [np.load(os.path.join(tmp, f"dryrun{r}.npz")) for r in range(4)]
    return tmp, inp, ranks, refs


def _jax_frontend(inp):
    from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
    from dsr_tpu.ops import beamforming as jbf
    from dsr_tpu.ops import filterbank as jfb

    A = jfb.analysis(inp["xw"], JFilterbankConfig(M=64, m=2, r=2))
    v = jbf.steering_vectors(jnp.asarray(inp["taus"]), 64, 16000.0)
    return np.asarray(jbf.apply_weights(A, jbf.ds_weights(v)))


def _jax_ctc_step(model, params, inp):
    from dsr_tpu.models import conformer as jcfm

    X, y = jnp.asarray(inp["Xc"]), jnp.asarray(inp["yc"], jnp.int32)

    def loss_fn(p):
        logits = model.apply(p, X)
        B, T = logits.shape[:2]
        return jcfm.ctc_loss(logits, jnp.full((B,), T, jnp.int32), y,
                             jnp.full((B,), y.shape[1], jnp.int32))

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _jax_joint_step(model, params, Xj, inp):
    from dsr_tpu.models import conformer as jcfm

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        y = jnp.asarray(inp["yj"], jnp.int32)

        def loss_fn(p):
            logits = model.apply(p, jnp.asarray(Xj, jnp.complex128))
            B, T = logits.shape[:2]
            return jcfm.ctc_loss(logits, jnp.full((B,), T, jnp.int32), y,
                                 jnp.full((B,), y.shape[1], jnp.int32))

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(p64)
        norm = jnp.sqrt(sum(jnp.sum(a * a) for a in jax.tree_util.tree_leaves(g)))
        g = jax.tree_util.tree_map(lambda a: a * jnp.minimum(1.0, 1.0 / norm), g)
        return float(loss), jax.tree_util.tree_map(np.asarray, g)


def test_gmm_step_and_sharded_checkpoint(run):
    from dsr_tpu.asr.am import gmm as jgmm
    from dsr_tpu.utils import checkpoint as jckpt
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    tmp, inp, ranks, refs = run
    p1, acc, p2 = refs["gmm"]
    for r in ranks:
        for name, ref in (("occ", acc.occ), ("means", p1.means), ("variances", p1.variances),
                          ("logw", p1.logweights)):
            assert rel(r[f"gmm_{name}"], np.asarray(ref)) < 1e-5, name
        assert r["resume_bitwise"]
        assert rel(r["gmm2_means"], np.asarray(p2.means)) < 1e-5
    # the 4 ranks' checkpoint restores in the JAX package onto its mesh
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sh = NamedSharding(mesh, P("model"))
    tmpl = {"params": jgmm.GmmParams(*(jax.device_put(jnp.zeros_like(a), sh) for a in p1)),
            "acc": type(acc)(*(jax.device_put(jnp.zeros_like(a), sh) for a in acc))}
    back = jckpt.restore_sharded(os.path.join(tmp, "ckpt"), tmpl)
    assert np.array_equal(np.asarray(back["params"].means), ranks[0]["gmm_means"])
    assert np.array_equal(np.asarray(back["acc"].occ), ranks[0]["gmm_occ"])


def test_subband_sharded_frontend(run):
    _, _, ranks, refs = run
    for r in ranks:
        assert r["frontend"].shape == refs["frontend"].shape == (4, 135, 33)
        assert rel(r["frontend"], refs["frontend"]) < 1e-5


def test_conformer_and_joint_data_parallel_steps(run):
    from dsr_tpu_torch import convert

    _, _, ranks, refs = run
    loss, grads = refs["cf"]
    ref_g = convert.conformer_ctc(grads)
    loss64, grads64 = refs["jt"]
    ref_j = convert.joint(grads64)
    for r in ranks:
        assert abs(float(r["cf_loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        model = _with_grads(r, "cfg_")
        grads_match(model, ref_g)
        assert abs(float(r["jt_loss"]) - loss64) <= 1e-12 * abs(loss64)
        grads_match(_with_grads(r, "jtg_"), ref_j, tol=1e-9, floor=1e-12)


def _with_grads(r, prefix):
    """A stand-in with named_parameters() whose .grad are the rank's."""
    class Grads:
        def named_parameters(self):
            for k in r.files:
                if k.startswith(prefix):
                    g = torch.as_tensor(r[k])
                    p = torch.nn.Parameter(torch.zeros_like(g))
                    p.grad = g
                    yield k[len(prefix):], p

    return Grads()
