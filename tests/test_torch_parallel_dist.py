"""The port's parallel layer over 4 gloo ranks on the CPU against the JAX
package's on 4 devices of the suite's 8-device CPU mesh.

One spawn of 4 ranks (`tests/_torch_parallel_worker.py`, FileStore
rendezvous under tmp_path, one thread a rank) runs every case; the JAX
references are computed here while the ranks run.  Inputs are made with
numpy from seeds and written to one file that both sides read.

Tolerances:
- sharded decode: against JAX `make_sharded_decode` on (data 2, model 2),
  identical words and scores within 1e-2 (the JAX lookups are hi/lo
  bf16); against the port's single-device decode, token tables bitwise;
- `psum_accum`: tests/test_parallel.py's rtol=1e-3, atol=1e-2 (float32
  reduction order over the ranks);
- ring, Ulysses, halo and pipeline: 1e-5 of the output's largest
  magnitude (the same float32 products in another order);
- blocks: exact.
The dead-rank drill is a second spawn of 2 ranks.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_parity import SR, phone_hclg_system, rel

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_worker.py")
MAXD = 16


def _spawn(world, tmp, mode="run"):
    store = os.path.join(tmp, f"store_{mode}")
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), store,
                              os.path.join(tmp, "inputs.npz"), tmp, mode],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(world)]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait()


def _wait(procs, timeout):
    """Wait for every rank; kill them all if any is still running at the end."""
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    finally:
        _kill(procs)


def _estep_inputs():
    """tests/test_parallel.py's Baum-Welch E-step inputs, made by the port."""
    from dsr_tpu_torch.asr import smallvocab
    from dsr_tpu_torch.asr.train import trainer
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.utils import corpus

    task = smallvocab.SmallVocabTask(corpus.VOCAB[:3])
    feats, words = [], []
    for ws, x in corpus.make_corpus(8, min_words=1, max_words=2, seed=11):
        feats.append(ft.cmn(ft.mfcc(torch.as_tensor(x.astype(np.float32)), SR)).numpy())
        words.append([w if w in task.vocab else task.vocab[0] for w in ws])
    means, variances, logw = trainer.init_gmm_from_feats(
        feats, [task.align_graph(ws)[0] for ws in words], task.num_states, 2,
        np.random.default_rng(11))
    f, lens = trainer.pad_corpus(feats)
    ids, A, init, final = trainer.pad_align_graphs(task, words)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(feats=f, lengths=lens, ids=ids, logA=A, init=init, final=final,
                means=f32(means), variances=f32(variances), logw=f32(logw),
                num_states=task.num_states)


def _inputs(graph, lls):
    rng = np.random.default_rng(5)
    T = max(len(ll) for ll in lls)
    P = lls[0].shape[1]
    ll_a = np.zeros((2, T, P), np.float32)
    for i in range(2):
        ll_a[i, :len(lls[i % len(lls)])] = lls[i % len(lls)]
    Tb = min(len(ll) for ll in lls)
    ll_b = np.stack([lls[0][:Tb], lls[1 % len(lls)][:Tb]])
    B, Ta, H, dh = 2, 32, 4, 8
    q, k, v = (rng.standard_normal((B, Ta, H, dh)).astype(np.float32) for _ in range(3))
    D = 8
    return dict(
        **{f"g_{f}": np.asarray(getattr(graph, f)) for f in graph._fields},
        kcap=graph.num_states, ll_a=ll_a, lens_a=np.array([len(lls[i % len(lls)])
                                                           for i in range(2)]),
        ll_b=ll_b, lens_b=np.array([Tb, Tb - 7]),
        **_estep_inputs(),
        q=q, k=k, v=v, bias=(0.1 * rng.standard_normal((2 * MAXD + 1, H))).astype(np.float32),
        mask=np.arange(Ta)[None, :] < rng.integers(Ta // 2, Ta + 1, size=B)[:, None],
        hx=rng.standard_normal((B, Ta, 6)).astype(np.float32),
        pW=(rng.standard_normal((4, D, D)) * 0.3).astype(np.float32),
        pb=(rng.standard_normal((4, D)) * 0.1).astype(np.float32),
        pxs=rng.standard_normal((6, 2, 5, D)).astype(np.float32),
        blocks=rng.standard_normal((6, 3, 5, 7)).astype(np.float32))


def _jax_refs(graph, inp):
    """The JAX package's functions on the same inputs."""
    from jax import shard_map

    from dsr_tpu.asr.am import gmm as jgmm
    from dsr_tpu.asr.decoder import topk_decoder as jtk
    from dsr_tpu.asr.decoder import viterbi as jvit
    from dsr_tpu.asr.fsm.packed import PackedGraph as JPackedGraph
    from dsr_tpu.asr.train import ml as jml
    from dsr_tpu.config import MeshConfig as JMeshConfig
    from dsr_tpu.parallel import longctx
    from dsr_tpu.parallel import make_mesh as jmake_mesh
    from dsr_tpu.parallel.decoder import make_sharded_decode as jsharded
    from dsr_tpu.parallel.pipeline_parallel import pipeline_apply

    refs = {}
    jg = jtk.build_token_graph(JPackedGraph(*graph))
    run = jsharded(jmake_mesh(JMeshConfig(data=2, model=2)), jg, kcap=graph.num_states)
    for case in ("a", "b"):
        ol, sc, sp = run(inp[f"ll_{case}"], inp[f"lens_{case}"].astype(np.int32))
        refs[f"dec_{case}"] = (np.asarray(ol), np.asarray(sc), np.asarray(sp))

    S = int(inp["num_states"])
    params = jgmm.GmmParams(*(jnp.asarray(inp[n]) for n in ("means", "variances", "logw")))

    def shard_estep(feats, lengths, ids, logA, init, final):
        ll = jgmm.loglik(params, feats)
        ll_graph = jnp.take_along_axis(ll, ids[:, None, :], axis=2)
        gamma_l, _ = jax.vmap(jvit.forward_backward)(ll_graph, logA, init, final, lengths)
        gamma = jnp.einsum("utl,uls->uts", gamma_l, jax.nn.one_hot(ids, S, dtype=jnp.float32))
        acc = jml.zero_accum(S, params.means.shape[1], params.means.shape[2])
        return jml.psum_accum(jml.accumulate(params, feats, gamma, acc), "data")

    dmesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    estep = shard_map(shard_estep, mesh=dmesh, in_specs=(P("data"),) * 6, out_specs=P())
    refs["acc"] = [np.asarray(a) for a in jax.jit(estep)(
        *(jnp.asarray(inp[n]) for n in ("feats", "lengths", "ids", "logA", "init", "final")))]

    smesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    bias = jnp.asarray(inp["bias"])

    def sharded(fn, n_in):
        return jax.jit(shard_map(fn, mesh=smesh, in_specs=(P(None, "sp"),) * n_in,
                                 out_specs=P(None, "sp"), check_vma=False))

    qkvm = tuple(jnp.asarray(inp[n]) for n in ("q", "k", "v", "mask"))
    refs["ring"] = np.asarray(sharded(lambda q, k, v, m: longctx.ring_attention(
        q, k, v, "sp", bias, MAXD, kv_mask=m), 4)(*qkvm))
    refs["ulysses"] = np.asarray(sharded(lambda q, k, v, m: longctx.ulysses_attention(
        q, k, v, "sp", bias, MAXD, kv_mask=m), 4)(*qkvm))
    refs["halo"] = np.asarray(sharded(lambda x: longctx.exchange_halo(x, "sp", 3), 1)(
        jnp.asarray(inp["hx"])))
    stages = Mesh(np.array(jax.devices()[:4]), ("stage",))
    with stages:
        refs["pipe"] = np.asarray(pipeline_apply(
            stages, "stage", lambda p, x: x + jnp.tanh(x @ p["W"] + p["b"]),
            {"W": jnp.asarray(inp["pW"]), "b": jnp.asarray(inp["pb"])}, jnp.asarray(inp["pxs"])))
    return refs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    task, graph, lls = phone_hclg_system()
    inp = _inputs(graph, lls)
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    procs = _spawn(4, tmp)
    try:
        refs = _jax_refs(graph, inp)
    finally:
        outs = _wait(procs, timeout=240)
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {se.decode()[-3000:]}"
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(4)]
    return task, graph, lls, inp, refs, ranks


def test_sharded_decode_matches_jax_and_the_single_device_decode(spawned):
    from dsr_tpu_torch.asr.decoder import topk_decoder as tk
    from dsr_tpu_torch.asr.decoder import wfst_decoder as wd

    task, graph, _, inp, refs, ranks = spawned
    tg = tk.build_token_graph(graph, "cpu")
    kcap = graph.num_states
    for case in ("a", "b"):
        res = ranks[0]
        for other in ranks[1:]:           # every rank returns the global outputs
            for name in ("olabs", "scores", "ts", "ta", "tsc"):
                key = f"dec_{case}_{name}"
                assert np.array_equal(other[key].view(np.int32), res[key].view(np.int32))
        ol_j, sc_j, sp_j = refs[f"dec_{case}"]
        lens = inp[f"lens_{case}"]
        assert not res[f"dec_{case}_spill"].any() and not sp_j.any()
        ll = torch.as_tensor(inp[f"ll_{case}"])
        st0, sc0 = tk.start_tokens(tg, 2, kcap)
        ts, ta, tsc = tk.token_pass(lambda s, c, l_: tk.candidates(tg, s, c, l_), ll, lens,
                                    st0, sc0, 1e9, kcap)[2:5]
        ol, sc = tk.decode_batch(tg, ll, lens, kcap=kcap)
        for name, single in (("ts", ts), ("ta", ta), ("tsc", tsc)):
            assert np.array_equal(res[f"dec_{case}_{name}"].view(np.int32),
                                  single.transpose(0, 1).numpy().view(np.int32)), name
        assert np.array_equal(res[f"dec_{case}_olabs"], ol.numpy())
        assert np.array_equal(res[f"dec_{case}_scores"].view(np.int32), sc.numpy().view(np.int32))
        for i in range(2):
            hyp = wd.words_from_olabels(res[f"dec_{case}_olabs"][i][:lens[i]], task.words)
            assert hyp == wd.words_from_olabels(ol_j[i][:lens[i]], task.words)
            assert len(hyp) > 0
        assert np.all(np.abs(res[f"dec_{case}_scores"] - sc_j) < 1e-2)
    assert all(r["uneven_raises"] for r in ranks)


def test_psum_accum_matches_the_jax_psum(spawned):
    *_, refs, ranks = spawned
    for r in ranks:
        for name, ref in zip(("occ", "sx", "sxx"), refs["acc"]):
            np.testing.assert_allclose(r[f"acc_{name}"], ref, rtol=1e-3, atol=1e-2)


def test_sequence_and_pipeline_parallel_match_jax(spawned):
    *_, refs, ranks = spawned
    for r in ranks:
        for name in ("ring", "ulysses", "halo", "pipe"):
            assert rel(r[name], refs[name]) <= 1e-5, name


def test_blocks_round_trip_every_spec(spawned):
    from dsr_tpu_torch.parallel import sharding

    *_, inp, _, ranks = spawned
    x = inp["blocks"]
    specs = [n for n in dir(sharding) if n.isupper()]
    assert len(specs) == 16
    for m_name, shape in (("dm", (2, 2, 1)), ("ds", (2, 1, 2))):
        for rank, r in enumerate(ranks):
            coord = dict(zip(("data", "model", "subband"), np.unravel_index(rank, shape)))
            size = dict(zip(("data", "model", "subband"), shape))
            for spec in specs:
                want = x
                for d, axis in enumerate(getattr(sharding, spec)):
                    if axis is not None:
                        want = np.array_split(want, size[axis], axis=d)[coord[axis]]
                assert np.array_equal(r[f"blk_{m_name}_{spec}"], want), (m_name, spec, rank)
                assert np.array_equal(r[f"back_{m_name}_{spec}"], x), (m_name, spec, rank)
    assert [list(r["part_coord"]) for r in ranks] == [[0, 0, 0], [1, 0, 0], [-1], [-1]]
    assert all(np.array_equal(r["part_back"], x) for r in ranks[:2])
    assert all(r["too_big_raises"] for r in ranks)


def test_dead_rank_fails_the_collective_within_the_timeout(tmp_path):
    """Rank 1 joins, then sleeps; rank 0's all-reduce must raise within the
    5 s heartbeat timeout (plus slack), not hang."""
    procs = _spawn(2, str(tmp_path), mode="hang")
    try:
        _, se = procs[0].communicate(timeout=90)
    finally:
        _kill(procs)
    assert procs[0].returncode == 0, se.decode()[-3000:]
    res = json.loads((tmp_path / "drill.json").read_text())
    assert res["raised"], res
    assert 4.0 <= res["seconds"] <= 35.0, res
    msg = res["error"].lower()
    assert "timeout" in msg or "timed out" in msg or "closed" in msg, msg
