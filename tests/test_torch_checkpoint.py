"""The port's checkpoints (`dsr_tpu_torch/utils/checkpoint.py`) against the
JAX package's per-shard format, the work queue's crash and resume, and the
profiler's trace.

Checkpoints are compared bitwise both ways: the same tree (a dict of a
`GmmParams` (a Module in the port, a NamedTuple in JAX), `GmmAccum`
NamedTuples, a list and a tuple; float32, int32 and complex64 leaves)
written by one package is restored by the other, and the two packages'
index files are equal.  A checkpoint whose shards have other bounds than
the restoring rank's raises ValueError.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.train import ml as jml
from dsr_tpu.utils import checkpoint as jckpt
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.train import ml
from dsr_tpu_torch.utils import checkpoint, profiling, workqueue


def _arrays(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(means=f(3, 2, 4), variances=0.5 + np.abs(f(3, 2, 4)), logw=f(3, 2),
                occ=f(3, 2), sx=f(3, 2, 4), sxx=f(3, 2, 4),
                ids=rng.integers(-5, 9, (5, 7)).astype(np.int32),
                wa=(f(129, 7) + 1j * f(129, 7)).astype(np.complex64), scalar=f(1)[0])


def _port_tree(a):
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    return {"params": gmm.GmmParams(a["means"], a["variances"], a["logw"]),
            "accs": [ml.GmmAccum(t(a["occ"]), t(a["sx"]), t(a["sxx"]))],
            "state": (t(a["ids"]), t(a["wa"])), "gain": t(a["scalar"])}


def _jax_tree(a):
    j = jnp.asarray
    return {"params": jgmm.GmmParams(j(a["means"]), j(a["variances"]), j(a["logw"])),
            "accs": [jml.GmmAccum(j(a["occ"]), j(a["sx"]), j(a["sxx"]))],
            "state": (j(a["ids"]), j(a["wa"])), "gain": j(a["scalar"])}


def _leaves(tree):
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            for _, x in checkpoint._flatten(tree)]


def _same(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and
               x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_checkpoints_restore_bitwise_in_either_package(tmp_path):
    a, zero = _arrays(0), {k: np.zeros_like(v) for k, v in _arrays(0).items()}
    jax_path, port_path = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_sharded(jax_path, _jax_tree(a))
    checkpoint.save_sharded(port_path, _port_tree(a))
    names = [n for n, _ in checkpoint._flatten(_port_tree(a))]
    assert names == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(_jax_tree(a))[0]]
    assert names[:3] == ["['accs'][0].occ", "['accs'][0].sx", "['accs'][0].sxx"]
    index = lambda p: json.loads((tmp_path / p / "index.0.json").read_text())  # noqa: E731
    assert index("port") == index("jax")

    ref = _leaves(_port_tree(a))
    got = checkpoint.restore(jax_path, _port_tree(zero))
    assert isinstance(got["params"], gmm.GmmParams) and isinstance(got["accs"][0], ml.GmmAccum)
    assert got["state"][1].dtype == torch.complex64 and _same(_leaves(got), ref)
    back = jckpt.restore_sharded(port_path, _jax_tree(zero))
    assert isinstance(back["params"], jgmm.GmmParams)
    assert _same([np.asarray(x) for x in jax.tree_util.tree_leaves(back)], ref)

    # the legacy ckpt.npz: the template's leaves in order
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    np.savez(legacy / "ckpt.npz", *ref)
    assert _same(_leaves(checkpoint.restore(str(legacy), _port_tree(zero))), ref)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), _port_tree(zero))


def test_restore_onto_other_bounds_raises(tmp_path):
    """A JAX checkpoint of a leaf split over 2 devices has shards [0, 2) and
    [2, 4) of its first axis; one unsharded rank needs [0, 4)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    split = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("model")))
    jckpt.save_sharded(str(tmp_path / "split"), {"w": split})
    with pytest.raises(ValueError, match="bounds"):
        checkpoint.restore_sharded(str(tmp_path / "split"), {"w": torch.zeros(4, 8)})
    jckpt.save_sharded(str(tmp_path / "whole"), {"w": jnp.asarray(x)})
    got = checkpoint.restore_sharded(str(tmp_path / "whole"), {"w": torch.zeros(4, 8)})
    assert torch.equal(got["w"], torch.as_tensor(x))


def test_decode_progress_work_queue_resume_and_trace(tmp_path):
    """tests/test_runtime_utils.py's crash and resume, each batch in a
    profiler scope inside a trace that must name them."""
    path = str(tmp_path / "progress.json")
    utts = [f"utt{i:03d}" for i in range(10)]
    seen = []

    def crashy(batch):
        with profiling.scope("decode_batch"):
            if "utt006" in batch:
                raise RuntimeError("simulated failure")
            with profiling.scope("batch_sum"):
                torch.ones(8).sum()
            seen.extend(batch)

    with profiling.trace(str(tmp_path / "trace")) as prof:
        prog = checkpoint.DecodeProgress(path)
        with pytest.raises(RuntimeError):
            workqueue.run_batched(utts, 2, crashy, prog)
    text = open(prof.trace_path).read()
    assert '"decode_batch"' in text and '"batch_sum"' in text
    prog2 = checkpoint.DecodeProgress(path)
    done_before = set(prog2.done)
    assert done_before == set(seen) == set(utts[:6])
    seen2 = []
    assert workqueue.run_batched(utts, 2, seen2.extend, prog2) == 4
    assert set(seen2) == set(utts) - done_before
    assert checkpoint.DecodeProgress(path).done == set(utts)
    # two processes: every other batch each
    taken = [[], []]
    for r in range(2):
        workqueue.run_batched(utts, 2, taken[r].extend, None, r, 2)
    assert taken[0] == utts[0::2] and taken[1] == utts[1::2]
