"""The port's graph-sharded decoder pieces in one process
(`dsr_tpu_torch/parallel/decoder.py`), on tests/test_parallel.py's phone
task HCLG built with the port.

- `shard_token_graph`: the n shards, stacked, equal the dense tables of
  `build_token_graph` padded by `pad_token_graph_states`, and those equal
  the JAX package's padded tables, exactly (n = 1, 2, 3 (uneven S), 4).
- `simulate_sharded_kernel_decode` at n = 2 and 4 (60 frames, beam 40, at
  the JAX test's kcap 128 and at kcap 16, where each shard's top kcap
  prunes): tokens and score bitwise equal to the port's
  `decode_with_tokens`; words equal to the JAX package's
  `decode_with_tokens(select_mode="xla")` (the function
  tests/test_parallel.py holds the JAX simulation to; the interpret-mode
  JAX simulation takes ~13 s a shard count here), score within its 5e-2.
- `MeshConfig` and its JSON helpers against the JAX package's.
The multi-rank decode is in tests/test_torch_parallel_dist.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import phone_hclg_system, words
from dsr_tpu import config as jconfig
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu.asr.fsm.packed import PackedGraph as JPackedGraph
from dsr_tpu.parallel import decoder as jpd
from dsr_tpu_torch import config
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.parallel import decoder as pd

FIELDS = ("pdf", "olabel", "weight", "dst", "final_weight")


@pytest.fixture(scope="module")
def system():
    task, graph, lls = phone_hclg_system()
    return task, graph, lls, tk.build_token_graph(graph, "cpu")


def test_shards_stack_to_the_padded_token_graph(system):
    _, graph, _, tg = system
    jtg = jtk.build_token_graph(JPackedGraph(*graph))
    for n in (1, 2, 3, 4):
        padded = pd.pad_token_graph_states(tg, n)
        jpadded = jpd.pad_token_graph_states(jtg, n)
        rows = -(-graph.num_states // n)
        assert padded.num_states == jpadded.num_states == n * rows
        shards = [pd.shard_token_graph(graph, r, n, "cpu") for r in range(n)]
        assert [(s.offset, s.rows, s.a_max) for s in shards] == [
            (r * rows, rows, tg.a_max) for r in range(n)]
        for f in FIELDS:
            stacked = torch.cat([getattr(s, f) for s in shards])
            assert stacked.dtype == getattr(tg, f).dtype
            assert torch.equal(stacked, getattr(padded, f)), (n, f)
            assert np.array_equal(stacked.numpy(), np.asarray(getattr(jpadded, f))), (n, f)


def test_simulated_shards_equal_the_single_decode(system):
    task, graph, lls, tg = system
    ll = lls[0][:60]
    jtg = jtk.build_token_graph(JPackedGraph(*graph))
    ref_j = jtk.decode_with_tokens(jtg, jnp.asarray(ll), kcap=128, beam=40.0, select_mode="xla")
    for kcap in (128, 16):
        ref = tk.decode_with_tokens(tg, ll, kcap=kcap, beam=40.0)
        for n in (2, 4):
            olabs, score, spill, *tokens = pd.simulate_sharded_kernel_decode(
                tg, ll, n, kcap=kcap, beam=40.0, return_tokens=True)
            assert spill == 0
            assert torch.equal(olabs, ref[0])
            assert np.float32(score).view(np.int32) == ref[1].numpy().view(np.int32)
            for got, want in zip(tokens, ref[2:5]):
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (kcap, n)
            if kcap == 128:
                assert words(olabs) == words(ref_j[0]) and len(words(olabs)) > 0
                assert abs(score - float(ref_j[1])) < 5e-2


def test_mesh_config_and_its_json_match_jax():
    jfields = [(f.name, f.default) for f in dataclasses.fields(jconfig.MeshConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(config.MeshConfig)] == jfields
    for cfg in (config.MeshConfig(), config.MeshConfig(data=2, model=4, subband=1)):
        text = config.to_json(cfg)
        jcfg = jconfig.MeshConfig(**dataclasses.asdict(cfg))
        assert text == jconfig.to_json(jcfg)
        back = config.from_json(config.MeshConfig, text)
        assert back == cfg and back.num_devices == jcfg.num_devices
