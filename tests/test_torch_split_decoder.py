"""The port's degree-split decoder (`dsr_tpu_torch.asr.decoder.
split_decoder`): its tables against the JAX package's on the V=50 graph
(a0 = 2 and 8), and its words against the JAX sort-path dense decode on
the V=300 trigram graph (68,551 states) at a0 = 2.  More split-decoder
tests are in tests/test_torch_split_overflow.py.

Tolerances: tables and words exact; scores to float32 rounding (1e-6
relative) against the JAX package on log-likelihoods on a 2^-6 grid, where
its bf16 hi/lo acoustic lookup is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import logliks, lvcsr_v300, words
from dsr_tpu.asr import lvcsr as jlvcsr
from dsr_tpu.asr.decoder import split_decoder as jsd
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.decoder import split_decoder as sd

KCAP, BEAM, EG, T = 128, 60.0, 896, 200


@pytest.mark.parametrize("a0", [2, 8])
def test_split_graph_tables_match_jax(a0):
    """The JAX package packs the split tables into float32 planes; the port
    keeps int32 tables, equal after the cast."""
    jg = jlvcsr.build_task(jlvcsr.LvcsrConfig(vocab_size=50, n_tokens=1000,
                                              branching=3)).graph
    sg = sd.build_split_graph(convert.packed_graph(jg), a0, "cpu")
    jsg = jsd.build_split_graph(jg, a0)
    assert (sg.num_states, sg.num_groups, sg.a0, sg.start) == (
        jsg.num_states, jsg.num_groups, jsg.a0, int(jsg.start))
    p, o = np.asarray(jsg.packed), np.asarray(jsg.ov_packed)
    as_i = lambda x: x.astype(np.int32)  # noqa: E731
    for port, ref in ((sg.weight, p[:, :a0]), (sg.pdf, as_i(p[:, a0:2 * a0])),
                      (sg.dst, as_i(p[:, 2 * a0:3 * a0])), (sg.ov_base, as_i(p[:, 3 * a0])),
                      (sg.ov_count, as_i(p[:, 3 * a0 + 1])), (sg.ov_weight, o[:, :a0]),
                      (sg.ov_pdf, as_i(o[:, a0:2 * a0])), (sg.ov_dst, as_i(o[:, 2 * a0:])),
                      (sg.olabel, np.asarray(jsg.olabel)),
                      (sg.src_of_row, np.asarray(jsg.src_of_row)),
                      (sg.final_weight, np.asarray(jsg.final_weight))):
        assert np.array_equal(port.numpy(), ref)


@pytest.fixture(scope="module")
def graphs():
    task, g = lvcsr_v300()
    return task, g, sd.build_split_graph(g, a0=2, device="cpu")


def test_split_words_match_jax_sort_path(graphs):
    task, _, sg = graphs
    jtg = jtk.build_token_graph(task.graph)
    for seed in range(2):
        ll = logliks(np.random.default_rng(20 + seed), (T, task.num_pdfs), rounded=True)
        ro, rs, *_ = jtk.decode_with_tokens(jtg, jnp.asarray(ll), kcap=KCAP, beam=BEAM,
                                            select_mode="xla")
        o, s, spill, ovf = sd.decode_split(sg, ll, kcap=KCAP, beam=BEAM, eg=EG)
        assert int(ovf) == 0 and int(spill) == 0
        assert words(o) == words(ro) and len(words(o)) > 0
        np.testing.assert_allclose(float(s), float(rs), rtol=1e-6)
