"""The port's lattice operations (`dsr_tpu_torch.asr.decoder.lattice`)
against the JAX package's (`dsr_tpu.asr.decoder.lattice`) on the same
arrays: the two-path graph of tests/test_lattice_exact.py and random
low-degree graphs decoded by the JAX sort path with nlat alternates.

Tolerances: both modules are numpy in float64 on the host, running the
same operations in the same order, so forward-backward and posteriors
must agree to 1e-12 and the discrete results (oracle errors, confusion
sets, consensus words, pruned arcs) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsr_tpu.asr.decoder import lattice as jlat
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu.asr.fsm.packed import PackedGraph as JPackedGraph
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.decoder import lattice as lat
from dsr_tpu_torch.asr.decoder import topk_decoder as tk


def _two_path():
    """0 --(pdf0,'7')--> 1 --(pdf1,eps)--> 3(final); 0 --(pdf2,'9')--> 2 --(pdf3,eps)--> 3."""
    fin = np.full(4, np.inf, np.float32)
    fin[3] = 0.0
    g = JPackedGraph(np.array([0, 0, 1, 2], np.int32), np.array([0, 2, 1, 3], np.int32),
                     np.array([7, 9, 0, 0], np.int32), np.zeros(4, np.float32),
                     np.array([1, 2, 3, 3], np.int32), 0, fin, 4)
    ll = np.full((2, 4), -10.0, np.float32)
    ll[0, 0], ll[0, 2], ll[1, 1], ll[1, 3] = 1.0, 1.1, 1.0, 1.05
    return g, ll, 4, 3


def _random(seed, S=40, A=4, P=8, T=16):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(S, dtype=np.int32), A)
    fin = np.full(S, np.inf, np.float32)
    fin[rng.integers(0, S, 6)] = 0.0
    g = JPackedGraph(src, rng.integers(0, P, S * A).astype(np.int32),
                     rng.integers(0, 4, S * A).astype(np.int32),
                     np.abs(rng.standard_normal(S * A)).astype(np.float32),
                     rng.integers(0, S, S * A).astype(np.int32), 0, fin, S)
    return g, (rng.standard_normal((T, P)) * 2).astype(np.float32), S, 4


CASES = [_two_path(), _random(1), _random(2, S=60, A=6, T=24)]


@pytest.fixture(scope="module")
def lattices():
    """Per case: (JAX lattice, port lattice) built from the JAX decode's
    arrays, and the port's own decode's lattice."""
    out = []
    for g, ll, kcap, nlat in CASES:
        jtg = jtk.build_token_graph(g)
        _, _, *arrays = jtk.decode_with_tokens(jtg, jnp.asarray(ll), kcap=kcap, nlat=nlat,
                                               select_mode="xla")
        arrays = [np.asarray(a) for a in arrays]
        tg = tk.build_token_graph(convert.packed_graph(g), "cpu")
        _, _, *mine = tk.decode_with_tokens(tg, ll, kcap=kcap, nlat=nlat)
        out.append((jlat.from_topk(*arrays[:3], jtg, *arrays[3:]),
                    lat.from_topk(*arrays[:3], tg, *arrays[3:]),
                    lat.from_topk(*mine[:3], tg, *mine[3:])))
    return out


def test_forward_backward_and_posteriors_match(lattices):
    for jl, pl, own in lattices:
        for a, b in zip(jl.forward_backward(), pl.forward_backward()):
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(pl.posteriors(), jl.posteriors(), rtol=1e-12, atol=1e-12)
        post = pl.forward_backward()[3]
        assert np.all(post.sum(axis=(1, 2)) <= 1.0 + 1e-9)
        # the port's own decode gives the same lattice: its acoustic lookups
        # are exact, the reference's off by up to 2^-17 of each term, which
        # over the frames adds up to ~1e-5 absolute on these path scores
        for f in ("states", "arcs", "alt_arcs"):
            assert np.array_equal(getattr(own, f), getattr(pl, f))
        np.testing.assert_allclose(own.alt_scores, pl.alt_scores, rtol=1e-5, atol=1e-4)
        # the single-winning-arc lattice's max-approximation posteriors
        strip = [lat.Lattice(*(getattr(x, f) for f in (
            "states", "arcs", "scores", "olabel_of_arc", "src_of_arc", "weight_of_arc",
            "final_weight"))) for x in (jl, pl)]
        np.testing.assert_allclose(strip[1].posteriors(), strip[0].posteriors(), rtol=1e-12,
                                   atol=1e-12)


def test_one_best_oracle_and_prune_match(lattices):
    for jl, pl, _ in lattices:
        assert pl.one_best()[0] == jl.one_best()[0]
        assert pl.one_best()[1] == pytest.approx(jl.one_best()[1], abs=0)
        hyp = pl.one_best()[0]
        for ref in ([], [7], [9], hyp, hyp[:1] + [3] + hyp[1:], [1, 2, 3], [7, 9, 7]):
            assert pl.oracle_errors(ref) == jl.oracle_errors(ref)
        for thr in (1e-3, 0.1, 0.5):
            assert np.array_equal(pl.prune(thr).arcs, jl.prune(thr).arcs)
    two_path = lattices[0][1]
    assert two_path.oracle_errors([7]) == 0 and two_path.one_best()[0] == [9]


def test_confusion_network_and_consensus_match(lattices):
    for i, (jl, pl, _) in enumerate(lattices):
        # unpruned links only on the small lattice: the exact clustering is
        # O(merges·n²) in the word links
        for min_post in ((0.0, 0.01) if i == 0 else (0.01, 0.05)):
            assert (lat.confusion_network(pl, min_post=min_post)
                    == jlat.confusion_network(jl, min_post=min_post))
            assert (lat.consensus(pl, min_post=min_post)
                    == jlat.consensus(jl, min_post=min_post))
        for gap in (1, 4):
            assert lat.consensus_binned(pl, min_gap=gap) == jlat.consensus_binned(jl, min_gap=gap)
    # the tables may come as tensors, on any device: copied to the host once
    _, pl, _ = lattices[1]
    g = tk.build_token_graph(convert.packed_graph(CASES[1][0]), "cpu")
    t = {f: torch.tensor(getattr(pl, f)) for f in ("states", "arcs", "scores", "alt_arcs",
                                                    "alt_scores")}
    again = lat.from_topk(t["states"], t["arcs"], t["scores"], g, t["alt_arcs"],
                          t["alt_scores"])
    assert lat.consensus(again) == lat.consensus(pl)
