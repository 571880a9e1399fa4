"""Port parity: the host-Python WFST algorithms of `dsr_tpu_torch/asr/fsm/
wfst.py` (`copy`, `reverse`, `shortest_distance`, `rmepsilon_input`,
`push`, `minimize`, `path_weight`) against the JAX package's, on small
random machines built arc for arc in both packages from a seeded
`random.Random`; and tests/test_wfst.py's properties of `minimize` and
`push` on the port's machines.

Tolerance: none between the packages (the same float64 Python arithmetic
in the same order: results equal arc for arc, weights bit for bit); the
properties hold path weights to 1e-6, as tests/test_wfst.py does.
"""

import math
import random

import pytest

from dsr_tpu.asr.fsm import wfst as jwfst
from dsr_tpu_torch.asr.fsm import wfst

INF = float("inf")


def _random(rng, n_states=6, n_labels=3, n_arcs=12, eps_frac=0.2, acyclic=False,
            transducer=False):
    """The same random machine as (port Wfst, JAX Wfst): tests/test_wfst.py's
    `_random_acceptor`, optionally with independent output labels."""
    arcs, finals = [], {n_states - 1: round(rng.random(), 3)}
    if rng.random() < 0.5:
        finals[rng.randrange(n_states)] = round(rng.random(), 3)
    for _ in range(n_arcs):
        s, d = rng.randrange(n_states), rng.randrange(n_states)
        if acyclic:
            if s == d:
                continue
            s, d = min(s, d), max(s, d)
        il = 0 if rng.random() < eps_frac else rng.randrange(1, n_labels + 1)
        ol = (0 if rng.random() < 0.5 else rng.randrange(1, n_labels + 1)) if transducer else il
        arcs.append((s, il, ol, round(rng.random(), 3), d))
    out = []
    for cls in (wfst.Wfst, jwfst.Wfst):
        f = cls()
        for _ in range(n_states):
            f.add_state()
        f.set_start(0)
        for s, w in finals.items():
            f.set_final(s, w)
        for s, il, ol, w, d in arcs:
            f.add_arc(s, il, ol, w, d)
        out.append(f)
    return out


def _as_tuple(f):
    return (f.start, sorted(f.finals.items()),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in lst] for lst in f.arcs])


def _strings(n_labels=3, max_len=4):
    out, frontier = [[]], [[]]
    for _ in range(max_len):
        frontier = [s + [lab] for s in frontier for lab in range(1, n_labels + 1)]
        out.extend(frontier)
    return out


def test_copy_reverse_distance_push_path_weight_match_jax():
    rng = random.Random(0)
    for trial in range(12):
        f, jf = _random(rng, acyclic=trial % 2 == 0, transducer=trial % 3 == 0)
        g = f.copy()
        g.arcs[0].append(wfst.Arc(1, 1, 9.0, 0))       # a deep copy: f keeps its arcs
        assert _as_tuple(f) == _as_tuple(jf)
        assert _as_tuple(f.reverse()) == _as_tuple(jf.reverse())
        for rev in (False, True):
            assert f.shortest_distance(reverse=rev) == jf.shortest_distance(reverse=rev)
        assert _as_tuple(f.push()) == _as_tuple(jf.push())
        for s in _strings():
            assert f.path_weight(s) == jf.path_weight(s)


def test_minimize_matches_jax_and_keeps_weights():
    """tests/test_wfst.py:114 and :124 on the port, and the port's minimal
    machine equal to the JAX package's."""
    rng = random.Random(2)
    for _ in range(6):
        f, jf = _random(rng, eps_frac=0.0, acyclic=True)
        d, jd = f.determinize(), jf.determinize()
        assert _as_tuple(d) == _as_tuple(jd)
        m = d.minimize()
        assert _as_tuple(m) == _as_tuple(jd.minimize())
        assert m.num_states <= d.num_states
        for s in _strings():
            w1, w2 = d.path_weight(s), m.path_weight(s)
            assert (w1 == INF and w2 == INF) or w1 == pytest.approx(w2, abs=1e-6)
    f, _ = _random(random.Random(3), eps_frac=0.0, acyclic=True)
    p = f.push()
    alive = [s for s in _strings() if f.path_weight(s) < INF]
    shift = [f.path_weight(s) - p.path_weight(s) for s in alive]
    assert all(math.isclose(x, shift[0], abs_tol=1e-6) for x in shift)


def test_rmepsilon_input_matches_jax_and_raises_on_collision():
    rng = random.Random(4)
    outcomes = set()
    for _ in range(30):
        f, jf = _random(rng, n_arcs=9, eps_frac=0.4, transducer=True)
        try:
            ref = _as_tuple(jf.rmepsilon_input())
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                f.rmepsilon_input()
            outcomes.add("raised")
            continue
        out = f.rmepsilon_input()
        assert _as_tuple(out) == ref
        assert all(a.ilabel != wfst.EPS for lst in out.arcs for a in lst)
        outcomes.add("removed")
    assert outcomes == {"raised", "removed"}
    # an input-eps arc with an olabel into an arc with its own olabel
    f = wfst.Wfst()
    for _ in range(3):
        f.add_state()
    f.set_start(0)
    f.set_final(2)
    f.add_arc(0, 0, 5, 0.0, 1)
    f.add_arc(1, 1, 6, 0.0, 2)
    with pytest.raises(ValueError, match="olabel collision"):
        f.rmepsilon_input()
