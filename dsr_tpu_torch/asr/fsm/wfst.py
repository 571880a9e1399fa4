"""Weighted finite-state transducers over the tropical semiring.

The port's copy of `dsr_tpu/asr/fsm/wfst.py`: the build-time (host) data
structure the H/L/G builders fill, with `compose` (3-state epsilon
filter), `determinize` (weighted subset construction; transducers via the
(ilabel, olabel) pair encoding) and `rmepsilon` (tropical epsilon closure)
run by the port's native core (`asr/fsm/csrc/wfst.cpp`, through
`asr/fsm/native.py`).  There is no Python fallback: if the core cannot be
built, its build error is raised.  Weights are -log probabilities
(tropical: plus = min, times = +).

Not copied: `copy`, `minimize`, `push`, `shortest_distance`, `reverse`,
`path_weight` (no caller in the ported decode path) and `rmepsilon_input`
(the triphone build, ROADMAP).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass

EPS = 0  # label 0 is epsilon by convention
INF = float("inf")


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int

    def __iter__(self):  # unpacking convenience
        yield from (self.ilabel, self.olabel, self.weight, self.nextstate)


class Wfst:
    """Mutable WFST; states are dense ints, state 0 exists after first add."""

    def __init__(self):
        self.arcs: list[list[Arc]] = []
        self.finals: dict[int, float] = {}
        self.start: int = -1

    # ------------------------------------------------------------- building
    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def set_start(self, s: int):
        self.start = s

    def set_final(self, s: int, weight: float = 0.0):
        self.finals[s] = weight

    def add_arc(self, s: int, ilabel: int, olabel: int, weight: float, nextstate: int):
        self.arcs[s].append(Arc(ilabel, olabel, weight, nextstate))

    def is_final(self, s: int) -> bool:
        return s in self.finals

    def final_weight(self, s: int) -> float:
        return self.finals.get(s, INF)

    def arcsort(self, by: str = "ilabel"):
        if by == "ilabel":
            key = lambda a: (a.ilabel, a.olabel)  # noqa: E731
        else:
            key = lambda a: (a.olabel, a.ilabel)  # noqa: E731
        for lst in self.arcs:
            lst.sort(key=key)
        return self

    # ------------------------------------------------------------ utilities
    def connect(self) -> "Wfst":
        """Trim states not on a successful path (accessible ∧ coaccessible)."""
        n = self.num_states
        if self.start < 0:
            return Wfst()
        acc = [False] * n
        dq = deque([self.start])
        acc[self.start] = True
        while dq:
            s = dq.popleft()
            for a in self.arcs[s]:
                if not acc[a.nextstate]:
                    acc[a.nextstate] = True
                    dq.append(a.nextstate)
        radj = defaultdict(list)
        for s in range(n):
            for a in self.arcs[s]:
                radj[a.nextstate].append(s)
        coacc = [False] * n
        dq = deque(s for s in self.finals if acc[s])
        for s in dq:
            coacc[s] = True
        while dq:
            s = dq.popleft()
            for p in radj[s]:
                if not coacc[p]:
                    coacc[p] = True
                    dq.append(p)
        keep = [s for s in range(n) if acc[s] and coacc[s]]
        remap = {s: i for i, s in enumerate(keep)}
        out = Wfst()
        for _ in keep:
            out.add_state()
        for s in keep:
            for a in self.arcs[s]:
                if a.nextstate in remap:
                    out.add_arc(remap[s], a.ilabel, a.olabel, a.weight, remap[a.nextstate])
        if self.start in remap:
            out.set_start(remap[self.start])
        for s, w in self.finals.items():
            if s in remap:
                out.set_final(remap[s], w)
        return out

    # ------------------------------------------------ native-core algorithms
    def compose(self, other: "Wfst") -> "Wfst":
        """self ∘ other with the 3-state epsilon filter (0 = free, 1 = eps
        taken on self's output side only, 2 = eps taken on other's input side
        only) plus the joint eps:eps move; ends with `connect`."""
        from dsr_tpu_torch.asr.fsm import native
        return native.compose(self, other)

    def rmepsilon(self) -> "Wfst":
        """Remove eps:eps arcs via per-state tropical epsilon closure; ends
        with `connect`."""
        from dsr_tpu_torch.asr.fsm import native
        return native.rmepsilon(self)

    def determinize(self) -> "Wfst":
        """Weighted determinization: subset construction over tropical
        residuals, with (ilabel, olabel) pairs as labels."""
        from dsr_tpu_torch.asr.fsm import native
        return native.determinize(self)
