"""Weighted finite-state transducers over the tropical semiring.

The port's copy of `dsr_tpu/asr/fsm/wfst.py`: the build-time (host) data
structure the H/L/G builders fill, with `compose` (3-state epsilon
filter), `determinize` (weighted subset construction; transducers via the
(ilabel, olabel) pair encoding) and `rmepsilon` (tropical epsilon closure)
run by the port's native core (`asr/fsm/csrc/wfst.cpp`, through
`asr/fsm/native.py`).  There is no Python fallback: if the core cannot be
built, its build error is raised.  Weights are -log probabilities
(tropical: plus = min, times = +).

The host-Python algorithms are the reference's, line for line: `copy`,
`connect`, `reverse`, `shortest_distance` (Dijkstra), `rmepsilon_input`
(the input-epsilon closure the triphone build needs after its
delayed-emission context transducer), `push` (weight pushing toward the
start), `minimize` (push, then partition refinement on rounded weights)
and `path_weight` (best path accepting an input string).

Not copied: the reference's pure-Python compose, determinize and
rmepsilon bodies (its fallback when the native core is missing).
"""

from __future__ import annotations

import heapq
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

    def copy(self) -> "Wfst":
        out = Wfst()
        out.arcs = [[Arc(*a) for a in lst] for lst in self.arcs]
        out.finals = dict(self.finals)
        out.start = self.start
        return out

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

    def reverse(self) -> "Wfst":
        """Arcs reversed; new superinitial state; finals ↔ start."""
        out = Wfst()
        sup = out.add_state()
        for _ in range(self.num_states):
            out.add_state()
        out.set_start(sup)
        for s, w in self.finals.items():
            out.add_arc(sup, EPS, EPS, w, s + 1)
        for s in range(self.num_states):
            for a in self.arcs[s]:
                out.add_arc(a.nextstate + 1, a.ilabel, a.olabel, a.weight, s + 1)
        if self.start >= 0:
            out.set_final(self.start + 1, 0.0)
        return out

    def shortest_distance(self, reverse: bool = False) -> list[float]:
        """Tropical shortest distance from start (or to finals if reverse)."""
        if reverse:
            rev = self.reverse()
            d = rev.shortest_distance()
            return d[1:]  # drop superinitial
        n = self.num_states
        dist = [INF] * n
        if self.start < 0:
            return dist
        dist[self.start] = 0.0
        pq = [(0.0, self.start)]
        while pq:
            d, s = heapq.heappop(pq)
            if d > dist[s] + 1e-12:
                continue
            for a in self.arcs[s]:
                nd = d + a.weight
                if nd < dist[a.nextstate] - 1e-12:
                    dist[a.nextstate] = nd
                    heapq.heappush(pq, (nd, a.nextstate))
        return dist

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

    # ------------------------------------------------------ input epsilons
    def rmepsilon_input(self) -> "Wfst":
        """Remove ALL input-epsilon arcs, pushing their output labels onto
        successor emitting arcs.

        Needed after composing a delayed-emission context transducer: the
        first word's olabel rides an (eps : word) arc there.  Closure is
        tropical-best per destination; a closure path may carry at most one
        olabel and the successor arc it lands on must be olabel-free
        (collision ⇒ ValueError — give the lexicon ≥2-phone words or a
        mandatory silence to guarantee this).
        """
        n = self.num_states
        out = Wfst()
        for _ in range(n):
            out.add_state()
        out.set_start(self.start)
        for s in range(n):
            # Dijkstra over input-eps arcs, carrying (weight, olabels tuple)
            best: dict[int, tuple[float, tuple]] = {s: (0.0, ())}
            pq = [(0.0, s, ())]
            while pq:
                d, u, olabs = heapq.heappop(pq)
                if d > best.get(u, (INF, ()))[0] + 1e-12:
                    continue
                for a in self.arcs[u]:
                    if a.ilabel == EPS:
                        nolabs = olabs + ((a.olabel,) if a.olabel != EPS else ())
                        if len(nolabs) > 1:
                            raise ValueError("input-eps closure with >1 output label")
                        nd = d + a.weight
                        if nd < best.get(a.nextstate, (INF, ()))[0] - 1e-12:
                            best[a.nextstate] = (nd, nolabs)
                            heapq.heappush(pq, (nd, a.nextstate, nolabs))
            fbest = INF
            for u, (d, olabs) in best.items():
                if self.is_final(u):
                    cand = d + self.final_weight(u)
                    if cand < fbest:
                        if olabs:
                            raise ValueError("output label on eps path to final")
                        fbest = cand
                for a in self.arcs[u]:
                    if a.ilabel == EPS:
                        continue
                    if olabs and a.olabel != EPS:
                        raise ValueError(
                            "olabel collision pushing through input-eps arcs"
                        )
                    ol = olabs[0] if olabs else a.olabel
                    out.add_arc(s, a.ilabel, ol, d + a.weight, a.nextstate)
            if fbest < INF:
                out.set_final(s, fbest)
        return out.connect()

    # ------------------------------------------------------------- pushing
    def push(self) -> "Wfst":
        """Push weights toward the initial state (tropical).

        Reweight by potentials d(s) = shortest distance to a final state:
        w'(s→t) = w + d(t) − d(s);  final'(s) = final(s) − d(s); then
        d(start) is folded back into the start state's outgoing arcs and
        final weight, so every total path weight is preserved EXACTLY.
        """
        d = self.shortest_distance(reverse=True)
        out = self.copy()
        for s in range(out.num_states):
            ds = d[s] if d[s] < INF else 0.0
            for a in out.arcs[s]:
                dt = d[a.nextstate] if d[a.nextstate] < INF else 0.0
                a.weight = a.weight + dt - ds
        for s in list(out.finals):
            ds = d[s] if d[s] < INF else 0.0
            out.finals[s] = out.finals[s] - ds
        if out.start >= 0 and d[out.start] < INF:
            ds0 = d[out.start]
            for a in out.arcs[out.start]:
                a.weight += ds0
            if out.start in out.finals:
                out.finals[out.start] += ds0
        return out

    # ------------------------------------------------------------ minimize
    def minimize(self) -> "Wfst":
        """Weighted minimization of a deterministic machine.

        push → partition refinement on (label, rounded weight, dest class).
        Transducer labels are treated as (i, o) pairs (encode-minimize).
        """
        m = self.push()
        n = m.num_states
        if n == 0:
            return m
        # initial partition: by final weight (rounded)
        def fkey(s):
            w = m.final_weight(s)
            return round(w, 6) if w < INF else None

        classes = {}
        part = [0] * n
        for s in range(n):
            k = fkey(s)
            if k not in classes:
                classes[k] = len(classes)
            part[s] = classes[k]
        changed = True
        while changed:
            changed = False
            sig_map = {}
            new_part = [0] * n
            for s in range(n):
                sig = (
                    part[s],
                    tuple(
                        sorted(
                            (a.ilabel, a.olabel, round(a.weight, 6), part[a.nextstate])
                            for a in m.arcs[s]
                        )
                    ),
                )
                if sig not in sig_map:
                    sig_map[sig] = len(sig_map)
                new_part[s] = sig_map[sig]
            if new_part != part:
                part = new_part
                changed = True
        # build quotient
        out = Wfst()
        num_classes = max(part) + 1
        for _ in range(num_classes):
            out.add_state()
        out.set_start(part[m.start])
        added = set()
        for s in range(n):
            c = part[s]
            if (c, "F") not in added and m.is_final(s):
                out.set_final(c, m.final_weight(s))
                added.add((c, "F"))
            for a in m.arcs[s]:
                key = (c, a.ilabel, a.olabel, round(a.weight, 6), part[a.nextstate])
                if key not in added:
                    out.add_arc(c, a.ilabel, a.olabel, a.weight, part[a.nextstate])
                    added.add(key)
        return out.connect()

    # ---------------------------------------------------------- accepting
    def path_weight(self, ilabels: list[int]) -> float:
        """Tropical weight of the best path accepting `ilabels` (eps-free
        graphs only on the input side for simplicity in tests)."""
        if self.start < 0 or not self.arcs:
            return INF
        frontier = {self.start: 0.0}
        # eps closure helper
        def closure(front):
            pq = [(w, s) for s, w in front.items()]
            best = dict(front)
            heapq.heapify(pq)
            while pq:
                w, s = heapq.heappop(pq)
                if w > best.get(s, INF) + 1e-12:
                    continue
                for a in self.arcs[s]:
                    if a.ilabel == EPS:
                        nw = w + a.weight
                        if nw < best.get(a.nextstate, INF) - 1e-12:
                            best[a.nextstate] = nw
                            heapq.heappush(pq, (nw, a.nextstate))
            return best

        frontier = closure(frontier)
        for lab in ilabels:
            nxt: dict[int, float] = {}
            for s, w in frontier.items():
                for a in self.arcs[s]:
                    if a.ilabel == lab:
                        nw = w + a.weight
                        if nw < nxt.get(a.nextstate, INF):
                            nxt[a.nextstate] = nw
            frontier = closure(nxt)
            if not frontier:
                return INF
        return min(
            (w + self.final_weight(s) for s, w in frontier.items() if self.is_final(s)),
            default=INF,
        )
