"""ctypes binding to the port's native WFST core (`csrc/wfst.cpp`).

The port's copy of `dsr_tpu/asr/fsm/native.py`.  The C++ core implements
the build-time hot ops (compose with the 3-state eps filter, weighted
determinization, rmepsilon; compose and rmepsilon end with connect);
`ops/cuda/build.py` compiles it with `g++` at first use into the port's
git-ignored build directory.  A failed build raises: `Wfst` has no Python
fallback.

Graphs cross the boundary as CSR arrays: int64 per-state arc offsets,
int32 ilabel/olabel/nextstate, f32 weights, and a dense f32 final-weight
vector (+inf = non-final).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dsr_tpu_torch.asr.fsm.wfst import Wfst
from dsr_tpu_torch.ops.cuda import build


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = build.library("wfst")
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dsr_fst_create.restype = ctypes.c_void_p
    lib.dsr_fst_create.argtypes = [
        ctypes.c_int, ctypes.c_int64, i64p, i32p, i32p, f32p, i32p,
        ctypes.c_int, f32p,
    ]
    lib.dsr_fst_free.restype = None
    lib.dsr_fst_free.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_num_states.restype = ctypes.c_int
    lib.dsr_fst_num_states.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_num_arcs.restype = ctypes.c_int64
    lib.dsr_fst_num_arcs.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_start.restype = ctypes.c_int
    lib.dsr_fst_start.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_copy_out.restype = None
    lib.dsr_fst_copy_out.argtypes = [
        ctypes.c_void_p, i64p, i32p, i32p, f32p, i32p, f32p,
    ]
    lib.dsr_fst_compose.restype = ctypes.c_void_p
    lib.dsr_fst_compose.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dsr_fst_determinize.restype = ctypes.c_void_p
    lib.dsr_fst_determinize.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dsr_fst_rmepsilon.restype = ctypes.c_void_p
    lib.dsr_fst_rmepsilon.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_arcsort.restype = None
    lib.dsr_fst_arcsort.argtypes = [ctypes.c_void_p]
    lib.dsr_fst_max_outdeg.restype = ctypes.c_int64
    lib.dsr_fst_max_outdeg.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _to_csr(f: Wfst, sort_ilabel: bool = False):
    n = f.num_states
    na = f.num_arcs
    off = np.zeros(n + 1, np.int64)
    il = np.empty(na, np.int32)
    ol = np.empty(na, np.int32)
    w = np.empty(na, np.float32)
    nxt = np.empty(na, np.int32)
    fin = np.full(n, np.inf, np.float32)
    p = 0
    for s in range(n):
        arcs = f.arcs[s]
        if sort_ilabel:
            arcs = sorted(arcs, key=lambda a: a.ilabel)
        for a in arcs:
            il[p], ol[p], w[p], nxt[p] = a.ilabel, a.olabel, a.weight, a.nextstate
            p += 1
        off[s + 1] = p
    for s, fw in f.finals.items():
        fin[s] = fw
    return off, il, ol, w, nxt, f.start, fin


def _from_csr(off, il, ol, w, nxt, start, fin) -> Wfst:
    n = len(off) - 1
    out = Wfst()
    for _ in range(n):
        out.add_state()
    if n:
        out.set_start(start)
    for s in range(n):
        for a in range(off[s], off[s + 1]):
            out.add_arc(s, int(il[a]), int(ol[a]), float(w[a]), int(nxt[a]))
        if np.isfinite(fin[s]):
            out.set_final(s, float(fin[s]))
    return out


def determinize(f: Wfst, max_states: int = 1_000_000) -> Wfst:
    return NativeFst.from_wfst(f).determinize(max_states).to_wfst()


def rmepsilon(f: Wfst) -> Wfst:
    return NativeFst.from_wfst(f).rmepsilon().to_wfst()


def compose(a: Wfst, b: Wfst) -> Wfst:
    # the C++ compose binary-searches B's arcs: stable-sorted by ilabel here,
    # as the JAX package's binding does (not by `arcsort`'s (ilabel, olabel),
    # which would number the result's states differently)
    ha, hb = NativeFst.from_wfst(a), NativeFst.from_wfst(b, sort_ilabel=True)
    return NativeFst(ha._lib.dsr_fst_compose(ha._h, hb._h)).to_wfst()


class NativeFst:
    """Owning handle to a C++ Fst: ops chain handle to handle, so LVCSR-scale
    build pipelines (compose, determinize, compose, rmepsilon) never
    round-trip through Python `Wfst` objects.  Only `to_csr()` and
    `to_wfst()` copy arrays out.  The handle is freed by `free()` or when
    the object is collected."""

    def __init__(self, handle):
        if not handle:
            raise RuntimeError("native op returned null handle")
        self._h = handle
        self._lib = _load()

    # ------------------------------------------------------------ lifecycle
    def __del__(self):
        self.free()

    def free(self):
        if getattr(self, "_h", None):
            self._lib.dsr_fst_free(self._h)
            self._h = None

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_wfst(cls, f: Wfst, sort_ilabel: bool = False) -> "NativeFst":
        return cls.from_csr(*_to_csr(f, sort_ilabel))

    @classmethod
    def from_csr(cls, off, il, ol, w, nxt, start: int, fin) -> "NativeFst":
        """From CSR arrays.  off: (S+1,) int64; il/ol/nxt: (A,) int32;
        w: (A,) f32; fin: (S,) f32 (+inf = non-final)."""
        lib = _load()
        off = np.ascontiguousarray(off, np.int64)
        il = np.ascontiguousarray(il, np.int32)
        ol = np.ascontiguousarray(ol, np.int32)
        w = np.ascontiguousarray(w, np.float32)
        nxt = np.ascontiguousarray(nxt, np.int32)
        fin = np.ascontiguousarray(fin, np.float32)
        S = len(off) - 1
        if not (len(ol) == len(w) == len(nxt) == len(il) == off[-1]) or len(fin) != S:
            raise ValueError("from_csr: inconsistent CSR array lengths")
        h = lib.dsr_fst_create(
            S, len(il), _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
            _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
            _ptr(nxt, ctypes.c_int32), int(start), _ptr(fin, ctypes.c_float),
        )
        return cls(h)

    # ------------------------------------------------------------ properties
    @property
    def num_states(self) -> int:
        return self._lib.dsr_fst_num_states(self._h)

    @property
    def num_arcs(self) -> int:
        return self._lib.dsr_fst_num_arcs(self._h)

    @property
    def max_outdeg(self) -> int:
        return self._lib.dsr_fst_max_outdeg(self._h)

    # ------------------------------------------------------------------- ops
    def compose(self, other: "NativeFst") -> "NativeFst":
        """self ∘ other; sorts other's arcs in place first (the C++ compose
        binary-searches B's arcs)."""
        self._lib.dsr_fst_arcsort(other._h)
        return NativeFst(self._lib.dsr_fst_compose(self._h, other._h))

    def determinize(self, max_states: int = 10_000_000) -> "NativeFst":
        rh = self._lib.dsr_fst_determinize(self._h, max_states)
        if not rh:
            raise RuntimeError(
                "determinize exceeded max_states — input likely violates "
                "the twins property (undeterminizable)"
            )
        return NativeFst(rh)

    def rmepsilon(self) -> "NativeFst":
        return NativeFst(self._lib.dsr_fst_rmepsilon(self._h))

    # ---------------------------------------------------------------- export
    def to_csr(self):
        """→ (off int64 (S+1), il, ol int32, w f32, nxt int32, start, fin f32)."""
        lib, h = self._lib, self._h
        n = lib.dsr_fst_num_states(h)
        na = lib.dsr_fst_num_arcs(h)
        off = np.zeros(n + 1, np.int64)
        il = np.empty(na, np.int32)
        ol = np.empty(na, np.int32)
        w = np.empty(na, np.float32)
        nxt = np.empty(na, np.int32)
        fin = np.empty(max(n, 1), np.float32)
        if n:
            lib.dsr_fst_copy_out(
                h, _ptr(off, ctypes.c_int64), _ptr(il, ctypes.c_int32),
                _ptr(ol, ctypes.c_int32), _ptr(w, ctypes.c_float),
                _ptr(nxt, ctypes.c_int32), _ptr(fin, ctypes.c_float),
            )
        return off, il, ol, w, nxt, (lib.dsr_fst_start(h) if n else -1), fin[:n]

    def to_wfst(self) -> Wfst:
        return _from_csr(*self.to_csr())
