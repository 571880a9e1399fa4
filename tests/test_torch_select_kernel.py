"""The select kernel's plain twin against the Pallas select kernel, and
the CUDA kernel's block routine (`ops/cuda/csrc/select.cu`: its keys and
its passes over large pools), transcribed to NumPy, against the twin.
The kernel itself is held to the twin on the card by chip_smoke.py.

Tolerance: none.  The function only moves its input values, so outputs
must be equal bit for bit (the Pallas kernel's as a set of kept tokens).
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import NEG, select_case
from dsr_tpu.ops.pallas import select as psel
from dsr_tpu_torch.ops.cuda import select as sel

F32NEG = np.float32(NEG)


def test_twin_matches_pallas_kernel():
    """The Pallas select kernel (interpret mode) at N = 2,048, kcap 128:
    with spill False it certifies the sort path's result, so the twin's
    kept (dst, score, arc) triples must be the same."""
    c, d, a = select_case(7, 1, 2048, 700)
    ks, kd, ka, spill = psel.recombine_topk(jnp.asarray(c[0]), jnp.asarray(d[0]),
                                            jnp.asarray(a[0]), jnp.float32(40.0), kcap=128)
    assert not bool(spill)
    s, dd, aa = sel.recombine_topk(*(torch.as_tensor(x) for x in (c, d, a)), 40.0, 128)
    triples = lambda s_, d_, a_: sorted(  # noqa: E731
        (int(x), float(y), int(z)) for x, y, z in zip(d_, s_, a_) if y > NEG / 2)
    assert triples(s[0].numpy(), dd[0].numpy(), aa[0].numpy()) == triples(
        np.asarray(ks), np.asarray(kd), np.asarray(ka))


# ------------------------------------------- select.cu's blocks, in NumPy

_NOKEY, _NOPAY, _LO = np.uint64(2**64 - 1), np.uint32(2**32 - 1), np.uint64(2**32 - 1)


def _ordered(s):
    """The kernel's order-preserving uint32 of a float (-0 as +0)."""
    b = s.astype(np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def _unordered(u, negzero):
    u = u.astype(np.uint32)
    f = np.where(u & 0x80000000, u & np.uint32(0x7FFFFFFF), ~u).astype(np.uint32).view(np.float32)
    return np.where(negzero.astype(bool), np.float32(-0.0), f).astype(np.float32)


def _negzero(s):
    return (s.astype(np.float32).view(np.uint32) == 0x80000000).astype(np.uint32)


def _block(s, d, a, beam, dup_in, kcap, partial):
    """One thread block of select_kernel: sort by (dst, ~score, arc), mark
    run firsts, re-key by (~val, dst), sort, write kcap slots (+ flag)."""
    valid = d != -1
    key = np.full(len(s), _NOKEY, np.uint64)
    pay = np.full(len(s), _NOPAY, np.uint32)
    key[valid] = ((d[valid].astype(np.uint64) << np.uint64(32))
                  | (~_ordered(s[valid])).astype(np.uint64))
    pay[valid] = (a[valid].astype(np.uint32) << np.uint32(1)) | _negzero(s[valid])
    o = np.lexsort((pay, key))
    key, pay = key[o], pay[o]
    live = key != _NOKEY
    hi = key >> np.uint64(32)
    first = live & np.r_[True, hi[1:] != hi[:-1]]
    sv = _unordered((~key) & _LO, pay & 1)
    dup = bool((live & ~first).any()) or (dup_in is not None and bool(dup_in.any()))
    key2 = np.full(len(s), _NOKEY, np.uint64)
    pay2 = np.full(len(s), _NOPAY, np.uint32)
    if partial:
        m, v = first, sv
    else:
        mx = np.where(first, sv, F32NEG)[live].max()
        if dup:
            mx = max(mx, F32NEG)
        v = np.where(first, sv, F32NEG)
        v = np.where(v > np.float32(mx) - np.float32(beam), v, F32NEG).astype(np.float32)
        m = live
    key2[m] = ((_ordered(v[m]).astype(np.uint64) ^ _LO) << np.uint64(32)) | hi[m]
    pay2[m] = ((pay[m] >> np.uint32(1)) << np.uint32(1)) | _negzero(v[m])
    o = np.lexsort((pay2, key2))
    key2, pay2 = key2[o], pay2[o]
    out = (np.full(kcap, F32NEG, np.float32), np.full(kcap, -1 if partial else 0, np.int32),
           np.full(kcap, -1, np.int32))
    n = min(kcap, len(s))
    ok = key2[:n] != _NOKEY
    val = _unordered((key2[:n] >> np.uint64(32)) ^ _LO, pay2[:n] & 1)
    out[0][:n] = np.where(ok, val, F32NEG)
    keep = ok & (partial | (val > NEG / 2))
    out[1][:n] = np.where(keep, (key2[:n] & _LO).astype(np.int64), out[1][:n])
    out[2][:n] = np.where(keep, (pay2[:n] >> np.uint32(1)).astype(np.int64), -1)
    return out, dup or (kcap < len(s) and key2[kcap] != _NOKEY)


def _partial_pass(lists, flags, beam, kcap, chunk, group):
    """One partial launch: a block per `chunk` entries, each OR-ing the
    flags of its `group` input lists into its own."""
    s, d, a = lists
    parts = [_block(s[i:i + chunk], d[i:i + chunk], a[i:i + chunk], beam,
                    None if flags is None else flags[b * group:(b + 1) * group], kcap, True)
             for b, i in enumerate(range(0, len(s), chunk))]
    return ([np.concatenate([p[0][j] for p in parts]) for j in range(3)],
            np.array([p[1] for p in parts]))


def _kernel_in_numpy(s, d, a, beam, kcap, chunk):
    """The passes `ops/cuda/select.py` chains: per-chunk lists, merge passes
    over groups of chunk // kcap lists while they exceed a block, final."""
    lists, flags = [s, d, a], None
    if len(s) > chunk:
        lists, flags = _partial_pass(lists, None, beam, kcap, chunk, 0)
        while len(lists[0]) > chunk:
            group = chunk // kcap
            lists, flags = _partial_pass(lists, flags, beam, kcap, group * kcap, group)
    return _block(*lists, beam, flags, kcap, False)[0]


def test_kernel_blocks_in_numpy_match_twin():
    """select.cu's key encoding and its split of a large pool (per-chunk
    top-kcap lists and duplicate flags, merge passes over groups of lists
    while they exceed a block, then the one-pass routine over the last
    lists), transcribed to NumPy with small chunks, equal the twin bit for
    bit.  The last two cases take one and two merge passes."""
    for seed, (N, kcap, ndst, chunk) in enumerate([
            (2304, 256, 768, 16384), (5000, 32, 1700, 512), (3000, 128, 100, 1024),
            (700, 40, 5000, 256), (20000, 256, 7000, 8192), (20000, 64, 9000, 512),
            (9000, 16, 40, 64)]):
        for beam in (40.0, 2.0, 1e9):
            c, d, a = select_case(seed, 1, N, ndst, grid=2.0, pad=0.15)
            c[0, ::50] = -0.0
            got = _kernel_in_numpy(c[0], d[0], a[0], beam, kcap, chunk)
            ref = sel.recombine_topk_plain(*(torch.as_tensor(x) for x in (c, d, a)),
                                           torch.tensor([beam], dtype=torch.float32), kcap)
            assert np.array_equal(got[0].view(np.uint32), ref[0][0].numpy().view(np.uint32))
            assert np.array_equal(got[1], ref[1][0].numpy())
            assert np.array_equal(got[2], ref[2][0].numpy())


def _lattice_block_in_numpy(s, d, a, beam, kcap, nlat):
    """select_kernel<true>: one block over the whole pool.  After the first
    sort the (dst, score, arc) triples go to the scratch; the second sort
    carries each entry's position in place of its arc; the slots gather
    their arc and their alternates (positions pos .. pos + nlat - 1 while
    in the run, the pool and the beam) from the scratch."""
    n = len(s)
    key = (d.astype(np.uint64) << np.uint64(32)) | (~_ordered(s)).astype(np.uint64)
    pay = (a.astype(np.uint32) << np.uint32(1)) | _negzero(s)
    o = np.lexsort((pay, key))
    key, pay = key[o], pay[o]
    hi = key >> np.uint64(32)
    first = np.r_[True, hi[1:] != hi[:-1]]
    ls = _unordered((~key) & _LO, pay & 1)
    ld, la = hi.astype(np.int64), (pay >> np.uint32(1)).astype(np.int64)
    mx = np.where(first, ls, F32NEG).max()
    if (~first).any():
        mx = max(mx, F32NEG)
    thr = np.float32(mx) - np.float32(beam)
    v = np.where(first, ls, F32NEG)
    v = np.where(v > thr, v, F32NEG).astype(np.float32)
    key2 = ((_ordered(v).astype(np.uint64) ^ _LO) << np.uint64(32)) | hi
    pay2 = (np.arange(n, dtype=np.uint32) << np.uint32(1)) | _negzero(v)
    o = np.lexsort((pay2, key2))
    key2, pay2 = key2[o], pay2[o]
    k = min(kcap, n)
    val = _unordered((key2[:k] >> np.uint64(32)) ^ _LO, pay2[:k] & 1)
    pos = (pay2[:k] >> np.uint32(1)).astype(np.int64)
    alive = val > NEG / 2
    out = [np.full(kcap, F32NEG, np.float32), np.zeros(kcap, np.int32), np.full(kcap, -1, np.int32),
           np.full((kcap, nlat), F32NEG, np.float32), np.full((kcap, nlat), -1, np.int32)]
    out[0][:k] = val
    out[1][:k] = np.where(alive, (key2[:k] & _LO).astype(np.int64), 0)
    out[2][:k] = np.where(alive, la[pos], -1)
    p = pos[:, None] + np.arange(nlat)
    pc = np.minimum(p, n - 1)
    ok = alive[:, None] & (p < n) & (ld[pc] == ld[pos][:, None]) & (ls[pc] > thr)
    out[3][:k] = np.where(ok, ls[pc], F32NEG)
    out[4][:k] = np.where(ok, la[pc], -1)
    return out


def test_lattice_block_in_numpy_matches_twin_and_sort_path():
    """The lattice mode's block (its scratch of dst-sorted triples and the
    run-start positions carried through the second sort), in NumPy, equals
    the twin bit for bit, and the twin's alternates equal the JAX decoders'
    XLA lattice path (`topk_decoder.py:233-248`) transcribed to NumPy:
    beams 40 / 2 / 1e9, nlat 1 to 512 (beyond any run), signed zeros,
    pools smaller than kcap."""
    for seed, (N, kcap, ndst, nlat) in enumerate([
            (2304, 256, 768, 4), (3000, 128, 100, 8), (700, 40, 5000, 3), (100, 256, 30, 1),
            (4805, 155, 155, 512)]):
        for beam in (40.0, 2.0, 1e9):
            c, d, a = select_case(100 + seed, 1, N, ndst, grid=2.0, pad=0.15)
            c[0, ::50] = -0.0
            ref = sel.recombine_topk_plain(*(torch.as_tensor(x) for x in (c, d, a)),
                                           torch.tensor([beam], dtype=torch.float32), kcap, nlat)
            got = _lattice_block_in_numpy(c[0], d[0], a[0], beam, kcap, nlat)
            for g, r in zip(got, ref):
                r = r[0].numpy()
                assert np.array_equal(g.view(np.uint32) if g.dtype == np.float32 else g,
                                      r.view(np.uint32) if r.dtype == np.float32 else r)
            # the XLA path: sort by (dst, -score, arc), idx = top_k's run starts
            order = np.lexsort((a[0], -c[0], d[0]))
            sd, sv, sa = d[0][order], c[0][order], a[0][order]
            first = np.r_[True, sd[1:] != sd[:-1]]
            val = np.where(first, sv, F32NEG)
            thr = np.float32(val.max()) - np.float32(beam)
            val = np.where(val > thr, val, F32NEG)
            idx = np.argsort(-val, kind="stable")[:kcap]
            pos = idx[:, None] + np.arange(nlat)
            pc = np.minimum(pos, N - 1)
            ok = ((sd[pc] == sd[idx][:, None]) & (pos < N) & (val[idx] > NEG / 2)[:, None]
                  & (sv[pc] > thr))
            k = len(idx)
            assert np.array_equal(ref[4][0, :k].numpy(), np.where(ok, sa[pc], -1))
            assert np.array_equal(ref[3][0, :k].numpy(), np.where(ok, sv[pc], F32NEG))
