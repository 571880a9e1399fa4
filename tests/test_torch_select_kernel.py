"""The select kernel's plain twin against the Pallas select kernel, and
the CUDA kernel's algorithm (`ops/cuda/csrc/select.cu`: recombination by a
hash of destinations, radix select of the winners' keys, the lattice
mode's per-slot buckets), transcribed to NumPy, against the twin.  The
kernel itself is held to the twin on the card by chip_smoke.py.

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




# ------------------------------------------- select.cu's algorithm, in NumPy

U64, U32 = np.uint64, np.uint32
_NOKEY, _LO = U64(2**64 - 1), U64(2**32 - 1)
_WARP_BUCKET = 128     # select.cu's kWarpBucket


def _ordered(s):
    """The kernel's order-preserving uint32 of a float (-0 as +0)."""
    b = s.astype(np.float32).view(U32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | U32(0x80000000)).astype(U32)


def _unordered(u, negzero):
    u = u.astype(U32)
    f = np.where(u & 0x80000000, u & U32(0x7FFFFFFF), ~u).astype(U32).view(np.float32)
    return np.where(negzero.astype(bool), np.float32(-0.0), f).astype(np.float32)


def _negzero(s):
    return (s.astype(np.float32).view(U32) == 0x80000000).astype(U32)


def _value(key):
    """A key's value (its high word is ~ordered(v)), bit of -0 from bit 0."""
    return _unordered(~(key >> U64(32)).astype(U32), (key & U64(1)).astype(U32))


def _top_sorted(keys, lo, hi, k, sb):
    """select.cu's top_sorted: the k smallest keys in [lo, hi), ascending,
    and their indices (-1 where equal keys fill the last places).  Radix
    select over 8-bit digits, high first, each pass inside the previous
    boundary bucket, until the keys below and in the bucket fit the sort
    buffer of sb entries; those are sorted (ties by index, as the bitonic
    network's payload breaks them)."""
    if k <= 0:
        return np.zeros(0, U64), np.zeros(0, np.int64), 0
    inr = (keys >= U64(lo)) & (keys < U64(hi))
    prefix, shift, count_lt, n_match, passes = 0, 64, 0, int(inr.sum()), 0
    while count_lt + n_match > sb and shift > 0:
        above = U64(0 if shift >= 64 else (2**64 - 1) ^ (2**shift - 1))
        shift -= 8
        digit = (keys[inr & ((keys & above) == U64(prefix))] >> U64(shift)) & U64(255)
        hist = np.bincount(digit.astype(np.int64), minlength=256)
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, k - count_lt))      # the count reaches k in digit d
        count_lt, n_match = count_lt + int(cum[d] - hist[d]), int(hist[d])
        prefix |= d << shift
        passes += 1
    fill = count_lt + n_match > sb                      # only equal keys remain
    rmask = U64(0 if shift >= 64 else (2**64 - 1) ^ (2**shift - 1))
    top = keys & rmask
    idx = np.nonzero(inr & ((top < U64(prefix)) | ((not fill) & (top == U64(prefix)))))[0]
    assert len(idx) <= sb
    idx = idx[np.lexsort((idx, keys[idx]))]
    out_k, out_i = keys[idx][:k], idx[:k]
    if len(out_k) < k:
        out_k = np.r_[out_k, np.full(k - len(out_k), U64(prefix))]
        out_i = np.r_[out_i, np.full(k - len(out_i), -1)]
    return out_k, out_i, passes


def _kernel_in_numpy(s, d, a, beam, kcap, nlat=0, sb=None):
    """select_kernel<nlat > 0> for one utterance.  sb: the sort buffer's
    entries (default the kernel's, pow2 >= max(256, 2 max(k, nlat)))."""
    n = len(s)
    k, leff = min(kcap, n), min(nlat, n)
    if sb is None:
        sb = 1 << max(8, int(np.ceil(np.log2(2 * max(k, leff)))))
    # 1. recombination: the table's entries are the distinct dsts; each
    # keeps the atomicMin of its candidates' words; a claimed dst met again
    # sets the duplicate flag
    word = ((~_ordered(s)).astype(U64) << U64(32)) | (
        (a.astype(U32) << U32(1)) | _negzero(s)).astype(U64)
    dsts, inv = np.unique(d, return_inverse=True)
    win = np.full(len(dsts), _NOKEY)
    np.minimum.at(win, inv, word)
    mx = s.max()
    if len(dsts) < n:
        mx = max(mx, F32NEG)
    thr = np.float32(mx) - np.float32(beam)
    # 2. the winners' keys and classes
    ws = _unordered(~(win >> U64(32)).astype(U32), (win & U64(1)).astype(U32))
    v = np.where(ws > thr, ws, F32NEG).astype(np.float32)
    key = ((~_ordered(v)).astype(U64) << U64(32)) | dsts.astype(U64)
    pay = (((win & _LO) >> U64(1)) << U64(1)).astype(U32) | _negzero(v)
    neg_lo = int(~_ordered(np.array([F32NEG]))[0]) << 32
    neg_end = neg_lo + 2**32
    na = int((key < U64(neg_lo)).sum())
    nb = int(((key >= U64(neg_lo)) & (key < U64(neg_end))).sum()) + n - len(dsts)
    nc = int((key >= U64(neg_end)).sum())
    # 3. live keys, NEG slots, values below NEG
    ka = min(k, na)
    kb = min(k - ka, nb)
    kc = k - ka - kb
    out = [np.full(kcap, F32NEG, np.float32), np.zeros(kcap, np.int32),
           np.full(kcap, -1, np.int32)]
    ktop, itop, _ = _top_sorted(key, 0, neg_lo, ka, sb)
    vtop = _unordered(~(ktop >> U64(32)).astype(U32), pay[itop] & U32(1))
    alive = vtop > NEG / 2
    out[0][:ka] = vtop
    out[1][:ka] = np.where(alive, (ktop & _LO).astype(np.int64), 0)
    out[2][:ka] = np.where(alive, (pay[itop] >> U32(1)).astype(np.int64), -1)
    kbot, _, _ = _top_sorted(key, neg_end, 2**64 - 1, kc, sb)
    out[0][ka + kb:k] = _unordered(~(kbot >> U64(32)).astype(U32), np.zeros(kc, U32))
    assert nc >= kc and not (kb < nb and kc)
    if not nlat:
        return out
    # 4. the live slots' buckets: candidates above thr of a live dst, in a
    # slot's bucket at its offset; a bucket of up to 128 ranked by (key,
    # position), a larger one through top_sorted
    live = int(alive.sum())
    slot = np.full(len(dsts), -1)
    slot[itop[:live]] = np.arange(live)
    j_of = np.where(s > thr, slot[inv], -1)
    cnt = np.bincount(j_of[j_of >= 0], minlength=live)
    off = np.r_[0, np.cumsum(cnt)]
    ck = ((~_ordered(s)).astype(U64) << U64(32)) | (
        (a.astype(U32) << U32(1)) | _negzero(s)).astype(U64)
    alt = [np.full((kcap, nlat), F32NEG, np.float32), np.full((kcap, nlat), -1, np.int32)]
    for j in range(live):
        bucket = ck[j_of == j]
        b = len(bucket)
        assert b == off[j + 1] - off[j]
        if b <= _WARP_BUCKET:
            top = bucket[np.lexsort((np.arange(b), bucket))][:nlat]
        else:
            top = _top_sorted(bucket, 0, 2**64 - 1, min(nlat, b), sb)[0]
        alt[0][j, :len(top)] = _value(top)
        alt[1][j, :len(top)] = ((top & _LO) >> U64(1)).astype(np.int64)
    return out + alt


def _cases():
    """Seeded pools with duplicate dsts, exact-score ties, NEG + NEG
    padding and signed zeros; then the edge cases: every candidate at
    NEG + NEG under a beam of 1e31 (with and without duplicates), a single
    dst, all dsts distinct, kcap above N."""
    for seed, (N, kcap, ndst) in enumerate([
            (2304, 256, 768), (5000, 32, 1700), (3000, 128, 100), (700, 40, 5000),
            (12032, 256, 4000), (9000, 16, 40)]):
        for beam in (40.0, 2.0, 1e9):
            c, d, a = select_case(seed, 1, N, ndst, grid=2.0, pad=0.15)
            c[0, ::50] = -0.0
            yield f"N={N} kcap={kcap} beam={beam}", c[0], d[0], a[0], beam, kcap
    rng = np.random.default_rng(11)
    for name, N, kcap, ndst, neg, beam in (
            ("all NEG + NEG, duplicates, beam 1e31", 3000, 256, 500, True, 1e31),
            ("all NEG + NEG, distinct dsts, beam 1e31", 600, 256, None, True, 1e31),
            ("a single dst", 2000, 64, 1, False, 40.0),
            ("a single dst, beam 1e31", 2000, 64, 1, False, 1e31),
            ("all dsts distinct", 2304, 256, None, False, 40.0),
            ("kcap above N", 100, 256, 60, False, 1e9)):
        c = (np.round(rng.standard_normal(N) * 40) / 4).astype(np.float32)
        if neg:
            c[:] = F32NEG + F32NEG
        d = (rng.permutation(N) if ndst is None else rng.integers(0, ndst, N)).astype(np.int32)
        a = rng.permutation(N).astype(np.int32)
        yield name, c, d, a, beam, kcap
    # identical candidates (the decoders' dead tokens share state 0, so
    # their arcs repeat): one dst's bucket holds 1,500 equal keys
    c, d, a = select_case(12, 1, 3000, 300, grid=2.0, pad=0.0)
    c[0, :1500], d[0, :1500], a[0, :1500] = 500.0, 3, 7
    yield "1,500 identical candidates", c[0], d[0], a[0], 1e9, 64


def _twin(c, d, a, beam, kcap, nlat=0):
    return [r[0].numpy() for r in sel.recombine_topk_plain(
        *(torch.as_tensor(x[None]) for x in (c, d, a)),
        torch.tensor([beam], dtype=torch.float32), kcap, nlat)]


def _same(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.array_equal(g.view(U32) if g.dtype == np.float32 else g,
                              r.view(U32) if r.dtype == np.float32 else r)


def test_kernel_blocks_in_numpy_match_twin():
    """select.cu's block (one per utterance), transcribed to NumPy, equals
    the twin bit for bit: the hash table's winner words and duplicate flag,
    the winners' keys in three classes, the radix select with its boundary
    bucket, with the kernel's sort buffer and with one of only pow2(k)
    entries (more histogram passes)."""
    passes = 0
    for name, c, d, a, beam, kcap in _cases():
        ref = _twin(c, d, a, beam, kcap)
        _same(_kernel_in_numpy(c, d, a, beam, kcap), ref)
        tight = 1 << max(1, int(np.ceil(np.log2(min(kcap, len(c))))))
        _same(_kernel_in_numpy(c, d, a, beam, kcap, sb=tight), ref)
        passes += 1
    assert passes == 25


def test_lattice_block_in_numpy_matches_twin_and_sort_path():
    """The lattice mode's block in NumPy (live dsts mapped to slots, the
    per-slot buckets of candidates above thr, ranked in registers up to 128
    and by the radix select above) equals the twin bit for bit, with the
    kernel's sort buffer and a tight one (duplicate keys fill a bucket's
    last places); and the twin's alternates equal the JAX decoders' XLA
    lattice path (`topk_decoder.py:233-248`) transcribed to NumPy: nlat 1
    to 512 (beyond any run), the edge cases of the 1-best test."""
    cases = list(_cases())
    for i, (name, c, d, a, beam, kcap) in enumerate(cases):
        nlat = (1, 3, 4, 8, 512)[i % 5]
        ref = _twin(c, d, a, beam, kcap, nlat)
        _same(_kernel_in_numpy(c, d, a, beam, kcap, nlat), ref)
        k = min(kcap, len(c))
        _same(_kernel_in_numpy(c, d, a, beam, kcap, nlat,
                               sb=1 << max(1, int(np.ceil(np.log2(max(k, min(nlat, len(c)))))))),
              ref)
        # the XLA path: sort by (dst, -score, arc), idx = top_k's run starts
        N = len(c)
        order = np.lexsort((a, -c, d))
        sd, sv, sa = d[order], c[order], a[order]
        first = np.r_[True, sd[1:] != sd[:-1]]
        val = np.where(first, sv, F32NEG)
        thr = np.float32(val.max()) - np.float32(beam)
        val = np.where(val > thr, val, F32NEG)
        idx = np.argsort(-val, kind="stable")[:kcap]
        pos = idx[:, None] + np.arange(nlat)
        pc = np.minimum(pos, N - 1)
        ok = ((sd[pc] == sd[idx][:, None]) & (pos < N) & (val[idx] > NEG / 2)[:, None]
              & (sv[pc] > thr))
        assert np.array_equal(ref[4][:k], np.where(ok, sa[pc], -1)), name
        assert np.array_equal(ref[3][:k], np.where(ok, sv[pc], F32NEG)), name
