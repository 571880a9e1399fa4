"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
relative error they gate on and the filterbank and array cases they feed to
both `dsr_tpu` and `dsr_tpu_torch`.  Inputs are made with numpy from a seed.

The parity tests are split into files of at most five tests each so that,
under `pytest -n N --dist loadfile` (which hands out files with more tests
first), they are scheduled after the JAX package's larger files and leave
those files' timing as it was.
"""

import numpy as np
import torch

from dsr_tpu.config import ArrayGeometry as JGeometry
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig
from golden import room as groom

torch.set_num_threads(2)

SR = 16000.0
M = 256


def rel(a, ref) -> float:
    """max |a - ref| relative to the largest magnitude of `ref`."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


def filterbank_case(M):
    """(port cfg, JAX cfg, hf, gf, delay): the shipped M=256 prototypes (D=128,
    the TPU's v5 kernels) or random ones at M=512 (D=256, its general kernels)."""
    cfg, jcfg = FilterbankConfig(M=M, m=4, r=2), JFilterbankConfig(M=M, m=4, r=2)
    if M == 256:
        hf, gf, delay = jfb.get_prototypes(jcfg)
    else:
        rng = np.random.default_rng(5)
        hf = rng.standard_normal(cfg.L).astype(np.float32) / 16
        gf = rng.standard_normal(cfg.L).astype(np.float32) / 16
        delay = 0
    return cfg, jcfg, hf, gf, delay


def geometry(n=8, radius=0.10):
    """Circular array positions (equal in both packages) and the steering
    delays, in seconds, towards a source 2 m in front of it."""
    POS = np.asarray(ArrayGeometry.circular(n, radius).positions)
    assert np.array_equal(POS, np.asarray(JGeometry.circular(n, radius).positions))
    taus = (groom.steering_delays(POS, np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR)
    return POS, taus.astype(np.float32)


def subbands(rng, N=8, T=40, K=M // 2 + 1):
    return (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))).astype(
        np.complex64
    )


# ---------------------------------------------------------------- the decode

NEG = -1e30


def ref_select(cand, fdst, arcs, beam, kcap):
    """Copy of tests/test_pallas_select.py's NumPy transcription of the JAX
    decoders' sort path: lexicographic sort-recombine, beam, exact top-k.
    Returns (scores, dst, arc) of the kept tokens, dead slots NEG."""
    order = np.lexsort((arcs, -cand, fdst))
    sd, sv, sa = fdst[order], cand[order], arcs[order]
    first = np.r_[True, sd[1:] != sd[:-1]]
    val = np.where(first, sv, NEG)
    mx = val.max()
    val = np.where(val > mx - beam, val, NEG)
    top = np.argsort(-val, kind="stable")[:kcap]
    return val[top], sd[top], sa[top]


def select_case(seed, U, N, ndst, grid=4.0, pad=0.2):
    """Candidates as the decoders make them: duplicate destinations, exact
    score ties (scores on a 1/grid grid), NEG + NEG from padded arc slots."""
    rng = np.random.default_rng(seed)
    c = (np.round(rng.standard_normal((U, N)) * 10 * grid) / grid).astype(np.float32)
    c[rng.random((U, N)) < pad] = np.float32(NEG) + np.float32(NEG)
    d = rng.integers(0, ndst, (U, N)).astype(np.int32)
    a = rng.permutation(U * N).reshape(U, N).astype(np.int32)
    return c, d, a


def lvcsr_v300():
    """The JAX package's V=300 trigram task (68,551 states; cached by its
    build_task) and the same graph carried across to the port."""
    from dsr_tpu.asr import lvcsr
    from dsr_tpu_torch import convert

    task = lvcsr.build_task(lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3))
    return task, convert.packed_graph(task.graph)


def logliks(rng, shape, rounded: bool):
    """Random log-likelihoods; `rounded` puts them on a 2^-6 grid with
    |ll| < 2^9, where the JAX decoder's hi/lo-bf16 acoustic lookup
    (`_split_mm`, 16 mantissa bits) is exact."""
    ll = (rng.standard_normal(shape) * 3).astype(np.float32)
    if rounded:
        ll = (np.round(ll * 64) / 64).astype(np.float32)
    return ll


def words(olabels) -> list[int]:
    return [int(w) for w in np.asarray(olabels) if w]


# ---------------------------------------------------------------- the GSC


def gsc_case(seed=2, N=4, T=40, M=64):
    """(X (N, T, K), wq (K, N), B (K, N, N-1)) complex64 for a linear 4 cm
    array steered at a source 1 m in front of it: the inputs of
    tests/test_pallas.py's GSC gate, made by the JAX package."""
    POS = np.asarray(JGeometry.linear(N, 0.04).positions)
    taus = (groom.steering_delays(POS, np.array([0.0, 1.0, 0.0]), 343.0, SR) / SR)
    v = np.array(jbf.steering_vectors(taus.astype(np.float32), M, SR))
    B = np.array(jbf.blocking_matrix(v))
    X = subbands(np.random.default_rng(seed), N, T, M // 2 + 1)
    return X, (v / N).astype(np.complex64), B


def target_and_interferer(seed, N=4, T=120, M=64):
    """(X, wq, B, v_s, v_i): a super-Gaussian target (Laplacian magnitudes)
    from 2 m in front of a linear 4 cm array, a Gaussian interferer from the
    side and -40 dB of sensor noise, as tests/test_beamforming.py builds
    them; wq and B steer at the target."""
    rng = np.random.default_rng(seed)
    POS = np.asarray(JGeometry.linear(N, 0.04).positions)
    K = M // 2 + 1
    v_s, v_i = (np.array(jbf.steering_vectors(
        (groom.steering_delays(POS, np.array(p), 343.0, SR) / SR).astype(np.float32), M, SR))
        for p in ([0.0, 2.0, 0.0], [2.0, 1.0, 0.0]))
    s = rng.laplace(size=(T, K)) * np.exp(2j * np.pi * rng.random((T, K)))
    n = (rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))) * 2.0
    X = v_s.T[:, None, :] * s[None] + v_i.T[:, None, :] * n[None]
    X = X + 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    B = np.array(jbf.blocking_matrix(v_s))
    return X.astype(np.complex64), (v_s / N).astype(np.complex64), B, v_s, v_i


def phone_system(source):
    """A small phone-task HCLG and a seeded 2-component diagonal GMM, both
    built by the JAX package, and a corpus utterance recorded by a 4-mic
    linear 5 cm array from `source` (25 dB SNR), whole and cut into five
    ragged chunks: (graph, params, xm (4, S), chunks)."""
    import jax.numpy as jnp

    from dsr_tpu.asr import phone_task
    from dsr_tpu.asr.am import gmm as jgmm
    from dsr_tpu.asr.fsm import hclg as jhclg
    from dsr_tpu.asr.fsm import lm as jlm
    from dsr_tpu.asr.fsm.packed import pack as jpack
    from golden import corpus as gcorpus

    task = phone_task.PhoneTask(gcorpus.VOCAB[:6], states_per_phone=2)
    transcripts = [[w if w in task.vocab else task.vocab[0] for w in ws]
                   for ws, _ in gcorpus.make_corpus(12, seed=0)]
    G = jlm.arpa_to_fst(jlm.train_arpa_bigram(transcripts, task.vocab), task.words)
    L, ndis = jhclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    P = len(task.phones) - 1
    H = jhclg.build_hmm_fst(P, ndis, states_per_phone=task.spp)
    graph = jpack(jhclg.compose_hclg(H, L, G, P, ndis))
    rng = np.random.default_rng(3)
    n_pdf = P * task.spp
    params = jgmm.GmmParams(
        jnp.asarray(rng.standard_normal((n_pdf, 2, 13)).astype(np.float32) * 3),
        jnp.asarray((0.5 + rng.random((n_pdf, 2, 13))).astype(np.float32) * 5),
        jnp.asarray(np.log(np.full((n_pdf, 2), 0.5, np.float32))))
    geom = JGeometry.linear(4, 0.05)
    _, x = gcorpus.make_corpus(1, min_words=2, max_words=3, seed=77)[0]
    xm = groom.simulate(np.asarray(x, np.float32), np.asarray(geom.positions), source, SR,
                        snr_db=25.0, rng=np.random.default_rng(7)).astype(np.float32)
    cuts = [0, 1500, 5000, 5600, 12000, xm.shape[-1]]
    chunks = [xm[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    return graph, params, xm, chunks


# ---------------------------------------------------------------- config 1


def config1_corpus(n=8, seed=0, vocab=None):
    """A small training corpus from the port's corpus copy (equal to
    golden.corpus's, tests/test_torch_corpus.py), its time-domain MFCC + CMN
    features made by the port as float32 numpy arrays, and the transcripts;
    `vocab` maps out-of-vocabulary words to its first word, as
    tests/test_asr_smallvocab.py does for its BW gate."""
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.utils import corpus

    utts = corpus.make_corpus(n, seed=seed)
    feats = [ft.cmn(ft.mfcc(torch.as_tensor(x.astype(np.float32)), SR)).numpy()
             for _, x in utts]
    words = [[w if vocab is None or w in vocab else vocab[0] for w in ws] for ws, _ in utts]
    return feats, words


def smallvocab_pair(vocab=None):
    """The JAX and the port's `SmallVocabTask` over the same vocabulary."""
    from dsr_tpu.asr import smallvocab as jsv
    from dsr_tpu_torch.asr import smallvocab as sv
    from dsr_tpu_torch.utils import corpus

    vocab = corpus.VOCAB if vocab is None else vocab
    return jsv.SmallVocabTask(list(vocab)), sv.SmallVocabTask(list(vocab))


def phone_pair(vocab=None, spp=2):
    """The JAX and the port's `PhoneTask` over the same vocabulary."""
    from dsr_tpu.asr import phone_task as jpt
    from dsr_tpu_torch.asr import phone_task as pt
    from dsr_tpu_torch.utils import corpus

    vocab = corpus.VOCAB if vocab is None else vocab
    return jpt.PhoneTask(list(vocab), states_per_phone=spp), pt.PhoneTask(list(vocab),
                                                                          states_per_phone=spp)


def gmm_pair(rng, S, C=2, D=13):
    """A seeded diagonal GMM as the JAX package's GmmParams and the port's."""
    import jax.numpy as jnp

    from dsr_tpu.asr.am import gmm as jgmm
    from dsr_tpu_torch.asr.am import gmm

    means = rng.standard_normal((S, C, D)).astype(np.float32)
    variances = (0.5 + rng.random((S, C, D))).astype(np.float32)
    logw = np.log(rng.dirichlet(np.ones(C), size=S)).astype(np.float32)
    return (jgmm.GmmParams(jnp.asarray(means), jnp.asarray(variances), jnp.asarray(logw)),
            gmm.GmmParams(means, variances, logw))


def adapt_system():
    """tests/test_adapt_mmi_lattice.py's adaptation task at a smaller size:
    the 6-word phone task, its first 9 all-in-vocabulary utterances of 40
    (the port's MFCC + CMN) and GMMs trained on them by the JAX package in
    3 iterations → (JAX task, port task, JAX params, port params, feats,
    words)."""
    from dsr_tpu.asr.train import trainer as jtrainer
    from dsr_tpu_torch import convert
    from dsr_tpu_torch.utils import corpus

    jtask, task = phone_pair(corpus.VOCAB[:6])
    feats, words = config1_corpus(40)
    keep = [i for i, ws in enumerate(words) if all(w in task.vocab for w in ws)][:12]
    feats, words = [feats[i] for i in keep], [words[i] for i in keep]
    jp = jtrainer.train(jtask, feats, words, num_comp=2, iters=3)
    return jtask, task, jp, convert.gmm_params(jp), feats, words


def adapt_gamma(jtask, task, jp, p, f, ws):
    """One-hot occupancies (T, S) of the port's forced alignment, checked
    equal to the JAX package's."""
    from dsr_tpu.asr import path as jpath
    from dsr_tpu_torch.asr import path

    al = path.force_align(task, p, f, ws)
    assert np.array_equal(al.states, np.asarray(jpath.force_align(jtask, jp, f, ws).states))
    return np.eye(task.num_states, dtype=np.float32)[al.states]


# ---------------------------------------------------------------- triphones


def tree_alignments(n_utts, seed, spp=2, D=13):
    """(frames, feats, phone seqs) per utterance: each phone's spp states
    held for 1-6 frames; features float32 around a per-phone mean."""
    from dsr_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    phones = sorted(corpus.PHONES) + ["sil"]
    means = {p: rng.standard_normal(D) * 2 for p in phones}
    frames_l, feats_l, seqs = [], [], []
    for _ in range(n_utts):
        words = [corpus.VOCAB[i] for i in rng.integers(0, len(corpus.VOCAB), rng.integers(1, 5))]
        seq = ["sil"]
        for w in words:
            seq.extend(corpus.WORDS[w])
            seq.append("sil")
        frames = [(pi, pos) for pi in range(len(seq)) for pos in range(spp)
                  for _ in range(int(rng.integers(1, 7)))]
        feats = np.stack([means[seq[pi]] + rng.standard_normal(D) for pi, _ in frames])
        frames_l.append(frames)
        feats_l.append(feats.astype(np.float32))
        seqs.append(seq)
    return frames_l, feats_l, seqs


# ----------------------------------- csrc/fft.cuh and the synthesis, in NumPy


def fft_radices(n, max_radix=4):
    """make_plan's stages: one radix 8 where 8 divides (max_radix 8, the
    fused kernel's and the synthesis's plans), radix 4 while 4 divides, then
    2, then 3s, then the other primes in increasing order."""
    out = []
    if max_radix >= 8 and n % 8 == 0:
        out, n = [8], n // 8
    while n % 4 == 0:
        out, n = out + [4], n // 4
    if n % 2 == 0:
        out, n = out + [2], n // 2
    q = 3
    while n > 1:
        while n % q == 0:
            out, n = out + [q], n // q
        q += 2
    return out


def fft_twiddles(M):
    """The kernels' table e^{-2 pi i j / M}, j < M, with sincospi's exact
    zeros (cos at M/4 and 3M/4, sin at 0 and M/2)."""
    j = np.arange(M)
    c, s = np.cos(2 * np.pi * j / M), np.sin(2 * np.pi * j / M)
    c[(4 * j == M) | (4 * j == 3 * M)] = 0.0
    s[(j == 0) | (2 * j == M)] = 0.0
    return (c - 1j * s).astype(np.complex64)


def stockham(z, M, max_radix=4):
    """run_stages over the last axis of z (n = M/2 points for even M, M for
    odd): the mixed-radix Stockham stages, stage of radix R with Ns the
    product of the earlier radices taking element j + r n/R, twiddled by
    W_n^{(j mod Ns) r n/(Ns R)}, through a length-R DFT to (j div Ns) Ns R
    + (j mod Ns) + k Ns; the forward DFT of z, in complex64."""
    n = z.shape[-1]
    s = M // n
    tw = fft_twiddles(M)
    Ns = 1
    for R in fft_radices(n, max_radix):
        nR = n // R
        j = np.arange(nR)
        jm = j % Ns
        v = [z[..., j + r * nR] * tw[s * jm * r * (n // (Ns * R))] for r in range(R)]
        out = np.empty_like(z)
        for k in range(R):
            out[..., (j // Ns) * Ns * R + jm + k * Ns] = sum(
                v[r] * tw[s * ((r * k) % R) * nR] for r in range(R))
        z, Ns = out, Ns * R
    return z


def synthesis_idft(A, M, t0, nf):
    """pack, the stages and unpack of csrc/filterbank.cu: frames t0 .. t0 +
    nf - 1 of A (C, T, K) (zeros outside [0, T)) → (C, nf, M) real samples,
    each frame's irfft.  Even M: Z[k] = ((A[k] + conj A[n-k]) + i e^{2 pi i
    k/M} (A[k] - conj A[n-k])) / M, k < n = M/2, the DC and Nyquist bins'
    imaginary parts dropped; odd M: the Hermitian extension / M, DC's
    imaginary part dropped.  The forward stages run on conj Z, and v[2j] =
    Re z[j], v[2j+1] = Im z[j] (odd M: v[p] = Re z[p]) with z = conj of
    their output."""
    C, T, K = A.shape
    t = t0 + np.arange(nf)
    live = (t >= 0) & (t < T)
    a = np.where(live[None, :, None], A[:, np.clip(t, 0, T - 1)], 0).astype(np.complex64)
    if M % 2 == 0:
        n = M // 2
        lo, hi = a[..., :n].copy(), a[..., n:0:-1].copy()   # A[k], A[n - k]
        lo[..., 0] = lo[..., 0].real
        hi[..., 0] = hi[..., 0].real
        w = np.conj(fft_twiddles(M)[:n])
        Z = (lo + np.conj(hi)) + 1j * w * (lo - np.conj(hi))
    else:
        Z = np.concatenate([a, np.conj(a[..., K - 1:0:-1])], axis=-1)   # A[M - k] = conj A[k]
        Z[..., 0] = Z[..., 0].real
    z = np.conj(stockham(np.conj(Z / M).astype(np.complex64), M, max_radix=8))
    if M % 2:
        return z.real.astype(np.float32)
    return np.stack([z.real, z.imag], axis=-1).reshape(C, nf, M).astype(np.float32)


def synthesis_plan(C, M, m, r, start, out_len, sms=132, budget=232448 - 1024):
    """synthesis_plan's route for a card of `sms` SMs and `budget` bytes of
    shared memory a block: ("tiles", F) with F output frames a block (about
    one block an SM, at most 4096 points a tile, halved until its two
    padded buffers and the twiddle table fit), or ("device", t_lo, nrows)."""
    D, mr = M // r, m * r
    n = M // 2 if M % 2 == 0 else M
    padded = lambda p: p + (p + 15) // 16   # noqa: E731
    tf0, tf1 = start // D, (start + out_len - 1) // D
    fo = tf1 - tf0 + 1
    F = max(1, min(-(-C * fo // sms), 4096 // n - mr + 1, fo))
    while True:
        if 16 * padded((F + mr - 1) * n) <= budget:   # with or without the table
            return "tiles", F
        if F == 1:
            t_lo = max(0, tf0 - mr + 1)
            return "device", t_lo, tf1 - t_lo + 1
        F = (F + 1) // 2


def synthesis_tiles(A, gf, M, m, r, start, out_len, F):
    """synthesis_kernel: tiles of F output frames from tf0 = start // D;
    each transforms its F + m r - 1 frames (the halo before it) and gathers
    sample (fb, d) as sum over jj < m r, ascending, of gf[d + jj D] v[fb + m
    r - 1 - jj][(jj D + d) mod M], in float32."""
    C = A.shape[0]
    D, mr = M // r, m * r
    tf0, tf1 = start // D, (start + out_len - 1) // D
    y = np.zeros((C, out_len), np.float32)
    for tfb in range(tf0, tf1 + 1, F):
        v = synthesis_idft(A, M, tfb - (mr - 1), F + mr - 1)
        fb, d = np.divmod(np.arange(F * D), D)
        j = (tfb + fb) * D + d - start
        ok = (j >= 0) & (j < out_len)
        acc = np.zeros((C, F * D), np.float32)
        for jj in range(mr):
            acc += gf[d + jj * D] * v[:, fb + mr - 1 - jj, (jj * D + d) % M]
        y[:, j[ok]] = acc[:, ok]
    return y


def synthesis_device_route(A, gf, M, m, r, start, out_len, t_lo, nrows):
    """synthesis_idft_kernel then synthesis_ola_kernel: every frame t_lo ..
    t_lo + nrows - 1 transformed into rows of device memory, then each
    output sample sums its m r terms in double (the kernel walks the rows in
    ascending order, here the terms; in double the order shows below
    float32's rounding)."""
    C, T, _ = A.shape
    D, mr = M // r, m * r
    v = synthesis_idft(A, M, t_lo, nrows).astype(np.float64)
    s = start + np.arange(out_len)
    tf, d = np.divmod(s, D)
    y = np.zeros((C, out_len))
    for jj in range(mr):
        t = tf - jj
        ok = (t >= 0) & (t < T)
        y[:, ok] += gf[d[ok] + jj * D] * v[:, t[ok] - t_lo, (jj % r) * D + d[ok]]
    return y.astype(np.float32)


# ---------------------------------------------------------------- parallel


def phone_hclg_system():
    """The phone task's bigram HCLG and eval log-likelihoods of
    tests/test_parallel.py's `system` fixture, built with the port: the
    6-word phone task, GMMs trained on 25 corpus utterances (3 iterations,
    on the CPU), the graph composed by the port's WFST core, and the
    log-likelihoods of the seed-55 eval utterances → (task, PackedGraph,
    [ll (T_i, P) float32 numpy])."""
    from dsr_tpu_torch.asr import phone_task
    from dsr_tpu_torch.asr.am import gmm
    from dsr_tpu_torch.asr.fsm import hclg, lm
    from dsr_tpu_torch.asr.fsm.packed import pack
    from dsr_tpu_torch.asr.train import trainer
    from dsr_tpu_torch.ops import features as ft
    from dsr_tpu_torch.utils import corpus

    def feats_of(x):
        return ft.cmn(ft.mfcc(torch.as_tensor(np.asarray(x, np.float32)), SR)).numpy()

    task = phone_task.PhoneTask(corpus.VOCAB[:6], states_per_phone=2)
    utts = [(ws, x) for ws, x in corpus.make_corpus(40, seed=0)
            if all(w in task.vocab for w in ws)][:25]
    transcripts = [ws for ws, _ in utts]
    params = trainer.train(task, [feats_of(x) for _, x in utts], transcripts, num_comp=2,
                           iters=3, device="cpu")
    G = lm.arpa_to_fst(lm.train_arpa_bigram(transcripts, task.vocab), task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    P = len(task.phones) - 1
    H = hclg.build_hmm_fst(P, ndis, states_per_phone=task.spp)
    graph = pack(hclg.compose_hclg(H, L, G, P, ndis))
    evals = [(ws, x) for ws, x in corpus.make_corpus(4, seed=55)
             if all(w in task.vocab for w in ws)] or [utts[0]]
    lls = [gmm.loglik(params, torch.as_tensor(feats_of(x))).numpy() for _, x in evals]
    return task, graph, lls


# ---------------------------------------------------------------- the models

def randomized(params, seed):
    """flax parameters with every relative-position table, LayerNorm scale
    and bias drawn at random (flax initialises them to 0 or 1, so each
    would otherwise check nothing); kernels are kept."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "rel_bias":
            return jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1.0 + 0.2 * rng.standard_normal(a.shape), jnp.float32)
        if name == "bias":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), jnp.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, params)


def grads_match(model, ref: dict, tol: float = 1e-3, floor: float = 1e-6) -> None:
    """Every parameter's `.grad` against `ref` (the JAX gradients in the
    port's layout): within `tol` of the reference leaf's largest magnitude,
    or `floor` absolute.  The floor covers the attention's k bias, whose
    true gradient is 0 (softmax over keys ignores it) and whose computed
    one is float32 rounding noise of ~1e-8 in either package."""
    params = dict(model.named_parameters())
    assert set(params) == set(ref)
    for name, p in params.items():
        r = np.asarray(ref[name])
        err = float(np.max(np.abs(p.grad.numpy() - r)))
        assert err <= max(tol * float(np.max(np.abs(r))), floor), (name, err)
