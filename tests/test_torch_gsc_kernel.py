"""The GSC kernel's schedule (`dsr_tpu_torch/ops/cuda/csrc/gsc.cu`)
transcribed to NumPy on the CPU: the front kernel's records (yc, z and the
gain g = mu / (|z|^2 + eps) of every frame and bin, laid out by bin groups),
then the chain alone over them in the kernel's order (the norm cap's scale
folded into the next update, the next frame's wa^H z beside the cap; two
partial sums by entry parity, and above 16 channels G lanes a bin, each
summing its entries m = s, s + G, ..., the lanes' partials added by
butterfly).  Beyond 513 channels the kernel keeps the plain order (a warp a
bin, the weights scaled each frame), which the same tolerance covers.  Held to
the plain twin `gsc_nlms_plain` and to the JAX package's frame scan
`_gsc_scan`, with the active weights threaded through wa0.

Tolerance: 1e-5 relative to the largest magnitude (Y and wa): the three
differ only in the order of float32 sums, over at most 37 frames here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gsc_case, rel
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu_torch.ops.cuda import gsc as cgsc

MU, EPS, CAP = 0.1, 1e-6, 10.0


def _layout(N, K):
    """layout_for: G lanes a bin (1 up to 4 channels, 2 from 5 to 16, else
    the power of two that leaves each lane at most 8 of the N - 1 entries,
    up to 32), KB = 32 / G bins a group, E entries a lane (8 or 16 from 17
    to 513 channels; above, the many-channel kernels'
    ceil((N - 1) / 32)), RS record entries a (frame, bin) (N + 1, rounded
    so a frame's records are a multiple of 16 bytes)."""
    NM = N - 1
    G = 1 if N > 16 or NM < 4 else 2
    if N > 16:
        while G < 32 and G * 8 < NM:
            G *= 2
    E = -(-NM // G)
    if 16 < N <= 513:
        E = 8 if E <= 8 else 16
    KB = 32 // G
    RS = N + 1 + (N + 1) * KB % 2
    return G, KB, E, RS, -(-K // KB)


def _front(X, wq, B):
    """gsc_front_kernel's records (U, groups, T, RS, KB): entry 0 yc = wq^H x,
    1 + m z_m = (B^H x)_m, n ascending; entry N (g, 0), |z|^2 summed over m
    ascending; the pad entry zero.  The pad bins (k >= K) hold zeros here
    (the kernel's hold z = 0 and g = mu / eps; no chain reads them)."""
    U, N, T, K = X.shape
    G, KB, E, RS, groups = _layout(N, K)
    W = np.concatenate([wq[..., None], B], axis=-1)           # (U, K, N, N): [wq, B]
    O = np.zeros((U, T, K, N), np.complex64)
    for n in range(N):
        O += np.conj(W[:, None, :, n, :]) * X[:, n, :, :, None]
    zn = np.zeros((U, T, K), np.float32)
    for m in range(N - 1):
        zn += O[..., 1 + m].real ** 2 + O[..., 1 + m].imag ** 2
    rec = np.zeros((U, T, groups * KB, RS), np.complex64)
    rec[:, :, :K, :N] = O
    rec[:, :, :K, N] = np.float32(MU) / (zn + np.float32(EPS))
    return rec.reshape(U, T, groups, KB, RS).transpose(0, 2, 1, 4, 3), (G, KB, E)


def _group_sum(v, G):
    """group_sum over the lane axis (size G): the butterfly v += v[s ^ o]."""
    o = 1
    while o < G:
        v = v + v[..., np.arange(G) ^ o]
        o *= 2
    return v


def _chain(rec, lay, N, K, wa0):
    """gsc_chain_kernel over the records: lane s of bin k owns entries m = s
    + G i, i < E, of u, where wa = sc u and sc is the norm cap's pending
    scale, applied in the next update: y = yc - sc u^H z; u <- sc u + g z
    conj(y); sc = min(1, cap / max(|u|, 1e-30)) with IEEE sqrt and division
    in float32; u^H z (the next frame's, computed beside the cap) and |u|^2
    in two partial sums by i's parity, then over the group by butterfly."""
    G, KB, E = lay
    U, groups, T = rec.shape[:3]
    f32 = np.float32
    r = rec.transpose(0, 2, 3, 1, 4).reshape(U, T, rec.shape[3], groups * KB)[..., :K]
    m = np.arange(G)[:, None] + G * np.arange(E)[None, :]          # (G, E)
    own = m < N - 1
    idx = np.where(own, 1 + m, 0)
    u = np.zeros((U, K, G, E), np.complex64)
    u[:, :, own] = wa0[:, :, m[own]]

    def z_of(t):
        return np.where(own, r[:, t, idx].transpose(0, 3, 1, 2), 0).astype(np.complex64)

    def dot(z):   # u^H z = sum conj(u) z
        p = [np.zeros((U, K, G), np.complex64) for _ in range(2)]
        for i in range(E):
            p[i % 2] = p[i % 2] + np.conj(u[..., i]) * z[..., i]
        return _group_sum(p[0] + p[1], G)[..., 0]

    Y = np.empty((U, T, K), np.complex64)
    sc = np.ones((U, K), f32)
    z = z_of(0)
    d = dot(z)
    for t in range(T):
        yc, g = r[:, t, 0], r[:, t, N].real
        Y[:, t] = y = (yc - sc * d).astype(np.complex64)
        s = [np.zeros((U, K, G), f32) for _ in range(2)]
        for i in range(E):
            u[..., i] = sc[..., None] * u[..., i] + z[..., i] * (np.conj(y) * g)[..., None]
            s[i % 2] = s[i % 2] + (u[..., i].real ** 2 + u[..., i].imag ** 2)
        if t + 1 < T:
            z = z_of(t + 1)
            d = dot(z)
        nrm = np.sqrt(_group_sum(s[0] + s[1], G)[..., 0])
        sc = np.minimum(f32(1), f32(CAP) / np.maximum(nrm, f32(1e-30))).astype(f32)
    wa_out = np.zeros((U, K, N - 1), np.complex64)
    wa_out[:, :, m[own]] = (sc[..., None, None] * u)[:, :, own]
    return Y, wa_out


def _kernel_in_numpy(X, wq, B, wa0):
    U, N, T, K = X.shape
    rec, lay = _front(X, wq, B)
    return _chain(rec, lay, N, K, wa0)


@pytest.mark.parametrize("N,Ts,U", [(2, (1, 37), 3), (8, (2, 37), 1), (17, (1, 2), 3),
                                    (64, (2, 37), 1), (520, (1, 2), 1)])
def test_gsc_schedule_in_numpy_matches_plain_and_jax(N, Ts, U):
    """Per channel count, two chunks of Ts[0] and Ts[1] frames, the second
    seeded through wa0 with the first's final weights: the transcription
    against the plain twin (the same chunks) and, utterance by utterance,
    against the JAX scan."""
    G, KB, E, RS, _ = _layout(N, 9)
    assert (RS * KB) % 2 == 0 and E * G >= N - 1 and (G == 1) == (N <= 4)
    cases = [gsc_case(seed=10 * N + u, N=N, T=sum(Ts), M=16) for u in range(U)]
    X, wq, B = (np.stack(a) for a in zip(*cases))             # (U, N, T, K), (U, K, N), ...
    wa = np.zeros((U, 9, N - 1), np.complex64)
    tp = (lambda a: torch.as_tensor(a))                       # noqa: E731
    wa_p = None
    t0 = 0
    for T in Ts:
        Xc = np.ascontiguousarray(X[:, :, t0:t0 + T])
        Y, wa = _kernel_in_numpy(Xc, wq, B, wa)
        Y_p, wa_p = cgsc.gsc_nlms_plain(tp(Xc), tp(wq), tp(B), MU, EPS, CAP, wa_p)
        assert rel(Y, Y_p.numpy()) < 1e-5 and rel(wa, wa_p.numpy()) < 1e-5, (N, T)
        for u in range(U):
            Y_j, wa_j = jbf._gsc_scan(jnp.transpose(Xc[u], (1, 2, 0)), wq[u], B[u],
                                      jnp.float32(MU), jnp.float32(EPS), jnp.float32(CAP),
                                      None if t0 == 0 else jnp.asarray(wa_prev[u]))
            assert rel(Y[u], np.asarray(Y_j)) < 1e-5 and rel(wa[u], np.asarray(wa_j)) < 1e-5
        wa_prev = wa
        t0 += T


def test_gsc_layout_covers_every_channel_count():
    """Every channel count gets a layout whose lanes own every entry of wa,
    at most E each (E an instantiated count: N - 1 up to 4 channels, half of
    it rounded up to 16, 8 or 16 up to 513; beyond, the many-channel kernels
    loop over any count, a warp a bin), whose frame records are a multiple
    of 16 bytes (the TMA bulk copies' unit), and whose warps cover whole
    bins."""
    for N in list(range(2, 530)) + [1000, 4097]:
        G, KB, E, RS, groups = _layout(N, 129)
        assert G * KB == 32 and G & (G - 1) == 0 and G * E >= N - 1
        if N <= 16:
            assert (G, E) == ((1, N - 1) if N <= 4 else (2, N // 2))
        elif N <= 513:
            assert E == 8 or (E == 16 and G == 32 and N - 1 > 256)
        else:
            assert G == 32 and E == -(-(N - 1) // 32)
        assert (8 * RS * KB) % 16 == 0 and RS in (N + 1, N + 2)
        assert groups * KB >= 129 > (groups - 1) * KB
