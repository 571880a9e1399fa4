"""The filterbank kernel wrappers on the CPU:
the fused analysis+beamform's plain twin against the Pallas fused kernel
(interpret mode), the analysis kernel's FFT plan (`ops/cuda/csrc/
analysis.cu`) transcribed to NumPy against the plain twin and the JAX
package's analysis, the fused kernel's tiling (tiles of F frames, the
channels split over a cluster's Q ranks, their partial tiles summed in rank
order, the radix-8 plan and the split by items) transcribed to NumPy
against the plain twin, CPU tensors running the plain twins without
counting a launch, and other devices refused.  Tolerance: 1e-5 of the
largest magnitude, as in tests/test_torch_filterbank.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import SR, fft_radices, fft_twiddles, filterbank_case, geometry, rel, stockham
from dsr_tpu.config import FilterbankConfig as JFilterbankConfig
from dsr_tpu.ops import beamforming as jbf
from dsr_tpu.ops import filterbank as jfb
from dsr_tpu.ops.pallas import filterbank as pfb
from dsr_tpu_torch import convert
from dsr_tpu_torch.config import FilterbankConfig
from dsr_tpu_torch.ops import filterbank as tfb
from dsr_tpu_torch.ops.cuda import filterbank as cfb


def test_fused_analysis_beamform_matches_pallas():
    """The fused analysis+beamform (plain twin of the CUDA kernel) against
    the Pallas fused kernel, MVDR weights carried across by convert."""
    N = 6
    cfg, jcfg, _, _, _ = filterbank_case(256)
    POS, taus = geometry(N, 0.10)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w = jbf.mvdr_weights(jbf.steering_vectors(taus, cfg.M, SR), Gamma)
    x = np.random.default_rng(7).standard_normal((N, 40960)).astype(np.float32)
    Y_ref = np.asarray(pfb.analysis_beamform(x, w, jcfg))
    Y = tfb.analysis_beamform(torch.as_tensor(x), convert.beamformer_weights(w), cfg)
    assert Y.shape == (tfb.num_frames(40960, cfg), cfg.num_bins)
    assert rel(Y.numpy(), Y_ref) < 1e-5


# ------------------------------------------ analysis.cu's FFT plan, in NumPy


def _analysis_fft_in_numpy(x, hf, M, m, D, T, max_radix=4, split=True):
    """analysis_fft_kernel: fold, pack two reals a point (even M), the
    mixed-radix Stockham stages (stage of radix R, Ns the product of the
    earlier radices: element j + r n/R, twiddled by W_n^{(j mod Ns) r
    n/(Ns R)}, goes through a length-R DFT to (j div Ns) Ns R + (j mod Ns)
    + k Ns), then the even-M split into M/2 + 1 bins (split=False: the
    transform Z before it)."""
    C, S = x.shape
    P = m * M - D
    g = (np.arange(T)[:, None] * D - P + np.arange(m * M)[None, :])
    frames = np.where((g >= 0) & (g < S), x[:, np.clip(g, 0, S - 1)], 0.0)
    u = (frames * hf).reshape(C, T, m, M).sum(2).astype(np.float32)
    n = M // 2 if M % 2 == 0 else M
    s = M // n
    tw = fft_twiddles(M)
    z = (u[..., 0::2] + 1j * u[..., 1::2] if s == 2 else u).astype(np.complex64)
    z = stockham(z, M, max_radix)
    if not split:
        return z
    if s == 1:
        return z[..., :M // 2 + 1]
    k = np.arange(1, n)
    zk, zc = z[..., k], np.conj(z[..., n - k])
    A = np.empty((C, T, n + 1), np.complex64)
    A[..., 0] = z[..., 0].real + z[..., 0].imag
    A[..., n] = z[..., 0].real - z[..., 0].imag
    A[..., k] = (zk + zc) / 2 + tw[k] * (-1j * (zk - zc) / 2)
    return A


def test_fft_plan_in_numpy_matches_plain_and_jax():
    """The analysis kernel's FFT plan, transcribed to NumPy: against the
    plain twin at M = 96, 256, 512, 768, 1024, 2048 (radix-4, -2 and -3
    stages) and the prime M = 127 (one direct stage) with random
    prototypes, and against the JAX package's analysis at the five shipped
    configs."""
    rng = np.random.default_rng(21)
    assert fft_radices(384) == [4, 4, 4, 2, 3] and fft_radices(127) == [127]
    for M, r in ((96, 2), (256, 2), (512, 4), (768, 1), (1024, 2), (2048, 2), (127, 1)):
        m, D = 2, M // r
        hf = rng.standard_normal(m * M).astype(np.float32) / 16
        x = rng.standard_normal((2, 3000)).astype(np.float32)
        T = tfb.num_frames(3000, FilterbankConfig(M=M, m=m, r=r))
        ref = cfb.analysis_plain(torch.as_tensor(x), torch.as_tensor(hf), M, r, T).numpy()
        assert rel(_analysis_fft_in_numpy(x, hf, M, m, D, T), ref) < 1e-5, M
    for M, m, r, j in ((64, 2, 2, 2), (64, 4, 1, 6), (64, 4, 2, 2), (96, 2, 2, 2), (256, 4, 2, 2)):
        jcfg = JFilterbankConfig(M=M, m=m, r=r, joint_iters=j)
        hf = np.asarray(jfb.get_prototypes(jcfg)[0], np.float32)
        x = rng.standard_normal((3, 4000)).astype(np.float32)
        ref = np.asarray(jfb.analysis(x, jcfg))
        got = _analysis_fft_in_numpy(x, hf, M, m, M // r, ref.shape[1])
        assert rel(got, ref) < 1e-5, (M, m, r)


# ------------------------------------ analysis.cu's fused tiles, in NumPy


def _fused_tiling(C, T, M, sms):
    """plan_beamform's tile layout for a card of `sms` SMs: F frames a tile
    (F n <= 1024), Q ranks a tile (a power of two up to 8 and C), both while
    the grid has fewer than 4 blocks an SM; tiles hold their sums in
    registers when F items a frame fit 3 a thread of 256."""
    n = M // 2 if M % 2 == 0 else M
    tiles = lambda f: -(-T // f)   # noqa: E731
    F, Q = min(max(1, 1024 // n), T), 1
    while 2 * Q <= 8 and 2 * Q <= C and tiles(F) * Q < 4 * sms:
        Q *= 2
    while F > 1 and tiles(F) * Q < 4 * sms:
        F = (F + 1) // 2
    items = M // 4 + 1 if M % 2 == 0 else (M + 1) // 2
    assert F * items <= 3 * 256
    return F, Q


def _split_items(Z, M):
    """split_item over a frame's transform Z (n points): for even M, item k
    <= n/2 gives A[k] = e + u and A[n-k] = conj(e - u) with e = (Z[k] +
    conj Z[n-k]) / 2, u = W^k (-i) (Z[k] - conj Z[n-k]) / 2, item 0 the real
    bins 0 and n; for odd M, A[k] = Z[k]."""
    if M % 2:
        return Z[..., :(M + 1) // 2]
    n = M // 2
    A = np.empty(Z.shape[:-1] + (n + 1,), np.complex64)
    A[..., 0] = Z[..., 0].real + Z[..., 0].imag
    A[..., n] = Z[..., 0].real - Z[..., 0].imag
    k = np.arange(1, n // 2 + 1)
    zk, zn = Z[..., k], np.conj(Z[..., n - k])
    e = (zk + zn) / 2
    u = fft_twiddles(M)[k] * (-1j * (zk - zn) / 2)
    A[..., k] = e + u
    A[..., n - k] = np.conj(e - u)
    return A


def _fused_in_numpy(x, hf, w, M, m, r, T, sms):
    """analysis_beamform_kernel's tiles: each tile of F frames is Q blocks;
    rank q sums conj(w[k, c]) A_c over its channels [q C / Q, (q + 1) C / Q)
    in order, and the tile is the ranks' partials summed in rank order."""
    C = x.shape[0]
    F, Q = _fused_tiling(C, T, M, sms)
    A = _split_items(_analysis_fft_in_numpy(x, hf, M, m, M // r, T, max_radix=8, split=False), M)
    wc = np.conj(w).astype(np.complex64)
    y = np.empty((T, M // 2 + 1), np.complex64)
    for t0 in range(0, T, F):
        part = []
        for q in range(Q):
            acc = np.zeros((min(F, T - t0), M // 2 + 1), np.complex64)
            for c in range(q * C // Q, (q + 1) * C // Q):
                acc += wc[:, c] * A[c, t0:t0 + F]
            part.append(acc)
        tile = part[0]
        for p_ in part[1:]:
            tile = tile + p_
        y[t0:t0 + F] = tile
    return y, F, Q


@pytest.mark.parametrize("M,r", [(96, 2), (127, 1), (256, 2), (512, 4), (2048, 2)])
def test_fused_tiles_in_numpy_match_plain(M, r):
    """7 channels (not a multiple of the cluster's split) on a card of 8 SMs
    (so the plan splits them over Q = 2 or 4 ranks and, below M = 2048,
    keeps tiles of several frames), frames not a multiple of F, random
    prototype and weights."""
    rng = np.random.default_rng(M + r)
    m, C = 2, 7
    cfg = FilterbankConfig(M=M, m=m, r=r)
    S = 3000 if M < 1024 else 12000
    T = tfb.num_frames(S, cfg)
    hf = rng.standard_normal(m * M).astype(np.float32) / 16
    x = rng.standard_normal((C, S)).astype(np.float32)
    w = (rng.standard_normal((cfg.num_bins, C)) + 1j * rng.standard_normal((cfg.num_bins, C)))
    w = w.astype(np.complex64)
    y, F, Q = _fused_in_numpy(x, hf, w, M, m, r, T, sms=8)
    assert Q > 1 and C % Q and (M == 2048 or (F > 1 and T % F))
    ref = cfb.analysis_beamform_plain(torch.as_tensor(x), torch.as_tensor(hf), torch.as_tensor(w),
                                      M, r, T).numpy()
    assert rel(y, ref) < 1e-5, (M, F, Q)


def test_cpu_tensors_run_plain_and_leave_launch_counters_at_zero():
    cfg = FilterbankConfig(M=64, m=4, r=2)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 2000)).astype(np.float32))
    w = torch.ones((cfg.num_bins, 3), dtype=torch.complex64) / 3
    cfb.reset_launches()
    A = tfb.analysis(x, cfg)
    tfb.synthesis(A, cfg, 2000)
    Y = tfb.analysis_beamform(x, w, cfg)
    assert cfb.launches == {"analysis": 0, "analysis_beamform": 0,
                            "analysis_beamform_staged": 0, "synthesis": 0}
    assert torch.allclose(Y, A.mean(0), atol=1e-6)


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((2, 1000), device="meta")
    hf = torch.zeros(256, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cfb.analysis(x, hf, 64, 4, 2, 20)
