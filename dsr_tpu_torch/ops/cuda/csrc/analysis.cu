// Oversampled DFT filterbank analysis for Hopper (sm_90a) as a factorised
// real FFT, alone and fused with a fixed-weight beamform.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/filterbank.py;
// each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or kNoFit: never for a valid config).
//
// Replaces (dsr_tpu/ops/pallas/filterbank.py):
//   analysis           <- :188 _analysis_kernel_v5 and :83 _analysis_kernel
//                         (one kernel for every M, m and D)
//   analysis_beamform  <- :338 _analysis_bf_kernel, unstaged and over the
//                         staged buffer bank (stage_for_beamform /
//                         _analysis_bf_staged)
//
// The function (the conventions of dsr_tpu/ops/filterbank.py): M subbands,
// prototype length L = m*M, hop D, K = M/2+1 bins, front pad P = L-D.
// Frame t covers x[t*D - P, t*D - P + L) (zeros outside the signal):
//     u[t, p] = sum_{q<m} x[t*D - P + q*M + p] hf[q*M + p],   p < M,
//     A[t, k] = sum_{p<M} u[t, p] e^{-2 pi i p k / M},         k < K.
//
// The FFT (plan, stages, twiddle table, layouts' helpers) is in fft.cuh,
// shared with the synthesis (filterbank.cu), which runs it on the conjugate
// of each packed spectrum as an inverse transform.
//
// The transform: for even M the folded frame is packed as z[j] = u[2j] +
// i u[2j+1], an n = M/2 point complex FFT, and split into the K bins:
//     A[k] = (Z[k] + conj Z[n-k]) / 2 - i e^{-2 pi i k/M} (Z[k] - conj Z[n-k]) / 2,
// with A[0] = Re Z[0] + Im Z[0] and A[n] = Re Z[0] - Im Z[0] written as real
// (the exact zeros of rfft's DC and Nyquist).  For odd M, an n = M point
// complex FFT of u.  The FFT is a mixed-radix Stockham FFT (out of place,
// natural order in and out): radix-4 stages, one radix-2 stage for an odd
// power of two, radix-3 stages, and a direct length-q DFT stage for any
// other prime factor q, so a prime M is a direct DFT and every M is
// taken.  Stage s of radix R, with Ns the product of the earlier radices,
// maps element j + r n/R (j < n/R, r < R) through the twiddle
// W_n^{(j mod Ns) r n/(Ns R)} and a length-R DFT to
// (j div Ns) Ns R + (j mod Ns) + k Ns.  Twiddles come from a table of
// e^{-2 pi i j / M}, j < M, filled with sincospif (exact zeros at the
// quarter turns); without room for it they are computed in place by the
// same sincospif, so they are the same values.  Index arithmetic divides
// by multiply-shift (FastDiv): runtime integer divisions dominated the
// stages otherwise.
//
// What bounds it on this card: a real FFT of M points is about 2.5 M log2 M
// operations a frame against 4 L bytes of signal read (mostly from L1) and
// 8 K written, so bytes bound it (the main path's 8 ch x 4 s: 6.2 MB, 1.9 us
// at 3.35 TB/s).  What is left above that is a block's latency: the
// loads, the fold, one barrier a stage and the split, a few microseconds.
//
// Layout, by the FFT's size n (complex points a frame):
//   - n < 1024 (the main path's M = 256, D = 256's M = 512, M = 1024): a
//     block of 256 threads folds F frames (F n <= 1024 points; F smaller
//     when the call has few frames, so the grid gives about four blocks an
//     SM) into shared memory and runs the F FFTs together, ping-pong
//     between two buffers, one barrier a stage;
//   - larger n while two buffers fit shared memory: a block per frame, the
//     same code;
//   - up to n = 16,384 (M = 32,768): one buffer in shared memory, each
//     stage's outputs held in registers (32 values a thread of 512) until
//     every thread has read its inputs;
//   - beyond: a block per frame with its two buffers in the caller's
//     device scratch (a grid-stride loop over frames bounds the scratch).
// The ping-pong blocks copy the prototype and each tile's signal window
// into shared memory with cp.async (every load in flight at once) when
// they fit; otherwise, and in the other layouts, the fold reads them from
// device memory.
//
// The fused analysis + beamform, y[t, k] = sum_c conj(w[k, c]) A_c[t, k]
// (w (K, C), y (T, K)), runs the same fold, FFT and split per channel and
// sums the weighted bins; the per-channel spectra are never stored.  Its
// bound is bytes (the C S floats of signal, 32.8 MB at the main path's 64
// ch x 8 s: 0.0101 ms at 3.35 TB/s), but it does C T FFTs, and measured on
// the card it is bound by instruction issue (an SM issuing ~3.4
// instructions a cycle at 4 blocks an SM); its design cuts instructions a
// point:
//   - a tile of F frames (F n <= 1024, the analysis's layout) is the work
//     of a thread-block cluster of Q blocks (Q = 8 at the main path: 127
//     tiles would not fill 132 SMs), each rank summing its share of the
//     channels into registers; the ranks' partial tiles are summed through
//     distributed shared memory in rank order, a fixed order, so the result
//     is deterministic with no atomics and no second launch;
//   - for m = 4 (the main path's) the fold keeps the prototype's taps of its
//     four samples in registers and loads each window vector once for the m
//     frames that share it
//     (fold_slide; 1.8 KB of shared memory a frame at the main path, where
//     the analysis's fold reads 8 KB), the next channel's window arriving
//     by cp.async while this one is transformed;
//   - the plan's stages are radix 8 then 4s (make_plan(M, pl, 8)), in
//     buffers padded by one point every 16 (at<true>: the Stockham
//     scatter otherwise puts a stage's stores on one bank pair); at the
//     main path's M = 256 (n = 128) the stages are compiled with constant
//     radices and strides (stages_pow2: a channel's stages ~3,000 -> ~1,700
//     cycles, measured on the card; other sizes run the runtime plan);
//   - the split takes an item (bins k and n - k) at a time from Z[k],
//     Z[n - k] and one twiddle, and the weights come from a slice of w
//     transposed into shared memory.
// A block per frame for larger n (its sums in its own row of y), as the
// analysis's layouts.  The staged bank: the TPU kernel read a (B, C*rows,
// 128) bank of padded frames and took the buffer's index by scalar
// prefetch, so one compiled kernel served a whole serving loop with no
// host work per call.  Here the bank is the (B, C, S) signals as they are,
// and the kernel's staged instantiation reads the index from device memory
// itself (or takes it as an argument): a loop over the bank needs no host
// readback.  An index outside [0, B) read from device memory makes the
// kernel write NaN (it cannot raise).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fft.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kNoFit = -1;
constexpr int kItems = 3;           // a fused tile block's split items: <= kItems a thread
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kBlocksPerSm = 4;     // the fused tile grid's target

// cp.async of kBytes (4, 8 or 16) from global g to the shared-window
// address s (__cvta_generic_to_shared), of which the first `from` bytes
// come from g and the rest are zero; committed in groups, waited for by
// cp_wait<N> (all but the newest N groups complete).
template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned s, const void* g, int from = kBytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(g), "n"(kBytes),
               "r"(from)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// dst[i] = src[start + i] for i < W, zero outside [0, S); asynchronous
// (cp.async), committed as one group.
__device__ void stage_async(float* dst, const float* __restrict__ src, long long S,
                            long long start, int W) {
  const unsigned d = smem_addr(dst);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long long g = start + i;
    const bool in = g >= 0 && g < S;
    cp_async<4>(d + 4 * i, in ? src + g : src, in ? 4 : 0);
  }
  cp_commit();
}

// The fold of frames t0 .. t0 + nf - 1 of one channel into b0:
// u[f][p] = sum_{q<m} x[(t0 + f) D - P + q M + p] hf[q M + p], packed two
// reals a point for even M (pl.s == 2).  From the staged window `sig` (its
// sample 0 at (t0 D - P)) and prototype `hf_s` in shared memory when
// `stage`, four samples a thread where M and D allow float4; otherwise from
// device memory (the channel's signal xc, hf).
template <bool kPad>
__device__ __forceinline__ void fold(float2* b0, const float* sig, const float* hf_s,
                                     const float* __restrict__ xc, const float* __restrict__ hf,
                                     int S, int M, int m, int D, int t0, int nf, const Plan& pl,
                                     bool stage) {
  const int n = pl.n, P = m * M - D;
  const bool vec = M % 4 == 0 && D % 4 == 0;   // the staged window's rows are 16-byte aligned
  float* bf = reinterpret_cast<float*>(b0);
  if (stage && vec) {   // four samples a thread, float4 from shared memory
    for (int e = 4 * threadIdx.x; e < nf * M; e += 4 * blockDim.x) {
      const int f = pl.by_m.div(e), p = e - f * M;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < m; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(sig + f * D + q * M + p);
        const float4 hv = *reinterpret_cast<const float4*>(hf_s + q * M + p);
        acc.x = fmaf(xv.x, hv.x, acc.x);
        acc.y = fmaf(xv.y, hv.y, acc.y);
        acc.z = fmaf(xv.z, hv.z, acc.z);
        acc.w = fmaf(xv.w, hv.w, acc.w);
      }
      if (kPad) {   // points f n + p / 2 and the next (M is even)
        b0[at<true>(f * n + p / 2)] = make_float2(acc.x, acc.y);
        b0[at<true>(f * n + p / 2 + 1)] = make_float2(acc.z, acc.w);
      } else if (pl.s == 2) {
        *reinterpret_cast<float4*>(bf + 2 * f * n + p) = acc;
      } else {
        float2* z = b0 + f * n + p;
        z[0] = make_float2(acc.x, 0.f);
        z[1] = make_float2(acc.y, 0.f);
        z[2] = make_float2(acc.z, 0.f);
        z[3] = make_float2(acc.w, 0.f);
      }
    }
  }
  for (int e = threadIdx.x; e < (stage && vec ? 0 : nf * M); e += blockDim.x) {
    const int f = pl.by_m.div(e), p = e - f * M;
    float acc = 0.f;
    if (stage) {
      const float* sp = sig + f * D + p;
#pragma unroll 4
      for (int q = 0; q < m; ++q) acc = fmaf(sp[q * M], hf_s[q * M + p], acc);
    } else {
      const long long g0 = static_cast<long long>(t0 + f) * D - P + p;
      for (int q = 0; q < m; ++q) {
        const long long g = g0 + static_cast<long long>(q) * M;
        if (g >= 0 && g < S) acc = fmaf(__ldg(xc + g), __ldg(hf + q * M + p), acc);
      }
    }
    if (pl.s == 2)
      bf[2 * at<kPad>(f * n + p / 2) + (p & 1)] = acc;
    else
      b0[at<kPad>(f * n + p)] = make_float2(acc, 0.f);
  }
}

// Bin k of the frame at `base` of Z, its FFT of n points: the even-M
// split, or Z[k] for odd M.
template <bool kPad>
__device__ __forceinline__ float2 split_bin(const float2* Z, int base, int k, int n, int s,
                                            const Twiddle& tw) {
  if (s == 1) return Z[at<kPad>(base + k)];
  if (k == 0 || k == n) {
    const float2 z0 = Z[at<kPad>(base)];
    return make_float2(k == 0 ? z0.x + z0.y : z0.x - z0.y, 0.f);
  }
  const float2 zk = Z[at<kPad>(base + k)], zn = Z[at<kPad>(base + n - k)];
  const float2 zc = make_float2(zn.x, -zn.y);
  const float2 ev = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 od = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));  // -i (zk - zc) / 2
  return cadd(ev, cmul(tw(k), od));
}

// The fused kernel's split, an item at a time: for even M, item k <= n/2
// of a frame gives bins k and n - k (one bin when they coincide: k = n/2),
// from Z[k] and Z[n - k] and one twiddle, since with e = (Z[k] + conj
// Z[n-k]) / 2 and u = W^k (-i) (Z[k] - conj Z[n-k]) / 2, A[k] = e + u and
// A[n-k] = conj(e - u); item 0 gives bins 0 and n.  For odd M, item k is
// bin k.  (split_items, in fft.cuh, counts the items a frame.)
template <bool kPad>
__device__ __forceinline__ bool split_item(const float2* Z, int base, int k, int n, int s,
                                           const Twiddle& tw, float2* a, float2* b) {
  if (s == 1) {
    *a = Z[at<kPad>(base + k)];
    return false;
  }
  if (k == 0) {
    const float2 z0 = Z[at<kPad>(base)];
    *a = make_float2(z0.x + z0.y, 0.f);
    *b = make_float2(z0.x - z0.y, 0.f);
    return true;
  }
  const float2 zk = Z[at<kPad>(base + k)], zn = Z[at<kPad>(base + n - k)];
  const float2 e = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
  const float2 u = cmul(tw(k), make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x)));
  *a = cadd(e, u);
  *b = make_float2(e.x - u.x, u.y - e.y);
  return 2 * k != n;
}

// The fold of the fused tiles with the prototype in registers: thread
// (rho, g) of the first r M / 4 takes samples p = 4 g .. 4 g + 3 of frames
// rho, rho + r, rho + 2 r, ... (< nf).  Frame rho + r i reads the window's
// vectors x_k = sig[rho D + p + k M] for k = i .. i + kTaps - 1 (M = r D), so
// each vector is loaded once for the kTaps frames that use it; h[q] =
// hf[q M + p .. p + 3], the sums in fold()'s order.  M and D multiples of 4.
template <int kTaps>
__device__ __forceinline__ void fold_slide(float2* b0, const float* sig, const float4 (&h)[kTaps],
                                           int M, int D, int nf, int n) {
  const int groups = M / 4, r = M / D;
  if (static_cast<int>(threadIdx.x) >= r * groups) return;
  const int rho = threadIdx.x / groups, p = 4 * (threadIdx.x - rho * groups);
  const float* x = sig + rho * D + p;
  float4 win[kTaps];
#pragma unroll
  for (int q = 1; q < kTaps; ++q) win[q] = *reinterpret_cast<const float4*>(x + (q - 1) * M);
  for (int i = 0, f = rho; f < nf; ++i, f += r) {
#pragma unroll
    for (int q = 0; q + 1 < kTaps; ++q) win[q] = win[q + 1];
    win[kTaps - 1] = *reinterpret_cast<const float4*>(x + (i + kTaps - 1) * M);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kTaps; ++q) {
      acc.x = fmaf(win[q].x, h[q].x, acc.x);
      acc.y = fmaf(win[q].y, h[q].y, acc.y);
      acc.z = fmaf(win[q].z, h[q].z, acc.z);
      acc.w = fmaf(win[q].w, h[q].w, acc.w);
    }
    b0[at<true>(f * n + p / 2)] = make_float2(acc.x, acc.y);
    b0[at<true>(f * n + p / 2 + 1)] = make_float2(acc.z, acc.w);
  }
}

// grid-stride over tiles of F frames (tile = c * ntile + frame tile).
// Dynamic shared memory: the twiddle table (M entries) when `table`, the
// buffers when `gbuf` is null (else 2 F n points of device memory per block
// at gbuf), and when `stage` the prototype (L floats) and the tile's signal
// window ((F-1) D + L floats), copied in by cp.async.  out: (C, T, K)
// complex.
template <bool kHeldLayout>
__global__ void __launch_bounds__(kHeldLayout ? kThreadsH : kThreadsS)
analysis_fft_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                    float2* __restrict__ out, int C, int S, int T, int M, int m, int D, int F,
                    int table, int stage, Plan pl, float2* __restrict__ gbuf) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = pl.n, K = M / 2 + 1, L = m * M, P = L - D, ntile = (T + F - 1) / F;
  float2* b0 = gbuf ? gbuf + 2ll * F * n * blockIdx.x : smem + (table ? M : 0);
  float2* b1 = b0 + F * n;
  float* hf_s = reinterpret_cast<float*>(smem + (table ? M : 0) + 2 * F * n);
  float* sig = hf_s + L;
  const Twiddle tw{smem, M, table != 0};
  // the prototype and the first tile's window are in flight while the
  // twiddle table is filled
  const auto window = [&](int tile) {
    const int c = tile / ntile, t0 = (tile - c * ntile) * F, nf = min(F, T - t0);
    stage_async(sig, x + static_cast<long long>(c) * S, S, static_cast<long long>(t0) * D - P,
                (nf - 1) * D + L);
  };
  if (stage) {
    stage_async(hf_s, hf, L, 0, L);
    if (blockIdx.x < C * ntile) window(blockIdx.x);
  }
  if (table)
    for (int j = threadIdx.x; j < M; j += blockDim.x) smem[j] = twiddle(j, M);
  for (int tile = blockIdx.x; tile < C * ntile; tile += gridDim.x) {
    const int c = tile / ntile, t0 = (tile - c * ntile) * F, nf = min(F, T - t0);
    if (stage) {
      if (tile != blockIdx.x) window(tile);
      cp_wait<0>();
      __syncthreads();
    }
    fold<false>(b0, sig, hf_s, x + static_cast<long long>(c) * S, hf, S, M, m, D, t0, nf, pl,
                stage);
    __syncthreads();
    const float2* Z = run_stages<kHeldLayout, 4, false>(b0, b1, nf, pl, tw);
    // the K bins of each frame
    float2* o = out + (static_cast<long long>(c) * T + t0) * K;
    for (int e = threadIdx.x; e < nf * K; e += blockDim.x) {
      const int f = pl.by_k.div(e), k = e - f * K;
      o[static_cast<long long>(f) * K + k] = split_bin<false>(Z, f * n, k, n, pl.s, tw);
    }
    __syncthreads();   // the buffers are free for the next tile
  }
}

// ---- fused analysis + beamform ----------------------------------------------

// The staged bank's buffer: x (B, C, S) at index *idx (device memory) or
// idx_host; out of range, buffer 0 is read and *bad set.
struct Staged {
  const int* idx;
  int idx_host, nbuf;
  long long stride;
};

__device__ __forceinline__ const float* staged_buffer(const float* x, const Staged& st,
                                                      bool* bad) {
  const int b = st.idx ? __ldg(st.idx) : st.idx_host;
  *bad = b < 0 || b >= st.nbuf;
  return x + (*bad ? 0 : static_cast<long long>(b) * st.stride);
}

__device__ __forceinline__ float2 nan2() {
  return make_float2(__int_as_float(0x7fffffff), __int_as_float(0x7fffffff));
}

// acc + conj(w) a
__device__ __forceinline__ float2 cmac_conj(float2 w, float2 a, float2 acc) {
  return make_float2(fmaf(w.x, a.x, fmaf(w.y, a.y, acc.x)),
                     fmaf(w.x, a.y, fmaf(-w.y, a.x, acc.y)));
}

// w[k, c] from the block's slice (has: channels [c0, c0 + rows),
// transposed to (c, k) in shared memory at `slice`) or, without one, from
// device memory.
struct Weights {
  const float2* slice;
  const float2* w;
  int C, K, c0;
  bool has;
  __device__ __forceinline__ float2 operator()(int k, int c) const {
    if (has) return slice[(c - c0) * K + k];
    return __ldg(w + static_cast<long long>(k) * C + c);
  }
};

// y[t, k] = sum_c conj(w[k, c]) A_c[t, k]: each channel's frames folded,
// transformed (the plan's radix-8 and -4 stages, in buffers padded by
// at<true>) and split as in analysis_fft_kernel, then weighted and summed;
// the per-channel spectra are never stored.
//
// kTile (the layout-0 tiles): a tile of F frames is the work of Q blocks, a
// thread-block cluster of dims (Q, 1, 1), so blockIdx.x % Q is a block's
// rank q; rank q takes channels [q C / Q, (q + 1) C / Q) in order, its
// threads holding the sums of their split items (two bins each) in
// registers.  At the end each rank puts its partial tile in its own
// buffers, and the cluster's ranks each sum a share of the entries over
// the ranks' partials read through distributed shared memory in rank order
// (0, 1, ..., Q-1): a fixed order, so the result is deterministic.  The
// tiles always have the twiddle table (plan_beamform gives a tile plan no
// other).  kTaps (4: m = 4; 0: any m): the fold keeps the thread's taps in
// registers (fold_slide).
// Otherwise (a block per frame: F = 1, Q = 1; the grid strides over frames
// when the buffers are in device memory), the sums live in the block's own
// row of y, read and written by the same thread for every channel in order.
// Shared memory: the twiddle table (M entries) when `table`; the buffers
// when gbuf is null (else 2 padded(F n) points per block at gbuf); the
// weights' slice (wrows x K) when `wrows`; when `stage`, the prototype
// (unless kTaps) and two windows of (F-1) D + L floats, the next channel's
// copied in (cp.async) while this one is transformed.
// kStaged: x is the staged bank and `st` names the buffer; an index out of
// range writes NaN.
template <bool kHeldLayout, bool kTile, bool kStaged, int kTaps>
__global__ void __launch_bounds__(kHeldLayout ? kThreadsH : kThreadsS, kTile ? 4 : 1)
analysis_beamform_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                         const float2* __restrict__ w, float2* __restrict__ y, int C, int S,
                         int T, int M, int m, int D, int F, int Q, int table, int wrows,
                         int stage, Plan pl, float2* __restrict__ gbuf, Staged st) {
  extern __shared__ __align__(16) float2 smem[];
  bool bad = false;
  if constexpr (kStaged) x = staged_buffer(x, st, &bad);
  constexpr bool kPad = !kHeldLayout;   // the ping-pong buffers are padded
  const int n = pl.n, K = M / 2 + 1, KI = split_items(M), L = m * M, P = L - D;
  const int ntile = (T + F - 1) / F, W = (F - 1) * D + L;
  const int nb = kPad ? padded(F * n) : F * n;   // points a buffer
  // the tiles' buffers are in shared memory (their pointers shared-memory
  // addresses, so their accesses compile to shared-memory instructions)
  float2* b0 = !kTile && gbuf ? gbuf + 2ll * nb * blockIdx.x : smem + (table ? M : 0);
  float2* b1 = b0 + nb;
  float2* wsl = smem + (table ? M : 0) + 2 * nb;
  float* hf_s = reinterpret_cast<float*>(wsl + ((wrows * K + 1) & ~1));
  float* sig0 = hf_s + (kTaps ? 0 : L);
  float* sig[2] = {sig0, sig0 + W};
  const Twiddle tw{smem, M, kTile || table != 0};   // the tiles always have it
  const int q = kTile ? blockIdx.x % Q : 0;
  const int c0 = q * C / Q, c1 = (q + 1) * C / Q;
  const int first = kTile ? blockIdx.x / Q : blockIdx.x;
  const int stride = kTile ? ntile : gridDim.x;
  const Weights wt{wsl, w, C, K, c0, wrows > 0};
  const auto window = [&](int tile, int c, float* dst) {
    const int t0 = tile * F;
    stage_async(dst, x + static_cast<long long>(c) * S, S, static_cast<long long>(t0) * D - P,
                (min(F, T - t0) - 1) * D + L);
  };
  // the weights' slice, the prototype and the first window are in flight
  // while the twiddle table is filled
  if (wrows) {
    const unsigned ws = smem_addr(wsl);
    for (int e = threadIdx.x; e < (c1 - c0) * K; e += blockDim.x) {
      const int k = e / (c1 - c0), c = c0 + e - k * (c1 - c0);
      cp_async<8>(ws + 8 * ((c - c0) * K + k), w + static_cast<long long>(k) * C + c);
    }
    cp_commit();
  }
  float4 h[kTaps ? kTaps : 1];
  if constexpr (kTaps > 0) {
    const int groups = M / 4;
    if (static_cast<int>(threadIdx.x) < (M / D) * groups) {
      const int p = 4 * (threadIdx.x % groups);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) h[j] = __ldg(reinterpret_cast<const float4*>(hf + j * M + p));
    }
  }
  if (stage) {
    if (!kTaps) stage_async(hf_s, hf, L, 0, L);
    if (first < ntile && c0 < c1) window(first, c0, sig[0]);
  }
  if (table)
    for (int j = threadIdx.x; j < M; j += blockDim.x) smem[j] = twiddle(j, M);
  for (int tile = first; tile < ntile; tile += stride) {
    const int t0 = tile * F, nf = min(F, T - t0);
    float2* yt = y + static_cast<long long>(t0) * K;
    float2 acc[kTile ? kItems : 1][2];
#pragma unroll
    for (int i = 0; i < (kTile ? kItems : 1); ++i) acc[i][0] = acc[i][1] = make_float2(0.f, 0.f);
    if (stage && tile != first) window(tile, c0, sig[0]);
    for (int c = c0; c < c1; ++c) {
      const int j = c - c0;
      if (stage && c + 1 < c1) {
        window(tile, c + 1, sig[(j + 1) & 1]);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();   // the window is in place; the last channel's bins are read
      if constexpr (kTaps > 0)
        fold_slide<kTaps>(b0, sig[j & 1], h, M, D, nf, n);
      else
        fold<kPad>(b0, sig[j & 1], hf_s, x + static_cast<long long>(c) * S, hf, S, M, m, D, t0,
                   nf, pl, stage);
      __syncthreads();
      const float2* Z;
      if constexpr (kTile)   // the main path's size with constant stages
        Z = M == 256 ? stages_pow2<128, 1, kPad>(b0, b1, nf, tw)
                     : run_stages<kHeldLayout, 8, kPad>(b0, b1, nf, pl, tw);
      else
        Z = run_stages<kHeldLayout, 8, kPad>(b0, b1, nf, pl, tw);
      // the sums of conj(w) A, an item (bins k and n - k) at a time
      if constexpr (kTile) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int e = threadIdx.x + i * kThreadsS;
          if (e < nf * KI) {
            const int f = pl.by_ki.div(e), k = e - f * KI;
            float2 a, b;
            const bool two = split_item<kPad>(Z, f * n, k, n, pl.s, tw, &a, &b);
            acc[i][0] = cmac_conj(wt(k, c), a, acc[i][0]);
            if (two) acc[i][1] = cmac_conj(wt(n - k, c), b, acc[i][1]);
          }
        }
      } else {
        for (int e = threadIdx.x; e < nf * KI; e += blockDim.x) {
          const int f = pl.by_ki.div(e), k = e - f * KI;
          float2 a, b;
          const bool two = split_item<kPad>(Z, f * n, k, n, pl.s, tw, &a, &b);
          float2* o = yt + f * K;
          const bool last = kStaged && bad && c == C - 1;
          o[k] = last ? nan2() : cmac_conj(wt(k, c), a, c == 0 ? make_float2(0.f, 0.f) : o[k]);
          if (two)
            o[n - k] = last ? nan2()
                            : cmac_conj(wt(n - k, c), b, c == 0 ? make_float2(0.f, 0.f) : o[n - k]);
        }
      }
    }
    if constexpr (kTile) {
      // the partial tile, entry f K + k, into this block's buffers (Q = 1:
      // straight to y)
      float2* part = Q == 1 ? yt : b0;
      if (Q > 1) __syncthreads();   // the buffers' last bins are read
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int e = threadIdx.x + i * kThreadsS;
        if (e < nf * KI) {
          const int f = pl.by_ki.div(e), k = e - f * KI;
          const bool two = pl.s == 2 && 2 * k != n;
          part[f * K + k] = kStaged && bad ? nan2() : acc[i][0];
          if (two) part[f * K + n - k] = kStaged && bad ? nan2() : acc[i][1];
        }
      }
      if (Q > 1) {
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        for (int e = q * blockDim.x + threadIdx.x; e < nf * K; e += Q * blockDim.x) {
          float2 v = cl.map_shared_rank(b0, 0)[e];
          for (int r = 1; r < Q; ++r) v = cadd(v, cl.map_shared_rank(b0, r)[e]);
          yt[e] = v;
        }
        cl.sync();   // every rank's partial stays until all are read
      }
    }
  }
}

// The launch: layout (0 ping-pong in shared memory, 1 held, 2 ping-pong in
// device memory), frames a tile, grid, shared bytes, twiddle table, and the
// device scratch in bytes.
struct Launch {
  int layout, F, grid, table, stage;
  size_t smem, scratch;
};

int plan_launch(int C, int T, int M, int m, int D, const Plan& pl, Launch* ln) {
  int budget, sms;
  const int rc = smem_budget(&budget, &sms);
  if (rc) return rc;
  const size_t n = pl.n, tab = 8ull * M;
  const long long frames = static_cast<long long>(C) * T;
  int F = static_cast<int>(kTilePoints / n > 1 ? kTilePoints / n : 1);
  const long long spread = (frames + 4ll * sms - 1) / (4ll * sms);   // tiles for 4 blocks an SM
  if (spread < F) F = static_cast<int>(spread > 1 ? spread : 1);
  if (F > T) F = T;
  ln->F = F;
  ln->scratch = 0;
  ln->stage = 0;
  ln->grid = static_cast<int>(C * static_cast<long long>((T + F - 1) / F));
  const size_t pp = 16ull * F * n;
  const size_t staged = 4ull * (2ll * m * M + static_cast<long long>(F - 1) * D);
  for (int table = 1; table >= 0; --table) {
    if (pp + (table ? tab : 0) <= static_cast<size_t>(budget)) {
      ln->layout = 0;
      ln->table = table;
      ln->smem = pp + (table ? tab : 0);
      ln->stage = ln->smem + staged <= static_cast<size_t>(budget);
      if (ln->stage) ln->smem += staged;
      return 0;
    }
  }
  ln->F = 1;
  ln->grid = static_cast<int>(frames);
  if (held_fits(pl))
    for (int table = 1; table >= 0; --table) {
      if (8ull * n + (table ? tab : 0) <= static_cast<size_t>(budget)) {
        ln->layout = 1;
        ln->table = table;
        ln->smem = 8ull * n + (table ? tab : 0);
        return 0;
      }
    }
  ln->layout = 2;
  ln->grid = static_cast<int>(frames < 2ll * sms ? frames : 2ll * sms);
  ln->table = tab <= static_cast<size_t>(budget);
  ln->smem = ln->table ? tab : 0;
  ln->scratch = 16ull * n * ln->grid;
  return 0;
}

// The fused kernel's launch: layout as Launch, Q blocks (a cluster) per
// tile, whether the tile's sums are in registers (kTile), the prototype's
// taps held in registers by the fold (kTaps, 4; 0: read from shared memory),
// and the rows of the weights' slice in shared memory (0: read from device
// memory).
struct BfLaunch {
  int layout, F, Q, grid, table, wrows, stage, tile, taps;
  size_t smem, scratch;
};

// Tiles of F frames as the analysis's (F n <= 1024), then the channels
// split over Q blocks a tile (a power of two up to the portable cluster
// size and C) and F halved until the grid has kBlocksPerSm blocks an SM;
// a block per frame for larger n, as the analysis.  A tile plan takes the
// twiddle table or leaves layout 0, since the tiles' kernel reads the table
// without a check.  hf_vec: the prototype may be read as float4 (16-byte
// aligned).
int plan_beamform(int C, int T, int M, int m, int D, bool hf_vec, const Plan& pl,
                  BfLaunch* ln) {
  int budget, sms;
  const int rc = smem_budget(&budget, &sms);
  if (rc) return rc;
  const long long n = pl.n, K = M / 2 + 1, L = static_cast<long long>(m) * M, tab = 8ll * M;
  const long long want = static_cast<long long>(kBlocksPerSm) * sms;
  const auto tiles = [&](long long f) { return (T + f - 1) / f; };
  long long F = kTilePoints / n > 1 ? kTilePoints / n : 1;
  if (F > T) F = T;
  int Q = 1;
  while (2 * Q <= kMaxCluster && 2 * Q <= C && tiles(F) * Q < want) Q *= 2;
  while (F > 1 && tiles(F) * Q < want) F = (F + 1) / 2;
  ln->tile = F * split_items(M) <= static_cast<long long>(kItems) * kThreadsS;
  if (!ln->tile) Q = 1;
  ln->F = static_cast<int>(F);
  ln->Q = Q;
  ln->scratch = 0;
  ln->stage = 0;
  ln->taps = 0;
  ln->wrows = 0;
  ln->grid = static_cast<int>(tiles(F) * Q);
  const long long pp = 16ll * padded(static_cast<int>(F * n));
  const long long rows = (C + Q - 1) / Q, slice = 8 * ((rows * K + 1) & ~1ll);
  const bool slide = ln->tile && hf_vec && m == 4 && M % 4 == 0 && D % 4 == 0 &&
                     static_cast<long long>(M / D) * (M / 4) <= kThreadsS;
  const long long windows = 8 * ((F - 1) * D + L);
  for (int table = 1; table >= (ln->tile ? 1 : 0); --table) {
    long long smem = pp + (table ? tab : 0);
    if (smem <= budget) {
      ln->layout = 0;
      ln->table = table;
      if (smem + slice <= budget) {
        ln->wrows = static_cast<int>(rows);
        smem += slice;
      }
      const long long staged = windows + (slide ? 0 : 4 * L);
      ln->stage = smem + staged <= budget;
      if (ln->stage) {
        smem += staged;
        ln->taps = slide ? m : 0;
      }
      ln->smem = static_cast<size_t>(smem);
      return 0;
    }
  }
  ln->F = 1;
  ln->Q = 1;
  ln->tile = 0;
  ln->grid = T;
  if (held_fits(pl))
    for (int table = 1; table >= 0; --table) {
      if (8 * n + (table ? tab : 0) <= budget) {
        ln->layout = 1;
        ln->table = table;
        ln->smem = static_cast<size_t>(8 * n + (table ? tab : 0));
        return 0;
      }
    }
  ln->layout = 2;
  ln->grid = T < 2 * sms ? T : 2 * sms;
  ln->table = tab <= budget;
  ln->smem = ln->table ? static_cast<size_t>(tab) : 0;
  ln->scratch = 16ull * padded(static_cast<int>(n)) * ln->grid;
  return 0;
}

template <bool kHeldLayout, bool kTile, bool kStaged, int kTaps>
int launch_bf(const BfLaunch& ln, const float* x, const float* hf, const float2* w, float2* y,
              int C, int S, int T, int M, int m, int D, const Plan& pl, float2* gbuf,
              const Staged& stg, cudaStream_t st) {
  const auto kernel = analysis_beamform_kernel<kHeldLayout, kTile, kStaged, kTaps>;
  int rc = set_smem(reinterpret_cast<const void*>(kernel), ln.smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ln.grid));
  cfg.blockDim = dim3(kHeldLayout ? kThreadsH : kThreadsS);
  cfg.dynamicSmemBytes = ln.smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(ln.Q);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = ln.Q > 1 ? 1 : 0;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, x, hf, w, y, C, S, T, M, m, D, ln.F,
                                           ln.Q, ln.table, ln.wrows, ln.stage, pl, gbuf, stg));
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged>
int analysis_beamform(const float* x, const float* hf, const float2* w, float2* y, void* scratch,
                      int C, int S, int T, int M, int m, int D, const Staged& stg, void* stream) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl, 8);
  if (pl.nst > kMaxStages) return kNoFit;
  BfLaunch ln;
  const int rc =
      plan_beamform(C, T, M, m, D, reinterpret_cast<uintptr_t>(hf) % 16 == 0, pl, &ln);
  if (rc) return rc;
  if (ln.scratch > 0 && scratch == nullptr) return kNoFit;
  float2* gbuf = ln.layout == 2 ? static_cast<float2*>(scratch) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln.layout == 1)
    return launch_bf<true, false, kStaged, 0>(ln, x, hf, w, y, C, S, T, M, m, D, pl, nullptr, stg,
                                              st);
  if (!ln.tile)
    return launch_bf<false, false, kStaged, 0>(ln, x, hf, w, y, C, S, T, M, m, D, pl, gbuf, stg,
                                               st);
  if (ln.taps == 4)
    return launch_bf<false, true, kStaged, 4>(ln, x, hf, w, y, C, S, T, M, m, D, pl, nullptr, stg,
                                              st);
  return launch_bf<false, true, kStaged, 0>(ln, x, hf, w, y, C, S, T, M, m, D, pl, nullptr, stg,
                                            st);
}

}  // namespace

extern "C" {

// The device scratch, in bytes, that dsr_fb_analysis needs for these
// arguments (0 unless the FFT exceeds what a block holds in shared memory).
int dsr_fb_analysis_scratch(int C, int T, int M, int m, int D, long long* bytes) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl, 4);
  if (pl.nst > kMaxStages) return kNoFit;
  Launch ln;
  const int rc = plan_launch(C, T, M, m, D, pl, &ln);
  *bytes = static_cast<long long>(ln.scratch);
  return rc;
}

// x: (C, S) float32, hf: (L,) float32, out: (C, T, K) complex64; scratch:
// the bytes dsr_fb_analysis_scratch asks for (null when it asks for none).
int dsr_fb_analysis(const float* x, const float* hf, float2* out, void* scratch, int C, int S,
                    int T, int M, int m, int D, void* stream) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl, 4);
  if (pl.nst > kMaxStages) return kNoFit;
  Launch ln;
  int rc = plan_launch(C, T, M, m, D, pl, &ln);
  if (rc) return rc;
  if (ln.scratch > 0 && scratch == nullptr) return kNoFit;
  float2* gbuf = ln.layout == 2 ? static_cast<float2*>(scratch) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln.layout == 1) {
    rc = set_smem(reinterpret_cast<const void*>(analysis_fft_kernel<true>), ln.smem);
    if (rc) return rc;
    analysis_fft_kernel<true><<<ln.grid, kThreadsH, ln.smem, st>>>(
        x, hf, out, C, S, T, M, m, D, ln.F, ln.table, 0, pl, nullptr);
  } else {
    rc = set_smem(reinterpret_cast<const void*>(analysis_fft_kernel<false>), ln.smem);
    if (rc) return rc;
    analysis_fft_kernel<false><<<ln.grid, kThreadsS, ln.smem, st>>>(
        x, hf, out, C, S, T, M, m, D, ln.F, ln.table, ln.stage, pl, gbuf);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device scratch, in bytes, that dsr_fb_analysis_beamform(_staged)
// needs for these arguments (0 unless the FFT exceeds what a block holds
// in shared memory).
int dsr_fb_analysis_beamform_scratch(int C, int T, int M, int m, int D, long long* bytes) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl, 8);
  if (pl.nst > kMaxStages) return kNoFit;
  BfLaunch ln;
  const int rc = plan_beamform(C, T, M, m, D, true, pl, &ln);
  *bytes = static_cast<long long>(ln.scratch);
  return rc;
}

// x: (C, S) float32, hf: (L,), w: (K, C) complex64, y: (T, K) complex64;
// scratch as dsr_fb_analysis's.
int dsr_fb_analysis_beamform(const float* x, const float* hf, const float2* w, float2* y,
                             void* scratch, int C, int S, int T, int M, int m, int D,
                             void* stream) {
  return analysis_beamform<false>(x, hf, w, y, scratch, C, S, T, M, m, D, Staged{}, stream);
}

// The staged bank: xbank (B, C, S) float32; the buffer is idx[0] (device
// memory) when idx is not null, else idx_host.  Otherwise as above.
int dsr_fb_analysis_beamform_staged(const float* xbank, const int* idx, int idx_host, int B,
                                    const float* hf, const float2* w, float2* y, void* scratch,
                                    int C, int S, int T, int M, int m, int D, void* stream) {
  const Staged stg{idx, idx_host, B, static_cast<long long>(C) * S};
  return analysis_beamform<true>(xbank, hf, w, y, scratch, C, S, T, M, m, D, stg, stream);
}

}  // extern "C"
