// GSC-NLMS for Hopper (sm_90a): the generalised sidelobe canceller's whole
// frame recurrence, per (utterance, subband bin), in one launch.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/gsc.py; the entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or kNoFit for a channel count it does not take).
//
// Replaces dsr_tpu/ops/pallas/gsc.py:27 _gsc_kernel.
//
// The function, per utterance b and bin k, over frames t = 0 .. T-1, with
// x = X[b, :, t, k] (N channels), the quiescent weights wq (N), the blocking
// matrix B (N x N-1) and the active weights wa (N-1, from wa0 or zero):
//   yc = wq^H x;  z = B^H x;  y = yc - wa^H z;  Y[b, t, k] = y;
//   wa += mu z conj(y) / (|z|^2 + eps);  wa *= min(1, cap / max(|wa|, 1e-30)).
// The final wa is written out, so a caller threads it into the next chunk.
// That is dsr_tpu/ops/beamforming.py _gsc_scan and the plain twin
// gsc_nlms_plain; sqrtf and IEEE division (no --use_fast_math), so the
// kernel differs from the twin only in the order of its sums.
//
// Design.  The TPU kernel made the frame index its grid and kept wa in VMEM
// scratch between grid steps, which relies on the TPU running a grid in
// order.  Blocks on this card run in no order, so the recurrence lives in
// one thread: thread (b, k) loops over the frames with wa in registers.
// Threads over k read neighbouring float2 addresses of X (b, n, t, k), so
// each frame's read is coalesced, and X is read as the caller's interleaved
// complex64 with no repacking.  wq and B, fixed per thread, sit in shared
// memory ([entry][thread], so a warp's reads hit 32 banks).
//
// What bounds it on this card.  X must be read once: 8 x 8 ch x 1000 frames
// x 129 bins x 8 bytes is 66 MB, 20 us at 3.35 TB/s, and the arithmetic is
// ~8 N^2 operations per step, 10 us at 67 TFLOP/s.  But only U * K threads
// exist (129 for one utterance, 1,032 for eight: a few warps on a handful
// of the 132 SMs), and each runs T dependent steps, so T times the time
// of one step, not bytes, bounds the kernel.
// yc and z do not depend on wa, so only y, the update and the norm cap
// form the serial chain (O(N) per step).  The design shortens that chain
// without a second kernel or a scratch array: each iteration computes the
// next frame's yc and z, and loads the frame after that, beside the current
// frame's chain, so the compiler interleaves the O(N^2) work with the
// dependent O(N) work; and the chain's sums are split into two partial sums
// each.  Measured on an H100 (PERF.md), a step takes ~0.7 us, ~1,400
// cycles at the 1,980 MHz maximum clock: one warp issues the whole step,
// an estimated ~450 instructions of which the next frame's O(N^2) yc and z
// are most, so this version is bound by one warp's issue, not by the
// chain alone or by memory latency (asking
// X's lines into L1 16 frames ahead left the one-utterance time as it
// was).  Spreading each bin's z over N-1 lanes, or a two-phase version (all
// frames' z first, in parallel, at the cost of writing and reading z, 58 MB
// at U = 8), would take the O(N^2) work off the one warp's path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;        // one warp per block: blocks spread over the SMs
constexpr int kMaxN = 16;
constexpr int kNoFit = -1;

__device__ __forceinline__ float2 ld(const float2* p) { return __ldg(p); }

template <int N>
__global__ void __launch_bounds__(kThreads)
gsc_kernel(const float2* __restrict__ X, const float2* __restrict__ wq,
           const float2* __restrict__ B, const float2* __restrict__ wa0,
           float2* __restrict__ Y, float2* __restrict__ wa_out, int T, int K, float mu,
           float eps, float cap) {
  constexpr int NM = N - 1;
  extern __shared__ __align__(16) float2 sh[];   // [N + N * NM][kThreads]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + tid;
  if (k >= K) return;                            // each thread uses its own column only
  const size_t bk = static_cast<size_t>(b) * K + k;
  float2* wq_s = sh + tid;                       // wq_s[n * kThreads]
  float2* B_s = sh + N * kThreads + tid;         // B_s[(n * NM + m) * kThreads]
#pragma unroll
  for (int n = 0; n < N; ++n) wq_s[n * kThreads] = ld(wq + bk * N + n);
#pragma unroll 4
  for (int i = 0; i < N * NM; ++i) B_s[i * kThreads] = ld(B + bk * N * NM + i);

  float war[NM], wai[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const float2 w = wa0 ? ld(wa0 + bk * NM + m) : make_float2(0.f, 0.f);
    war[m] = w.x;
    wai[m] = w.y;
  }

  // X[b, n, t, k] = Xb[(n * T + t) * K]
  const float2* Xb = X + static_cast<size_t>(b) * N * T * K + k;
  const size_t nstride = static_cast<size_t>(T) * K;
  float2* Yb = Y + static_cast<size_t>(b) * T * K + k;

  // yc and z of frame t from x (conj(wq) and conj(B) applied here)
  float ycr, yci, zr[NM], zi[NM], zn;
  float2 xnext[N];
  auto front = [&](const float2 (&x)[N], float& cr, float& ci, float (&r)[NM],
                   float (&im)[NM], float& norm) {
    cr = 0.f;
    ci = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float2 w = wq_s[n * kThreads];
      cr += w.x * x[n].x + w.y * x[n].y;
      ci += w.x * x[n].y - w.y * x[n].x;
    }
    norm = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float2 bb = B_s[(n * NM + m) * kThreads];
        ar += bb.x * x[n].x + bb.y * x[n].y;
        ai += bb.x * x[n].y - bb.y * x[n].x;
      }
      r[m] = ar;
      im[m] = ai;
      norm += ar * ar + ai * ai;
    }
  };

  {
    float2 x0[N];
#pragma unroll
    for (int n = 0; n < N; ++n) x0[n] = ld(Xb + n * nstride);
    front(x0, ycr, yci, zr, zi, zn);
  }
  if (T > 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) xnext[n] = ld(Xb + n * nstride + K);
  }

  for (int t = 0; t < T; ++t) {
    // the serial chain of frame t
    float ar0 = 0.f, ai0 = 0.f, ar1 = 0.f, ai1 = 0.f;   // wa^H z, two partial sums
#pragma unroll
    for (int m = 0; m < NM; m += 2) {
      ar0 += war[m] * zr[m] + wai[m] * zi[m];
      ai0 += war[m] * zi[m] - wai[m] * zr[m];
      if (m + 1 < NM) {
        ar1 += war[m + 1] * zr[m + 1] + wai[m + 1] * zi[m + 1];
        ai1 += war[m + 1] * zi[m + 1] - wai[m + 1] * zr[m + 1];
      }
    }
    const float yr = ycr - (ar0 + ar1);
    const float yi = yci - (ai0 + ai1);
    Yb[static_cast<size_t>(t) * K] = make_float2(yr, yi);
    const float g = mu / (zn + eps);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      war[m] += (zr[m] * yr + zi[m] * yi) * g;    // z conj(y)
      wai[m] += (zi[m] * yr - zr[m] * yi) * g;
      if (m & 1) s1 += war[m] * war[m] + wai[m] * wai[m];
      else s0 += war[m] * war[m] + wai[m] * wai[m];
    }
    const float scale = fminf(1.f, cap / fmaxf(sqrtf(s0 + s1), 1e-30f));
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      war[m] *= scale;
      wai[m] *= scale;
    }

    // beside it: frame t + 1's yc and z, and frame t + 2's load
    if (t + 1 < T) {
      float2 x[N];
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = xnext[n];
      if (t + 2 < T) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          xnext[n] = ld(Xb + n * nstride + static_cast<size_t>(t + 2) * K);
      }
      front(x, ycr, yci, zr, zi, zn);
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) wa_out[bk * NM + m] = make_float2(war[m], wai[m]);
}

template <int N>
int launch(const float2* X, const float2* wq, const float2* B, const float2* wa0, float2* Y,
           float2* wa, int U, int T, int K, float mu, float eps, float cap,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N + N * (N - 1)) * kThreads * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gsc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((K + kThreads - 1) / kThreads, U);
  gsc_kernel<N><<<grid, kThreads, smem, stream>>>(X, wq, B, wa0, Y, wa, T, K, mu, eps, cap);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int dispatch(int n, const float2* X, const float2* wq, const float2* B, const float2* wa0,
             float2* Y, float2* wa, int U, int T, int K, float mu, float eps, float cap,
             cudaStream_t stream) {
  if constexpr (N > kMaxN) {
    return kNoFit;
  } else {
    if (n == N) return launch<N>(X, wq, B, wa0, Y, wa, U, T, K, mu, eps, cap, stream);
    return dispatch<N + 1>(n, X, wq, B, wa0, Y, wa, U, T, K, mu, eps, cap, stream);
  }
}

}  // namespace

extern "C" {

// X (U, N, T, K), wq (U, K, N), B (U, K, N, N-1), wa0 (U, K, N-1) or null,
// all complex64 as interleaved float2 → Y (U, T, K), wa (U, K, N-1).
// 2 <= N <= 16, T >= 1.
int dsr_gsc_nlms(const void* X, const void* wq, const void* B, const void* wa0, void* Y,
                 void* wa, int U, int N, int T, int K, float mu, float eps, float cap,
                 void* stream) {
  if (N < 2 || N > kMaxN || T < 1) return kNoFit;
  return dispatch<2>(N, static_cast<const float2*>(X), static_cast<const float2*>(wq),
                     static_cast<const float2*>(B), static_cast<const float2*>(wa0),
                     static_cast<float2*>(Y), static_cast<float2*>(wa), U, T, K, mu, eps, cap,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
