// GSC-NLMS for Hopper (sm_90a): the generalised sidelobe canceller's whole
// frame recurrence, per (utterance, subband bin), in one launch.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/gsc.py; the entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or kNoFit for an input it does not take).
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
//
// More than 16 channels (gsc_warp_kernel).  At N = 64 one bin's B alone is
// 64 x 63 x 8 B = 32 KB and wa is 63 complex values, so the per-thread
// layout above cannot hold.  There one warp takes one (utterance, bin): the
// lanes own B's N-1 columns (two each at N = 64) and the matching z and wa
// entries, the frame's x sits in shared memory for all lanes, and yc, wa^H z,
// |z|^2 and |wa|^2 are summed over the lanes by butterfly shuffles (two
// reductions per frame).  B is copied to shared memory when it fits beside
// the vectors (N <= ~165 on an H100), else read through L1 from device
// memory; the vectors (wq, x, z, wa) live in shared memory, or for a channel
// count beyond ~7,000 in the caller's global scratch.  Same numerics as
// above: IEEE sqrt and division, only the order of the sums differs.

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

// ---- N > 16: one warp per (utterance, bin) ---------------------------------

constexpr int kPre = 4;   // x[lane + 32 j], j < kPre, of the next frame held in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// vec: wq (N), x (N), z (N-1), wa (N-1) float2 of this (b, k), in shared
// memory (scratch null) or at scratch + (b K + k) (2N + 2(N-1)); B in shared
// memory after the vectors when b_shared, else read from device memory.
__global__ void __launch_bounds__(32)
gsc_warp_kernel(const float2* __restrict__ X, const float2* __restrict__ wq,
                const float2* __restrict__ B, const float2* __restrict__ wa0,
                float2* __restrict__ Y, float2* __restrict__ wa_out, float2* scratch, int N,
                int T, int K, int b_shared, float mu, float eps, float cap) {
  extern __shared__ __align__(16) float2 shw[];
  const int lane = threadIdx.x, k = blockIdx.x, b = blockIdx.y, NM = N - 1;
  const size_t bk = static_cast<size_t>(b) * K + k;
  const int nvec = 2 * N + 2 * NM;
  float2* vec = scratch ? scratch + bk * nvec : shw;
  float2* wq_s = vec;
  float2* x_s = wq_s + N;
  float2* z_s = x_s + N;
  float2* wa_s = z_s + NM;
  const float2* Bg = B + bk * N * NM;
  const float2* Bs = Bg;
  if (b_shared) {
    float2* bsh = scratch ? shw : shw + nvec;
    for (int i = lane; i < N * NM; i += 32) bsh[i] = ld(Bg + i);
    Bs = bsh;
  }
  for (int n = lane; n < N; n += 32) wq_s[n] = ld(wq + bk * N + n);
  for (int m = lane; m < NM; m += 32) wa_s[m] = wa0 ? ld(wa0 + bk * NM + m) : make_float2(0.f, 0.f);

  // X[b, n, t, k] = Xb[(n * T + t) * K]
  const float2* Xb = X + static_cast<size_t>(b) * N * T * K + k;
  const size_t nstride = static_cast<size_t>(T) * K;
  float2* Yb = Y + static_cast<size_t>(b) * T * K + k;
  float2 xn[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int n = lane + 32 * j;
    if (n < N) xn[j] = ld(Xb + n * nstride);
  }
  for (int t = 0; t < T; ++t) {
    __syncwarp();   // every lane is done with the previous frame's x
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const int n = lane + 32 * j;
      if (n < N) x_s[n] = xn[j];
    }
    for (int n = lane + 32 * kPre; n < N; n += 32)
      x_s[n] = ld(Xb + n * nstride + static_cast<size_t>(t) * K);
    if (t + 1 < T) {
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        const int n = lane + 32 * j;
        if (n < N) xn[j] = ld(Xb + n * nstride + static_cast<size_t>(t + 1) * K);
      }
    }
    __syncwarp();

    // the lane's parts of yc = wq^H x, z = B^H x (its columns), |z|^2, wa^H z
    float ycr = 0.f, yci = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float2 w = wq_s[n], x = x_s[n];
      ycr += w.x * x.x + w.y * x.y;
      yci += w.x * x.y - w.y * x.x;
    }
    float zn = 0.f, ar = 0.f, ai = 0.f;
    for (int m = lane; m < NM; m += 32) {
      float zr = 0.f, zi = 0.f;
      for (int n = 0; n < N; ++n) {
        const float2 bb = Bs[n * NM + m], x = x_s[n];
        zr += bb.x * x.x + bb.y * x.y;
        zi += bb.x * x.y - bb.y * x.x;
      }
      z_s[m] = make_float2(zr, zi);
      zn += zr * zr + zi * zi;
      const float2 w = wa_s[m];
      ar += w.x * zr + w.y * zi;
      ai += w.x * zi - w.y * zr;
    }
    ycr = warp_sum(ycr);
    yci = warp_sum(yci);
    zn = warp_sum(zn);
    ar = warp_sum(ar);
    ai = warp_sum(ai);
    const float yr = ycr - ar, yi = yci - ai;
    if (lane == 0) Yb[static_cast<size_t>(t) * K] = make_float2(yr, yi);
    const float g = mu / (zn + eps);
    float s = 0.f;
    for (int m = lane; m < NM; m += 32) {
      const float2 z = z_s[m];
      float2 w = wa_s[m];
      w.x += (z.x * yr + z.y * yi) * g;     // z conj(y)
      w.y += (z.y * yr - z.x * yi) * g;
      wa_s[m] = w;
      s += w.x * w.x + w.y * w.y;
    }
    const float scale = fminf(1.f, cap / fmaxf(sqrtf(warp_sum(s)), 1e-30f));
    for (int m = lane; m < NM; m += 32) {
      float2 w = wa_s[m];
      w.x *= scale;
      w.y *= scale;
      wa_s[m] = w;
    }
  }
  for (int m = lane; m < NM; m += 32) wa_out[bk * NM + m] = wa_s[m];
}

int smem_optin(int* bytes) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// Where the warp kernel keeps its vectors and B for N channels: 0 (or a
// CUDA error), with *vec_shared and *b_shared set.
int warp_layout(int N, int* vec_shared, int* b_shared, size_t* smem) {
  int optin;
  const int rc = smem_optin(&optin);
  if (rc) return rc;
  const size_t vec = (4 * static_cast<size_t>(N) - 2) * sizeof(float2);
  const size_t bm = static_cast<size_t>(N) * (N - 1) * sizeof(float2);
  *vec_shared = vec <= static_cast<size_t>(optin);
  *b_shared = (*vec_shared ? vec : 0) + bm <= static_cast<size_t>(optin);
  *smem = (*vec_shared ? vec : 0) + (*b_shared ? bm : 0);
  return 0;
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

// Global scratch (float2 elements) the call needs for U utterances of K
// bins at N channels: 0 unless the warp kernel's vectors exceed shared
// memory; negative for a CUDA error.
long long dsr_gsc_scratch(int U, int N, int K) {
  if (N <= kMaxN) return 0;
  int vec_shared, b_shared;
  size_t smem;
  const int rc = warp_layout(N, &vec_shared, &b_shared, &smem);
  if (rc) return -rc;
  return vec_shared ? 0 : static_cast<long long>(U) * K * (4 * static_cast<long long>(N) - 2);
}

// X (U, N, T, K), wq (U, K, N), B (U, K, N, N-1), wa0 (U, K, N-1) or null,
// all complex64 as interleaved float2 → Y (U, T, K), wa (U, K, N-1).
// N >= 2, T >= 1; scratch as dsr_gsc_scratch asks (null when 0).
int dsr_gsc_nlms(const void* X, const void* wq, const void* B, const void* wa0, void* Y,
                 void* wa, int U, int N, int T, int K, float mu, float eps, float cap,
                 void* scratch, void* stream) {
  if (N < 2 || T < 1) return kNoFit;
  const float2* X2 = static_cast<const float2*>(X);
  const float2* wq2 = static_cast<const float2*>(wq);
  const float2* B2 = static_cast<const float2*>(B);
  const float2* wa02 = static_cast<const float2*>(wa0);
  float2* Y2 = static_cast<float2*>(Y);
  float2* wa2 = static_cast<float2*>(wa);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= kMaxN) return dispatch<2>(N, X2, wq2, B2, wa02, Y2, wa2, U, T, K, mu, eps, cap, st);
  int vec_shared, b_shared;
  size_t smem;
  const int rc = warp_layout(N, &vec_shared, &b_shared, &smem);
  if (rc) return rc;
  if (!vec_shared && scratch == nullptr) return kNoFit;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gsc_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gsc_warp_kernel<<<dim3(K, U), 32, smem, st>>>(
      X2, wq2, B2, wa02, Y2, wa2, vec_shared ? nullptr : static_cast<float2*>(scratch), N, T,
      K, b_shared, mu, eps, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
