// Fractional-delay steering fused with delay-and-sum for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/steering.py;
// the entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().
//
// Replaces dsr_tpu/ops/pallas/steering.py:34 _ds_kernel.
//
// The function: X (N, T, K) complex64 subbands, delays tau (T, N) per frame
// (a tracker's trajectory) or (N,) for all frames, bin frequencies
// f_k = k * fscale with fscale = sample_rate / M →
//   Y[t, k] = (1/N) sum_n e^{+2 pi i f_k tau[t, n]} X[n, t, k],
// that is conj(v) . x with the steering vector v = e^{-2 pi i f_k tau}; the
// plain twin ds_beamform_plain is the composed steering_vectors + ds_weights
// + apply_weights.  The phase is formed as the twin forms it, in float32,
// (-2 pi * f_k) * tau, and evaluated with the precise sincosf (no
// --use_fast_math): the phase reaches ~15 rad for a 0.10 m array at 8 kHz,
// where the __sincosf intrinsic loses accuracy.
//
// What bounds it on this card: X must be read once (8 ch x 1000 frames x
// 129 bins x 8 bytes = 8.3 MB, 2.5 us at 3.35 TB/s); the arithmetic, a
// sine and cosine and four multiply-adds per (n, t, k), is far below that
// at the FP32 rate, so bytes bound it.  The design answers that with one
// thread per (t, k), numbered t * K + k: a warp reads 32 neighbouring
// float2 of a channel's (T, K) plane (coalesced), loops over the N
// channels with the sum in registers, and writes Y once.  The steering
// vectors are never stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg2Pi = -6.283185307179586f;

__global__ void __launch_bounds__(kThreads)
ds_kernel(const float2* __restrict__ X, const float* __restrict__ tau, float2* __restrict__ Y,
          int N, int T, int K, int tau_stride, float fscale) {
  // i = t * K + k, so X[n, t, k] = X[n * T * K + i] and Y[t, k] = Y[i]
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t TK = static_cast<int64_t>(T) * K;
  if (i >= TK) return;
  const int t = static_cast<int>(i / K);
  const int k = static_cast<int>(i - static_cast<int64_t>(t) * K);
  const float w = kNeg2Pi * (static_cast<float>(k) * fscale);
  const float* tau_t = tau + static_cast<int64_t>(t) * tau_stride;
  float ar = 0.f, ai = 0.f;
  for (int n = 0; n < N; ++n) {
    float s, c;
    sincosf(w * __ldg(tau_t + n), &s, &c);
    const float2 v = __ldg(X + n * TK + i);
    // (c - i s)(xr + i xi)
    ar += c * v.x + s * v.y;
    ai += c * v.y - s * v.x;
  }
  const float inv = static_cast<float>(N);
  Y[i] = make_float2(ar / inv, ai / inv);
}

}  // namespace

extern "C" {

// X (N, T, K) complex64 as float2, tau (T, N) (tau_stride = N) or (N,)
// (tau_stride = 0) float32 seconds → Y (T, K) complex64.
int dsr_ds_beamform(const void* X, const float* tau, void* Y, int N, int T, int K,
                    int tau_stride, float fscale, void* stream) {
  const int64_t TK = static_cast<int64_t>(T) * K;
  if (TK == 0) return 0;
  const unsigned grid = static_cast<unsigned>((TK + kThreads - 1) / kThreads);
  ds_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(X), tau, static_cast<float2*>(Y), N, T, K, tau_stride, fscale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
