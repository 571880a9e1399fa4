// Banded (left-to-right) Viterbi for Hopper (sm_90a): the forced-alignment
// recursion over a linear chain of S states, for U utterances, in one
// launch.  Plain C interface, loaded with ctypes by
// dsr_tpu_torch/ops/cuda/viterbi.py; the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// kNoFit when delta needs global scratch and none was passed).
//
// Replaces dsr_tpu/ops/pallas/viterbi.py:35 _banded_kernel.
//
// The function, per utterance u over frames t < T and states s < S, with
// w_self and w_adv (S,) (shared by all utterances, or one row each):
//   delta_0[s] = init[s] + ll[0, s],  init = 0 at s = 0, -1e30 elsewhere;
//   stay = delta_{t-1}[s] + w_self[s];  adv = delta_{t-1}[s-1] + w_adv[s];
//   delta_t[s] = max(stay, adv) + ll[t, s];  bp[t, s] = adv > stay;
// state 0 has no predecessor (its delta_t is stay + ll, bp 0), and bp[0] = 0.
// Outputs: the backpointer planes bp (U, T, S) as uint8 0/1 (the TPU kernel
// wrote float32 0/1), and the final delta (U, S).  Every sum is one float32
// addition in the order above (no fused multiply-add can form: there is no
// product), so delta and bp equal the plain twin banded_viterbi_plain bit
// for bit.  The traceback stays outside (one copy of bp to the host).
//
// Design.  The TPU kernel made the frame its grid axis and kept delta in
// VMEM between grid steps; blocks on this card run in no order, so one
// block per utterance loops over the frames itself.  Up to 1,024 states
// (config 1's chains have at most 36) each thread owns one state, with its
// w_self and w_adv in registers and ll[t+1] loaded while frame t computes;
// above that, threads stride over the states.  delta is double-buffered in
// shared memory, one __syncthreads() per frame, and bp is written coalesced
// over states.  When 2 S floats exceed the shared
// memory a block may opt in to (S above ~29,000), delta lives in the
// caller's global scratch behind the same barrier.
//
// What bounds it on this card.  The function needs T S (4 + 1) + 4 S 4
// bytes (ll read, bp written, the weights, delta), and 4 T S operations;
// at the alignment shapes (S = 36, T = 186) that is 35 KB, ~10 ns.  But
// the frames are a dependent chain: each costs at least a shared-memory
// round trip and a barrier (~50-100 cycles), so T of them, not bytes,
// bound one utterance, and a batch fills the card only with U blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kNoFit = -1;

// kOne: each thread owns one state (S <= blockDim) in registers, with the
// next frame's ll prefetched; otherwise any S, a plain stride loop.
template <bool kOne>
__global__ void __launch_bounds__(kMaxThreads)
banded_kernel(const float* __restrict__ ll, const float* __restrict__ wself,
              const float* __restrict__ wadv, long long wstride, uint8_t* __restrict__ bp,
              float* __restrict__ delta_out, float* __restrict__ scratch, int T, int S) {
  extern __shared__ float sh[];
  const int u = blockIdx.x, tid = threadIdx.x, bd = blockDim.x;
  float* cur = scratch ? scratch + static_cast<size_t>(u) * 2 * S : sh;
  float* nxt = cur + S;
  const float* llu = ll + static_cast<size_t>(u) * T * S;
  uint8_t* bpu = bp + static_cast<size_t>(u) * T * S;
  const float* ws = wself + u * wstride;
  const float* wa = wadv + u * wstride;

  if constexpr (kOne) {
    const int s = tid;
    const bool own = s < S;
    float r_ws = 0.0f, r_wa = 0.0f, r_ll = 0.0f;
    if (own) {
      r_ws = ws[s];
      r_wa = wa[s];
      cur[s] = (s == 0 ? 0.0f : kNeg) + llu[s];
      bpu[s] = 0;
      r_ll = T > 1 ? llu[S + s] : 0.0f;
    }
    __syncthreads();
    for (int t = 1; t < T; ++t) {
      const float ll_next = (own && t + 1 < T) ? llu[static_cast<size_t>(t + 1) * S + s] : 0.0f;
      if (own) {
        const float stay = cur[s] + r_ws;
        float v = stay;
        uint8_t b = 0;
        if (s > 0) {
          const float adv = cur[s - 1] + r_wa;
          if (adv > stay) {
            v = adv;
            b = 1;
          }
        }
        nxt[s] = v + r_ll;
        bpu[static_cast<size_t>(t) * S + s] = b;
      }
      r_ll = ll_next;
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  } else {
    for (int s = tid; s < S; s += bd) {
      cur[s] = (s == 0 ? 0.0f : kNeg) + llu[s];
      bpu[s] = 0;
    }
    __syncthreads();
    for (int t = 1; t < T; ++t) {
      const float* llt = llu + static_cast<size_t>(t) * S;
      for (int s = tid; s < S; s += bd) {
        const float stay = cur[s] + ws[s];
        float v = stay;
        uint8_t b = 0;
        if (s > 0) {
          const float adv = cur[s - 1] + wa[s];
          if (adv > stay) {
            v = adv;
            b = 1;
          }
        }
        nxt[s] = v + llt[s];
        bpu[static_cast<size_t>(t) * S + s] = b;
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  for (int s = tid; s < S; s += bd) delta_out[static_cast<size_t>(u) * S + s] = cur[s];
}

int smem_optin(int* bytes) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

template <bool kOne>
int launch(const float* ll, const float* ws, const float* wa, long long wstride, uint8_t* bp,
           float* delta, float* scratch, int U, int T, int S, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : 2 * static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_kernel<kOne>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = S < kMaxThreads ? (S + 31) / 32 * 32 : kMaxThreads;
  banded_kernel<kOne><<<U, threads, smem, stream>>>(ll, ws, wa, wstride, bp, delta, scratch, T,
                                                    S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 if delta for S states must live in global scratch ((U, 2, S) float32),
// 0 if it fits a block's shared memory, or a negative CUDA error.
int dsr_banded_needs_scratch(int S) {
  int optin;
  const int rc = smem_optin(&optin);
  if (rc) return -rc;
  return 2 * static_cast<long long>(S) * 4 > optin ? 1 : 0;
}

// ll (U, T, S) f32; wself, wadv (S,) f32 when wstride is 0, else (U, S);
// bp (U, T, S) uint8; delta (U, S) f32; scratch (U, 2, S) f32 or null.
int dsr_banded_viterbi(const float* ll, const float* wself, const float* wadv, long long wstride,
                       void* bp, float* delta, float* scratch, int U, int T, int S,
                       void* stream) {
  if (U < 1 || T < 1 || S < 1) return kNoFit;
  const int need = dsr_banded_needs_scratch(S);
  if (need < 0) return -need;
  if (need && scratch == nullptr) return kNoFit;
  uint8_t* b = static_cast<uint8_t*>(bp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= kMaxThreads)
    return launch<true>(ll, wself, wadv, wstride, b, delta, scratch, U, T, S, st);
  return launch<false>(ll, wself, wadv, wstride, b, delta, scratch, U, T, S, st);
}

}  // extern "C"
