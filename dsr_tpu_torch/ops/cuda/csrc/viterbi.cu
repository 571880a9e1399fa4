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
// VMEM between grid steps; blocks on this card run in no order, so each
// utterance's frames are a loop inside one block.  Up to 1,024 states
// (config 1's chains have at most 36) lane j of a warp owns J consecutive
// states (J = 1, 2 or 4, a template parameter), delta, w_self and w_adv in
// registers, and the only value that crosses lanes in a frame is the
// previous lane's last delta, passed by __shfl_up_sync: up to 128 states
// one warp runs the utterance with no barrier and no shared memory for
// delta; above, S / 128 warps of J = 4 pass their last deltas through
// shared memory behind one barrier a frame (a warp of J = 8 to 32 states a
// lane measured 1.6-2.3x slower on this card: one warp issues about one
// instruction every other cycle).  ll arrives in chunks of about 16 KB of
// frames, three chunks in flight, each by one thread onto its ring slot's
// mbarrier: one TMA bulk copy (cp.async.bulk) of the 16-byte-aligned
// interior of the chunk's rows and 4-byte cp.async copies of the at most
// three floats at either ragged end (so nothing outside ll is read): a lone
// warp issuing cp.async copies of whole chunks itself stalled ~200 cycles
// on each once many were outstanding.  A chunk's bp rows gather in shared
// memory in their device-memory layout (each lane's J bytes in one store
// when S allows) and go out in 16-byte stores.  Above 1,024 states a block of 1,024
// threads strides over the states, delta double-buffered in shared memory
// with one __syncthreads() per frame; when 2 S floats exceed the shared
// memory a block may opt in to (S above ~29,000), delta lives in the
// caller's global scratch behind the same barrier.  No path reaches that
// kernel.
//
// What bounds it on this card.  The function needs T S (4 + 1) + 4 S 4
// bytes (ll read, bp written, the weights, delta), and 4 T S operations;
// at the alignment shapes (S = 36, T = 186) that is 35 KB, ~10 ns.  But
// the frames are a dependent chain: a frame's critical path is the ll
// load from shared memory, the shuffle, then for the lane's first state an
// add, a compare, a select and an add (~70 cycles), and with more than one
// warp the boundary delta's store, the barrier and its load, so T of them,
// not bytes, bound one utterance, and a batch fills the card only with U
// blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kNoFit = -1;

// ---- S <= 1,024: lanes of J consecutive states ----------------------------------
constexpr int kLaneStates = 4;    // J's cap: more states an utterance take more warps
constexpr int kChunks = 4;        // the ll ring: kChunks - 1 chunks in flight
constexpr int kChunkFloats = 4096;   // about a chunk's size

// The mbarrier at bar expects `bytes` more (an arrival); then, when bytes
// > 0, the TMA bulk copy of them (a multiple of 16) from global src to
// shared dst (both 16-byte aligned), completing on it.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// A 4-byte cp.async from global src to shared dst.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// An arrival on the mbarrier at bar once this thread's cp.async copies are
// complete (noinc: counted in the mbarrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Whether the mbarrier at bar has completed the phase of this parity.
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Shared memory of a lane kernel, in floats: the ring's kChunks mbarriers,
// the warps' boundary deltas, kChunks slots of TC ll rows (each slot with
// room for the 16-byte-aligned superset of its rows and the last row's
// padded lanes), then a chunk's bp rows.
__host__ __device__ __forceinline__ int slot_floats(int TC, int S, int J, int W) {
  return (TC * S + 32 * J * W + 8 + 3) & ~3;
}

// grid U, an utterance a block of W warps (kMulti; else one warp), TC
// frames a chunk.  Warp w's lane j owns states s0 = (32 w + j) J .. s0 +
// J - 1.  Chunk c (frames c TC ..) is copied into slot c mod kChunks,
// issued kChunks - 1 chunks ahead by thread 0 (the bulk copy and the ragged
// ends' cp.async: two arrivals a phase), and every thread waits on the
// slot's mbarrier.  kWide: a lane's J bp bytes go out
// in one J-byte store (S a multiple of J), else byte by byte; a chunk's bp
// rows gather in shared memory, equal to their place in bp modulo 16, and
// go out in 16-byte stores.
template <int J, bool kWide, bool kMulti>
__global__ void __launch_bounds__(kMulti ? 1024 / J : 32)
banded_lane_kernel(const float* __restrict__ ll, const float* __restrict__ wself,
                   const float* __restrict__ wadv, long long wstride, uint8_t* __restrict__ bp,
                   float* __restrict__ delta_out, int T, int S, int TC) {
  extern __shared__ __align__(16) float sh[];
  const int W = kMulti ? blockDim.x / 32 : 1, slot = slot_floats(TC, S, J, W);
  float* bnd = sh + 2 * kChunks;                   // [2][W]: each warp's last delta, by frame parity
  float* ring = bnd + ((2 * W + 3) & ~3);
  uint8_t* bpbuf = reinterpret_cast<uint8_t*>(ring + kChunks * slot);
  const int u = blockIdx.x, lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int s0 = (32 * wp + lane) * J;
  const float* llu = ll + static_cast<size_t>(u) * T * S;
  uint8_t* bpu = bp + static_cast<size_t>(u) * T * S;
  const unsigned bars = static_cast<unsigned>(__cvta_generic_to_shared(sh));
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int nchunk = (T + TC - 1) / TC;
  const auto sync = [] {
    if constexpr (kMulti)
      __syncthreads();
    else
      __syncwarp();
  };
  // chunk c's rows [a, b) into slot c mod kChunks, byte g at slot + g -
  // (a rounded down to 16): the aligned interior [lo, hi) by one bulk copy,
  // the ragged ends a float at a time
  const auto issue = [&](int c) {
    if (threadIdx.x == 0 && c < nchunk) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(llu + static_cast<size_t>(c) * TC * S);
      const uintptr_t b = a + 4ull * min(TC, T - c * TC) * S;
      const uintptr_t a16 = a & ~uintptr_t{15}, lo = (a + 15) & ~uintptr_t{15};
      const uintptr_t hi = b & ~uintptr_t{15};
      const unsigned base = ring_s + 4u * (c % kChunks) * slot, bar = bars + 8u * (c % kChunks);
      const auto at = [&](uintptr_t g) { return base + static_cast<unsigned>(g - a16); };
      const bool bulk = hi > lo;
      for (uintptr_t g = a; g < (bulk ? lo : b); g += 4)
        cp_async4(at(g), reinterpret_cast<const void*>(g));
      for (uintptr_t g = bulk ? hi : b; g < b; g += 4)
        cp_async4(at(g), reinterpret_cast<const void*>(g));
      cp_async_arrive(bar);
      bulk_load(at(lo), reinterpret_cast<const void*>(lo), bulk ? static_cast<unsigned>(hi - lo) : 0u,
                bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kChunks; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(bars + 8u * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync();
  float d[J], ws[J], wa[J];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const bool own = s0 + i < S;
    ws[i] = own ? wself[u * wstride + s0 + i] : 0.0f;
    wa[i] = own ? wadv[u * wstride + s0 + i] : 0.0f;
    d[i] = 0.0f;
  }
  for (int c = 0; c < kChunks - 1; ++c) issue(c);
  for (int c = 0; c < nchunk; ++c) {
    issue(c + kChunks - 1);   // into the slot chunk c - 1 used
    while (!mbar_done(bars + 8u * (c % kChunks), (c / kChunks) & 1)) {
    }
    const int t0 = c * TC, nt = min(TC, T - t0);
    const float* rows = ring + (c % kChunks) * slot +
                        (reinterpret_cast<uintptr_t>(llu + static_cast<size_t>(t0) * S) & 15) / 4;
    uint8_t* bpg = bpu + static_cast<size_t>(t0) * S;
    uint8_t* bps = bpbuf + (reinterpret_cast<uintptr_t>(bpg) & 15);   // == bpg mod 16
    for (int tl = 0; tl < nt; ++tl) {
      const int t = t0 + tl;
      float l[J];   // frame t's ll
#pragma unroll
      for (int i = 0; i < J; ++i) l[i] = rows[tl * S + s0 + i];
      uint32_t pk = 0;   // the lane's bp bytes
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < J; ++i) d[i] = (s0 + i == 0 ? 0.0f : kNeg) + l[i];
      } else {
        float prev = __shfl_up_sync(0xffffffffu, d[J - 1], 1);
        if (kMulti && lane == 0 && wp > 0) prev = bnd[((t - 1) & 1) * W + wp - 1];
#pragma unroll
        for (int i = J - 1; i >= 0; --i) {   // high to low: d[i - 1] is still frame t - 1's
          const float stay = d[i] + ws[i];
          const float adv = (i > 0 ? d[i - 1] : prev) + wa[i];
          const bool took = adv > stay && (i > 0 || s0 > 0);   // state 0: no predecessor
          d[i] = (took ? adv : stay) + l[i];
          pk |= static_cast<uint32_t>(took) << (8 * i);
        }
      }
      uint8_t* out = bps + tl * S + s0;
      if constexpr (kWide && J == 4) {
        if (s0 < S) *reinterpret_cast<uint32_t*>(out) = pk;
      } else if constexpr (kWide && J == 2) {
        if (s0 < S) *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(pk);
      } else {
#pragma unroll
        for (int i = 0; i < J; ++i)
          if (s0 + i < S) out[i] = static_cast<uint8_t>(pk >> (8 * i));
      }
      if constexpr (kMulti) {
        if (lane == 31) bnd[(t & 1) * W + wp] = d[J - 1];
        __syncthreads();
      }
    }
    sync();
    // the chunk's bp rows out: bytes up to bpg's first 16-byte boundary,
    // 16-byte pieces, the rest
    const int nbytes = nt * S;
    const int to16 = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(bpg) & 15)) & 15);
    const int head = to16 < nbytes ? to16 : nbytes;
    if (static_cast<int>(threadIdx.x) < head) bpg[threadIdx.x] = bps[threadIdx.x];
    const int body = (nbytes - head) / 16;
    for (int i = threadIdx.x; i < body; i += blockDim.x)
      reinterpret_cast<uint4*>(bpg + head)[i] = reinterpret_cast<const uint4*>(bps + head)[i];
    const int tail = head + 16 * body + threadIdx.x;
    if (threadIdx.x < 16 && tail < nbytes) bpg[tail] = bps[tail];
    sync();   // the chunk's slot and bp rows are free
  }
#pragma unroll
  for (int i = 0; i < J; ++i)
    if (s0 + i < S) delta_out[static_cast<size_t>(u) * S + s0 + i] = d[i];
}

// ---- S > 1,024: a block strides over the states ---------------------------------
__global__ void __launch_bounds__(kMaxThreads)
banded_stride_kernel(const float* __restrict__ ll, const float* __restrict__ wself,
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
  for (int s = tid; s < S; s += bd) delta_out[static_cast<size_t>(u) * S + s] = cur[s];
}

int smem_optin(int* bytes) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// J states a lane (1, 2 or 4) and W warps; chunks of about kChunkFloats.
template <int J, bool kWide>
int launch_lanes(const float* ll, const float* ws, const float* wa, long long wstride,
                 uint8_t* bp, float* delta, int U, int T, int S, cudaStream_t stream) {
  const int W = (S + 32 * J - 1) / (32 * J);
  int TC = kChunkFloats / S;
  TC = TC < 1 ? 1 : TC > 64 ? 64 : TC;
  const size_t smem = 4ull * (2 * kChunks + ((2 * W + 3) & ~3) + kChunks * slot_floats(TC, S, J, W)) +
                      static_cast<size_t>(TC) * S + 16;
  const auto kernel = W > 1 ? banded_lane_kernel<J, kWide, true> : banded_lane_kernel<J, kWide, false>;
  const int rc = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (rc) return rc;
  kernel<<<U, 32 * W, smem, stream>>>(ll, ws, wa, wstride, bp, delta, T, S, TC);
  return static_cast<int>(cudaGetLastError());
}

template <int J>
int launch_lanes(const float* ll, const float* ws, const float* wa, long long wstride,
                 uint8_t* bp, float* delta, int U, int T, int S, cudaStream_t stream) {
  if constexpr (J > 1)   // J = 1: one byte a lane either way
    if (S % J == 0) return launch_lanes<J, true>(ll, ws, wa, wstride, bp, delta, U, T, S, stream);
  return launch_lanes<J, false>(ll, ws, wa, wstride, bp, delta, U, T, S, stream);
}

int launch_stride(const float* ll, const float* ws, const float* wa, long long wstride,
                  uint8_t* bp, float* delta, float* scratch, int U, int T, int S,
                  cudaStream_t stream) {
  const size_t smem = scratch ? 0 : 2 * static_cast<size_t>(S) * sizeof(float);
  const int rc = set_smem(reinterpret_cast<const void*>(banded_stride_kernel), smem);
  if (rc) return rc;
  banded_stride_kernel<<<U, kMaxThreads, smem, stream>>>(ll, ws, wa, wstride, bp, delta, scratch,
                                                         T, S);
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
  if (S <= kMaxThreads) {   // J states a lane: one warp up to 128 states, then warps of J = 4
    if (S <= 32) return launch_lanes<1>(ll, wself, wadv, wstride, b, delta, U, T, S, st);
    if (S <= 64) return launch_lanes<2>(ll, wself, wadv, wstride, b, delta, U, T, S, st);
    return launch_lanes<kLaneStates>(ll, wself, wadv, wstride, b, delta, U, T, S, st);
  }
  return launch_stride(ll, wself, wadv, wstride, b, delta, scratch, U, T, S, st);
}

}  // extern "C"
