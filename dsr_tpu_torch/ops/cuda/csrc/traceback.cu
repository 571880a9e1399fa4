// The traceback of the top-K token-passing decoders for Hopper (sm_90a): the
// (T, U, K) token tables walked back from each utterance's best final token,
// for U utterances in one launch.  Plain C interface, loaded with ctypes by
// dsr_tpu_torch/ops/cuda/traceback.py; the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// kNoFit for a shape it does not take).
//
// Replaces no Pallas kernel: the JAX decoders walk back in XLA
// (dsr_tpu/asr/decoder/topk_decoder.py:335 _traceback_impl, a lax.scan that
// reads one row of K states and one arc a step; split_decoder.py:229, the
// same through src_of_row).  This kernel walks on the card, and only the (U,
// T) arc ids and the (U,) scores leave it.
//
// The function, per utterance u (the plain twin traceback_plain):
//  0. the best final token: the first slot k of the largest scores_f[u, k] +
//     final_f[u, k]; when no sum is above NEG/2 (no token reached a final
//     state), the first slot of the largest scores_f[u, k] instead.  Its
//     value is best[u] and its state, states_f[u, k], starts the walk;
//  1. for t = T - 1 down to 0, while t < L = lengths[u] (clamped to [0, T]):
//     the first slot k with tok_states[t, u, k] == state (slot 0 if none)
//     gives arc = tok_arcs[t, u, k]; when arc >= 0, arcs[u, t] = arc and the
//     state becomes arc / a_div, or src_of_row[arc / a_div] when the table
//     is given; otherwise arcs[u, t] = -1 and the state stays.  Frames t >= L
//     are -1.
// Only int32 compares and one float32 addition a slot (no product, so no
// fused multiply-add), so the outputs equal the twin's bit for bit.
//
// Design.  The walk is a chain of L dependent steps, each a search of one
// K-slot row for the current state, but the rows themselves do not depend
// on the walk.  One warp walks one utterance, up to 8 warps a block (fewer
// when U is small, so that the warps spread over the SMs).  Each warp keeps
// a ring of D frames in shared memory (D up to 8, as many as the block's
// shared memory holds): step i reads frame L - 1 - i from slot i mod D, and
// its state and arc rows are copied there D - 1 steps ahead, completing on
// the slot's mbarrier by every lane's 4-byte cp.async copies, so the chain
// touches only shared memory; any K and any alignment take the same path.
// The slot search loads 4 groups of 32 slots (slot 32 j + lane) before it
// tests them; the lowest bit of the first nonzero ballot is the first
// match.  Step 0 is a warp argmax over the final carry while the first
// frames' copies fly.  Frames at or past the length are never read.
//
// What bounds it on this card.  The function needs each walked frame's
// state row and one arc, one word out a frame and the final carry: at most
// U T (4 K + 8) + 12 U K bytes, 0.86 GB at U = 1,024, T = 818, K = 256
// (0.26 ms at 3.35 TB/s), less where utterances end early (0.53 GB, 0.16
// ms, at the v2k cells' lengths).  The kernel reads each walked frame's
// whole arc row as well (twice the bound's bytes) so that no step waits on
// a load from device memory.  What bounds it is the chain: the longest
// utterance's L steps, one after the other, each ~1,000 cycles of
// dependent work (the issue of a later frame's copies, the mbarrier test,
// the search pass, the arc and its division), ~0.4 ms at L = 818 whatever
// U is: the ring's depth (8, 16 or 32 frames) does not move it.

#include <cuda_runtime.h>

namespace {

constexpr float kHalfNeg = -5e29f;      // NEG / 2: a sum above it reached a final state
constexpr int kNoFit = -1;
constexpr int kMaxWarps = 8;            // utterances a block
constexpr int kMaxStages = 8;           // frames in a warp's ring
constexpr int kBarBytes = 8 * kMaxStages;   // a warp's mbarriers, before its ring
constexpr int kGroups = 4;              // 32-slot groups a search pass loads before testing
constexpr unsigned kFull = 0xffffffffu;

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

// (v, k) becomes (v2, k2) when that is larger, or equal at a smaller slot.
__device__ __forceinline__ void take_better(float& v, int& k, float v2, int k2) {
  if (v2 > v || (v2 == v && k2 < k)) {
    v = v2;
    k = k2;
  }
}

// Every lane ends with the warp's largest (v, k), the smallest k on ties.
__device__ __forceinline__ void warp_argmax(float& v, int& k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int k2 = __shfl_xor_sync(kFull, k, o);
    take_better(v, k, v2, k2);
  }
}

// grid ceil(U / W), W warps a block, warp w of block b walks utterance b W +
// w.  Shared memory, a warp's part after the other's: kBarBytes of
// mbarriers (D used), then D slots of a frame's state row and arc row, each
// row Kp = K rounded up to 4 ints.  Every lane copies its share of a
// frame's two rows 4 bytes at a time by cp.async.
__global__ void __launch_bounds__(32 * kMaxWarps)
traceback_kernel(const int* __restrict__ tok_states, const int* __restrict__ tok_arcs,
                 const int* __restrict__ states_f, const float* __restrict__ scores_f,
                 const float* __restrict__ final_f, const int* __restrict__ lengths, int a_div,
                 const int* __restrict__ src_of_row, int* __restrict__ arcs_out,
                 float* __restrict__ best_out, int U, int T, int K, int D) {
  extern __shared__ __align__(16) unsigned char sh[];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int u = blockIdx.x * (blockDim.x / 32) + w;
  if (u >= U) return;   // a whole warp: the block has no barrier
  const int Kp = (K + 3) & ~3;
  unsigned char* mine = sh + static_cast<size_t>(w) * (kBarBytes + 8ull * D * Kp);
  const int* ring = reinterpret_cast<const int*>(mine + kBarBytes);
  const unsigned bars = static_cast<unsigned>(__cvta_generic_to_shared(mine));
  const unsigned ring_s = bars + kBarBytes;
  const int len = lengths[u];
  const int L = len < 0 ? 0 : len < T ? len : T;
  const size_t frame = static_cast<size_t>(U) * K;   // a frame's stride in the tables
  const int* st = tok_states + static_cast<size_t>(u) * K;
  const int* ar = tok_arcs + static_cast<size_t>(u) * K;
  int* out = arcs_out + static_cast<size_t>(u) * T;

  if (lane == 0) {
    for (int i = 0; i < D; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bars + 8u * i),
                   "r"(32)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // step i's frame, L - 1 - i, into `slot` (i mod D), completing on the
  // slot's mbarrier: every lane's share and its arrival (32 a phase)
  const auto issue = [&](int i, int slot) {
    if (i >= L) return;
    const size_t t = static_cast<size_t>(L - 1 - i);
    const int* gs = st + t * frame;
    const int* ga = ar + t * frame;
    const unsigned ds = ring_s + 8u * slot * Kp, da = ds + 4u * Kp, bar = bars + 8u * slot;
    for (int k = lane; k < K; k += 32) {
      cp_async4(ds + 4u * k, gs + k);
      cp_async4(da + 4u * k, ga + k);
    }
    cp_async_arrive(bar);
  };
  for (int i = 0; i < D - 1; ++i) issue(i, i);

  // step 0: the best final token, with and without the final weights
  const float neg_inf = -__int_as_float(0x7f800000);
  float vt = neg_inf, vs = neg_inf;
  int kt = 0x7fffffff, ks = 0x7fffffff;
  const size_t fo = static_cast<size_t>(u) * K;
  for (int k = lane; k < K; k += 32) {
    const float s = scores_f[fo + k];
    take_better(vt, kt, s + final_f[fo + k], k);
    take_better(vs, ks, s, k);
  }
  warp_argmax(vt, kt);
  warp_argmax(vs, ks);
  const bool dead = !(vt > kHalfNeg);
  int state = states_f[fo + (dead ? ks : kt)];
  if (lane == 0) best_out[u] = dead ? vs : vt;
  for (int t = L + lane; t < T; t += 32) out[t] = -1;

  // step i reads slot s = i mod D at phase parity (i / D) mod 2, kept as
  // counters: dividing by the runtime D costs ~20 % of a step
  int s = 0, fill = D - 1;
  unsigned parity = 0;
  for (int i = 0; i < L; ++i) {
    issue(i + D - 1, fill);   // into the slot step i - 1 read
    fill = fill + 1 == D ? 0 : fill + 1;
    while (!mbar_done(bars + 8u * s, parity)) {
    }
    const int* rs = ring + 2 * s * Kp;
    int slot = 0;
    for (int j = 0; j < K; j += 32 * kGroups) {
      unsigned m[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int k = j + 32 * g + lane;
        m[g] = __ballot_sync(kFull, k < K && rs[k] == state);
      }
      int hit = -1;
#pragma unroll
      for (int g = kGroups - 1; g >= 0; --g)
        if (m[g]) hit = j + 32 * g + __ffs(m[g]) - 1;
      if (hit >= 0) {
        slot = hit;
        break;
      }
    }
    const int arc = rs[Kp + slot];
    if (lane == 0) out[L - 1 - i] = arc >= 0 ? arc : -1;
    if (arc >= 0) {
      const int row = arc / a_div;
      state = src_of_row != nullptr ? src_of_row[row] : row;
    }
    __syncwarp();   // slot s is free: step i + 1 refills it with step i + D's frame
    if (++s == D) {
      s = 0;
      parity ^= 1u;
    }
  }
}

int device_limits(int* optin, int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// W warps a block (U spread over the SMs, at most kMaxWarps) and D frames a
// ring (as many as the shared-memory opt-in holds, at most kMaxStages; W
// shrinks until D >= 2, and D = 1 only at W = 1), and the block's bytes.
int plan(int U, int K, int* W, int* D, size_t* smem) {
  int optin, sms;
  const int rc = device_limits(&optin, &sms);
  if (rc) return rc;
  const long long frame = 8ll * ((K + 3) & ~3);
  int w = (U + sms - 1) / sms;
  w = w < 1 ? 1 : w > kMaxWarps ? kMaxWarps : w;
  long long d = (optin / w - kBarBytes) / frame;
  while (d < 2 && w > 1) {
    --w;
    d = (optin / w - kBarBytes) / frame;
  }
  if (d < 1) return kNoFit;
  *W = w;
  *D = static_cast<int>(d < kMaxStages ? d : kMaxStages);
  *smem = static_cast<size_t>(w) * (kBarBytes + *D * frame);
  return 0;
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// tok_states, tok_arcs (T, U, K) int32; states_f (U, K) int32; scores_f,
// final_f (U, K) f32; lengths (U,) int32; src_of_row int32 or null; arcs
// (U, T) int32 and best (U,) f32 out.
int dsr_traceback(const int* tok_states, const int* tok_arcs, const int* states_f,
                  const float* scores_f, const float* final_f, const int* lengths, int a_div,
                  const int* src_of_row, int* arcs, float* best, int U, int T, int K,
                  void* stream) {
  if (U < 1 || T < 0 || K < 1 || a_div < 1) return kNoFit;
  int W, D;
  size_t smem;
  int rc = plan(U, K, &W, &D, &smem);
  if (rc) return rc;
  rc = set_smem(reinterpret_cast<const void*>(traceback_kernel), smem);
  if (rc) return rc;
  traceback_kernel<<<(U + W - 1) / W, 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
      tok_states, tok_arcs, states_f, scores_f, final_f, lengths, a_div, src_of_row, arcs, best,
      U, T, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
