// Token recombination + beam prune + top-K select for Hopper (sm_90a), the
// per-frame selection of the top-K token-passing decoders.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/select.py; the
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or kNoFit for a shape it does not take).
//
// Replaces dsr_tpu/ops/pallas/select.py:221 _select_kernel, both modes:
// 1-best (dsr_select_pass) and lattice (nlat > 0, :277-311;
// dsr_select_lattice).
//
// The function (per utterance u, over its n candidates (score, dst, arc)):
// order by (dst asc, score desc, arc asc); the first of each dst run keeps
// its score, the rest become NEG; keep val > max(val) - beam[u]; output the
// top kcap by (val desc, dst asc).  Slots whose score is not above NEG/2
// get dst 0 and arc -1.  That is the JAX decoders' sort path exactly
// (lax.sort on (dst, -score, arc), lax.top_k), and the plain twin
// recombine_topk_plain; the kernel only moves input values, so its output
// equals the twin's bit for bit.  The TPU kernel approximated the function
// (a per-lane presort into a bounded pool) and certified each frame with a
// spill flag; this kernel sorts every candidate, so nothing spills.
//
// Keys: a score enters the sort as an order-preserving uint32 (sign flip),
// with -0 mapped to +0, as lax.sort's comparator canonicalises it, so every
// finite float (NEG + NEG from padded arc slots too) orders as the sort
// orders it; the bit of a -0 rides beside the arc id so the output keeps
// the input's bits.  The first sort's key is (dst << 32 | ~score) with the
// arc id as tie-break; the second's is (~val << 32 | dst).
//
// What bounds it on this card: the function needs to read 12 bytes per
// candidate and write 12 per kept token, so bytes bound it (at 3.35 TB/s a
// frame of 8 x 12,032 candidates needs 0.35 us).  This first version is far
// from that: each block sorts its whole chunk twice with a bitonic network
// in shared memory (log2(n)(log2(n)+1)/2 compare-exchange stages, each
// ending in a barrier), and a frame of 8 utterances fills only 8 of the 132
// SMs.  The design answers the bound only in that every candidate is read
// from device memory once and every output written once: all sorting
// happens in shared memory.
//
// Layout: one block per (chunk of at most `chunk` candidates, utterance),
// 1024 threads; each launch is one pass, and the caller
// (dsr_tpu_torch/ops/cuda/select.py) chains the passes.  With one chunk
// (n <= 16,384; every pool of the split decoders and the dense monophone
// pool) one pass finishes the job.  A larger pool (the dense triphone one,
// 512 x 263 candidates) takes a first pass that writes each chunk's top
// kcap recombined candidates, without the beam, plus a flag that says
// whether the chunk held a duplicate dst (or had to drop recombined
// candidates); then, while the lists exceed one block, merge passes that run
// the same routine over groups of floor(16,384 / kcap) lists (the flags of
// a group OR-ed into its merged list's flag); then the final pass over the
// last lists.  That is exact: a dst whose best candidate misses its chunk's
// (or group's) top kcap is beaten by kcap distinct dsts with higher keys,
// so it cannot be in the utterance's top kcap; and the beam's max is the
// best candidate, which every list keeps.  The flags reproduce the NEG that
// recombined losers add to max(val); they are set conservatively on a
// dropped candidate, which matters only when every candidate lies below
// NEG and the beam exceeds ~1e22.  When kcap exceeds half a block, lists
// cannot shrink by merging: that case is one pass with one block per
// utterance whose sort buffers live in the caller's global scratch (13
// bytes per candidate, padded to a power of two) instead of shared memory.
//
// Lattice mode (the XLA path of topk_decoder.py:233-248): besides the
// 1-best slots, each kept slot k gets the top nlat incoming arcs of its
// state: the candidates at positions idx[k] + j (j < nlat) of the first
// sort's order, where idx[k] is the start of slot k's dst run, valid while
// they stay inside the run and the pool, the slot is alive, and their raw
// score beats the same threshold max(val) - beam; column 0 is the winner
// itself.  Invalid alternates are arc -1 and score NEG.  The second sort
// overwrites the first's order in place and the payload already holds the
// arc, so the kernel writes the dst-sorted (dst, score, arc) triples to a
// device scratch of the caller's (12 bytes per candidate) before re-keying,
// carries each slot's run-start position through the second sort in place
// of its arc, and gathers the arc and the alternates from the scratch.  A
// lattice pass is always one block per utterance (no partial lists: one
// dst's alternates may span chunks), its sort buffers in shared memory up
// to 16,384 candidates and in the global scratch above.  The 1-best and
// lattice modes are two instantiations of one kernel; the 1-best one
// compiles none of the lattice code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 1024;
constexpr int kMaxChunk = 16384;      // 13 bytes each in shared memory: 208 KB
constexpr int kNoFit = -1;
constexpr uint64_t kNoKey = ~0ull;    // padding and dropped slots sort last
constexpr uint32_t kNoPay = ~0u;

__device__ __forceinline__ uint32_t ordered(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;  // -0 ties +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t u, uint32_t negzero) {
  if (negzero) return -0.0f;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ uint32_t negzero(float x) {
  return __float_as_uint(x) == 0x80000000u ? 1u : 0u;
}

// Ascending bitonic sort of (key, pay) pairs, n a power of two.
__device__ void bitonic(uint64_t* key, uint32_t* pay, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const int l = i + j;
        const uint64_t ki = key[i], kl = key[l];
        const uint32_t pi = pay[i], pl = pay[l];
        const bool greater = ki > kl || (ki == kl && pi > pl);
        if (greater == ((i & k) == 0)) {
          key[i] = kl;
          key[l] = ki;
          pay[i] = pl;
          pay[l] = pi;
        }
      }
      __syncthreads();
    }
  }
}

// The lattice mode's buffers: the dst-sorted triples (U, cap) and the
// alternates' output (U, kcap, nlat).
struct LatArgs {
  int nlat;
  int* d;
  float* s;
  int* a;
  float* alt_s;
  int* alt_a;
};

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// partial: write the chunk's top kcap recombined candidates (dst -1 marks an
// empty slot) and its flag; otherwise beam-prune and write the final slots.
// dup_in (a pass over earlier lists): n_dup flags per utterance, of which
// block c takes [c * group, (c + 1) * group).  gscratch: the sort buffers
// in device memory (13 * cap bytes per block) instead of shared memory.
// kLat: the lattice mode (one block per utterance, never partial).
template <bool kLat>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ score, const int* __restrict__ dst,
              const int* __restrict__ arc, const float* __restrict__ beam,
              const int* __restrict__ dup_in, int n_dup, int group, int n, int chunk,
              int cap, int kcap, int partial, float* __restrict__ out_s,
              int* __restrict__ out_d, int* __restrict__ out_a, int* __restrict__ dup_out,
              unsigned char* __restrict__ gscratch, LatArgs lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, u = blockIdx.y, nchunks = gridDim.x;
  unsigned char* buf = gscratch ? gscratch + 13 * static_cast<size_t>(cap) *
                                                 (static_cast<size_t>(u) * nchunks + c)
                                : smem;
  uint64_t* key = reinterpret_cast<uint64_t*>(buf);
  uint32_t* pay = reinterpret_cast<uint32_t*>(buf + 8 * static_cast<size_t>(cap));
  unsigned char* flag = buf + 12 * static_cast<size_t>(cap);
  float* red = reinterpret_cast<float*>(gscratch ? smem : smem + 13 * static_cast<size_t>(cap));

  const int lo = c * chunk;
  const int m = min(n - lo, chunk);
  int np2 = 32;
  while (np2 < m) np2 <<= 1;
  const size_t row = static_cast<size_t>(u) * n + lo;
  const size_t lrow = static_cast<size_t>(u) * cap;   // lattice scratch row

  // load; a dst of -1 is an empty slot of a first pass's list
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    uint64_t k = kNoKey;
    uint32_t p = kNoPay;
    if (i < m) {
      const int d = dst[row + i];
      if (d != -1) {
        const float s = score[row + i];
        k = (static_cast<uint64_t>(static_cast<uint32_t>(d)) << 32) | ~ordered(s);
        p = (static_cast<uint32_t>(arc[row + i]) << 1) | negzero(s);
      }
    }
    key[i] = k;
    pay[i] = p;
  }
  __syncthreads();
  bitonic(key, pay, np2);   // by (dst, score desc, arc)

  // mark each run's first; max over val = first ? score : NEG
  float vmax = -INFINITY;
  int dup = 0;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    const uint64_t k = key[i];
    const bool valid = k != kNoKey;
    const bool first = valid && (i == 0 || (k >> 32) != (key[i - 1] >> 32));
    flag[i] = first ? 1 : 0;
    if (valid) vmax = fmaxf(vmax, first ? unordered(~static_cast<uint32_t>(k), pay[i] & 1u) : kNeg);
    dup |= valid && !first;
    if constexpr (kLat) {   // the first sort's order, kept for the alternates
      lat.d[lrow + i] = valid ? static_cast<int>(k >> 32) : -1;
      lat.s[lrow + i] = valid ? unordered(~static_cast<uint32_t>(k), pay[i] & 1u) : kNeg;
      lat.a[lrow + i] = valid ? static_cast<int>(pay[i] >> 1) : -1;
    }
  }
  if (dup_in != nullptr && threadIdx.x == 0)
    for (int j = c * group; j < min(n_dup, (c + 1) * group); ++j)
      dup |= dup_in[static_cast<size_t>(u) * n_dup + j] != 0;
  dup = __syncthreads_or(dup);
  float thr = 0.0f;
  if (!partial) {
    float mx = block_max(vmax, red);
    if (dup) mx = fmaxf(mx, kNeg);
    thr = mx - beam[u];
  }

  // re-key in place for the second sort: (val desc, dst asc)
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    const uint64_t k = key[i];
    if (k == kNoKey) continue;
    const uint32_t d = static_cast<uint32_t>(k >> 32);
    const uint32_t a = pay[i] >> 1;
    const float s = unordered(~static_cast<uint32_t>(k), pay[i] & 1u);
    uint64_t k2 = kNoKey;
    uint32_t p2 = kNoPay;
    if (partial) {
      if (flag[i]) {
        k2 = (static_cast<uint64_t>(~ordered(s)) << 32) | d;
        p2 = (a << 1) | negzero(s);
      }
    } else {
      float v = flag[i] ? s : kNeg;
      if (!(v > thr)) v = kNeg;
      k2 = (static_cast<uint64_t>(~ordered(v)) << 32) | d;
      // the lattice mode carries the run start's position instead of the arc
      p2 = ((kLat ? static_cast<uint32_t>(i) : a) << 1) | negzero(v);
    }
    key[i] = k2;
    pay[i] = p2;
  }
  __syncthreads();
  bitonic(key, pay, np2);

  const size_t orow = partial ? (static_cast<size_t>(u) * nchunks + c) * kcap
                              : static_cast<size_t>(u) * kcap;
  for (int j = threadIdx.x; j < kcap; j += blockDim.x) {
    const uint64_t k = j < np2 ? key[j] : kNoKey;
    float s = kNeg;
    int d = partial ? -1 : 0, a = -1;
    if (k != kNoKey) {
      s = unordered(static_cast<uint32_t>(~(k >> 32)), pay[j] & 1u);
      if (partial || s > kNeg / 2) {
        d = static_cast<int>(static_cast<uint32_t>(k));
        a = kLat ? lat.a[lrow + (pay[j] >> 1)] : static_cast<int>(pay[j] >> 1);
      }
    }
    out_s[orow + j] = s;
    out_d[orow + j] = d;
    out_a[orow + j] = a;
  }
  if (partial && threadIdx.x == 0)
    dup_out[u * nchunks + c] = dup || (kcap < np2 && key[kcap] != kNoKey);
  if constexpr (kLat) {
    // alternate jj of slot j: position pos + jj of the first sort's order
    const int nlat = lat.nlat;
    const size_t arow = static_cast<size_t>(u) * kcap * nlat;
    for (int e = threadIdx.x; e < kcap * nlat; e += blockDim.x) {
      const int j = e / nlat;
      const int jj = e - j * nlat;
      const uint64_t k = j < np2 ? key[j] : kNoKey;
      float as = kNeg;
      int aa = -1;
      if (k != kNoKey &&
          unordered(static_cast<uint32_t>(~(k >> 32)), pay[j] & 1u) > kNeg / 2) {
        const int pos = static_cast<int>(pay[j] >> 1);
        if (static_cast<long long>(pos) + jj < m && lat.d[lrow + pos + jj] == lat.d[lrow + pos]) {
          const float v = lat.s[lrow + pos + jj];
          if (v > thr) {
            as = v;
            aa = lat.a[lrow + pos + jj];
          }
        }
      }
      lat.alt_s[arow + e] = as;
      lat.alt_a[arow + e] = aa;
    }
  }
}

size_t smem_bytes(int cap) { return 13 * static_cast<size_t>(cap) + 33 * sizeof(float); }

int cap_of(int len) {
  int c = 32;
  while (c < len) c <<= 1;
  return c;
}

// Let the kernel's instantiation take a whole chunk's shared memory (once).
template <bool kLat>
int allow_smem() {
  static bool done = false;
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(select_kernel<kLat>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(kMaxChunk)));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// One pass over score (U, n) f32, dst and arc (U, n) i32 (dst -1: an empty
// slot of an earlier pass's list), beam (U,) f32, in ceil(n / chunk)
// blocks per utterance.  partial: writes each block's list to out_s/out_d/
// out_a (U, blocks * kcap) and its flag to dup_out (U, blocks); otherwise
// (one block per utterance) the final slots (U, kcap).  dup_in: the n_dup
// flags per utterance of the input lists, `group` lists per block, or null.
// gscratch: null when a block's candidates fit shared memory (chunk <=
// 16,384), else 13 * pow2(chunk) bytes per block of device memory.
int dsr_select_pass(const float* score, const int* dst, const int* arc, const float* beam,
                    const int* dup_in, int n_dup, int group, int U, int n, int chunk, int kcap,
                    int partial, float* out_s, int* out_d, int* out_a, int* dup_out,
                    void* gscratch, void* stream) {
  if (U < 1 || n < 1 || kcap < 1 || chunk < 1) return kNoFit;
  const int blocks = (n + chunk - 1) / chunk;
  if ((!partial && blocks != 1) || (gscratch == nullptr && chunk > kMaxChunk)) return kNoFit;
  const int rc = allow_smem<false>();
  if (rc) return rc;
  const int cap = cap_of(n < chunk ? n : chunk);
  const size_t smem = gscratch ? smem_bytes(0) : smem_bytes(cap);
  select_kernel<false><<<dim3(blocks, U), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      score, dst, arc, beam, dup_in, n_dup, group, n, chunk, cap, kcap, partial, out_s, out_d,
      out_a, dup_out, static_cast<unsigned char*>(gscratch), LatArgs{});
  return static_cast<int>(cudaGetLastError());
}

// The lattice mode over score (U, n) f32, dst and arc (U, n) i32, beam (U,)
// f32, one block per utterance: the 1-best slots to out_s/out_d/out_a (U,
// kcap) as dsr_select_pass writes them, the alternates to alt_s/alt_a (U,
// kcap, nlat).  lscratch: 12 * pow2(n) bytes per utterance (the dst-sorted
// triples); gscratch: null for n <= 16,384, else 13 * pow2(n) bytes per
// utterance (the sort buffers).
int dsr_select_lattice(const float* score, const int* dst, const int* arc, const float* beam,
                       int U, int n, int kcap, int nlat, float* out_s, int* out_d, int* out_a,
                       float* alt_s, int* alt_a, void* lscratch, void* gscratch, void* stream) {
  if (U < 1 || n < 1 || kcap < 1 || nlat < 1 || lscratch == nullptr ||
      (gscratch == nullptr && n > kMaxChunk))
    return kNoFit;
  const int rc = allow_smem<true>();
  if (rc) return rc;
  const int cap = cap_of(n);
  const size_t plane = static_cast<size_t>(U) * cap;
  int* ld = static_cast<int*>(lscratch);
  const LatArgs lat{nlat, ld, reinterpret_cast<float*>(ld + plane), ld + 2 * plane, alt_s, alt_a};
  const size_t smem = gscratch ? smem_bytes(0) : smem_bytes(cap);
  select_kernel<true><<<dim3(1, U), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      score, dst, arc, beam, nullptr, 0, 0, n, n, cap, kcap, 0, out_s, out_d, out_a, nullptr,
      static_cast<unsigned char*>(gscratch), lat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
