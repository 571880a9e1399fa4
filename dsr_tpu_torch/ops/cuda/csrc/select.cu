// Token recombination + beam prune + top-K select for Hopper (sm_90a), the
// per-frame selection of the top-K token-passing decoders.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/select.py; the
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or kNoFit for a shape it does not take).
//
// Replaces dsr_tpu/ops/pallas/select.py:221 _select_kernel, both modes:
// 1-best and lattice (nlat > 0, :277-311); one kernel, two instantiations.
//
// The function (per utterance u, over its n candidates (score, dst, arc)):
// order by (dst asc, score desc, arc asc); the first of each dst run keeps
// its score, the rest become NEG; keep val > max(val) - beam[u]; output the
// top kcap by (val desc, dst asc).  Slots whose score is not above NEG/2
// get dst 0 and arc -1.  That is the JAX decoders' sort path exactly
// (lax.sort on (dst, -score, arc), lax.top_k), and the plain twin
// recombine_topk_plain; the kernel only moves input values, so its output
// equals the twin's bit for bit.  (Candidates that tie on dst, score and
// arc while one score is -0 and the other +0 are outside that promise: the
// twin keeps the first by position, the kernel the +0.)  The TPU kernel
// approximated the function and certified each frame with a spill flag;
// this one is exact, so nothing spills.
//
// Keys: a score enters as an order-preserving uint32 (sign flip) with -0
// mapped to +0, as the sort's comparator treats them; the bit of a -0 rides
// beside the arc id so the output keeps the input's bits.
//
// The design sorts nothing but the winners:
//  1. Recombination by destination: every candidate goes into a hash table
//     keyed by dst (linear probing); atomicMin on the 64-bit word
//     (~ordered(score) << 32 | arc << 1 | negzero) leaves the candidate
//     that the first sort would put first in its run.  A candidate that
//     finds its dst already claimed sets the duplicate flag, which adds
//     the losers' NEG to max(val); the best score of all is max(val)'s
//     other part (the best candidate wins its dst).
//  2. Each winner gets the second sort's key (~ordered(v) << 32 | dst), v
//     its score if it beats thr = max - beam, else NEG.  The n - (distinct
//     dsts) losers are NEG slots too.  Every NEG slot writes the same
//     (NEG, 0, -1), so only their count matters: the output is the live
//     keys (v above NEG) in order, then NEG slots, then the kept values
//     below NEG (beams above ~1e30), each part cut at kcap.  The top of a
//     part is found by radix select: histogram passes over 8-bit digits,
//     high bits first, each inside the previous pass's boundary bucket
//     (warp-aggregated shared-memory atomics), until the keys below and in
//     the boundary bucket fit the sort buffer; those are sorted by a
//     bitonic network (at most 2 * kcap entries at the decoders' pools)
//     and the first ones written.
//  3. Lattice mode: the alternates of slot k are the top nlat candidates of
//     dst(k) above thr, in (score desc, arc asc) order: the twin takes the
//     first nlat positions of dst(k)'s run while their score beats thr,
//     and the run is sorted by score, so the test is a prefix of it.  The
//     kernel maps the live dsts to their slots in the table, counts each
//     live dst's candidates above thr (one pass over the pool), takes
//     offsets, scatters the candidates into per-slot buckets (a second
//     pass), and ranks each bucket: a warp ranks a bucket of up to 128 in
//     registers; a larger one goes through the block's radix select.
//
// What bounds it on this card: the function needs to read 12 bytes per
// candidate and write 12 per kept token (more in lattice mode), so bytes
// bound it (at 3.35 TB/s a frame of 8 x 12,032 candidates needs 0.35 us).
// The kernel reads every candidate once (lattice mode: three times, the
// last two from L1/L2) and sorts only the winners near the top; what is
// left above the bound is latency: the inserts' atomics, a few histogram
// passes and one bitonic sort of ~2 kcap entries, each phase ending in a
// barrier.
//
// Layout: the table has pow2 >= 4n/3 entries (12 bytes each: the word,
// then the key, and the dst, then the payload and the slot), the sort
// buffer pow2 >= 2 max(kcap, nlat, 128) (12 bytes each).  When both fit
// shared memory (n up to 12,288 at kcap 1,024: the decoders' monophone
// pools) the whole select is one block of 1024 threads per utterance, one
// launch, no barrier across blocks.  A larger pool ("compact mode") keeps
// the table in the caller's device scratch (it stays in the 50 MB L2 at
// the decoders' triphone pools): two memsets clear it, insert_kernel
// (several blocks per utterance, about two blocks an SM over the frame)
// recombines, keys_kernel (the same grid) keys the winners and lists the
// live and below-NEG ones, and the one block per utterance selects over
// that list; a sort buffer beyond shared memory goes to the scratch too.
// The lattice mode's per-slot counts, offsets and buckets (8 bytes a
// candidate) are always in the scratch; its passes over the candidates
// keep four candidates a thread in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr float kNeg = -1e30f;
constexpr int kThreads = 1024;
constexpr int kBins = 256;             // 8-bit digits
constexpr int kWarpBucket = 128;       // a bucket a warp ranks in registers (4 keys a lane)
constexpr int kStaticSmem = 4096;      // static shared memory, kept out of the dynamic budget
constexpr int kNoFit = -1;
constexpr int kEmpty = -1;             // an empty table entry's dst
constexpr u64 kNoKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

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

// A key's value: the high word is ~ordered(v).
__device__ __forceinline__ float key_value(u64 key, uint32_t nz) {
  return unordered(~static_cast<uint32_t>(key >> 32), nz);
}

template <class T>
__device__ __forceinline__ T volatile_load(T* p) {
  return *const_cast<volatile T*>(p);
}

__device__ __forceinline__ uint32_t hash_of(int d, int bits) {
  return (static_cast<uint32_t>(d) * 2654435761u) >> (32 - bits);
}

struct Shared {
  int hist[kBins];
  float red_f[32];
  int red_i[32];
  int count_lt, n_match, digit, cnt;
};

__device__ float block_max(float v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh.red_f[0];
  for (int w = 1; w < kThreads / 32; ++w) v = fmaxf(v, sh.red_f[w]);
  __syncthreads();
  return v;
}

__device__ int block_sum(int v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) sh.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kThreads / 32; ++w) v += sh.red_i[w];
  __syncthreads();
  return v;
}

// Exclusive scan of a[0, n) into off[0, n], off[n] the total (global
// memory, one block): each thread sums a contiguous run, the runs' sums are
// scanned across the block.
__device__ void block_scan(const int* a, int* off, int n, Shared& sh) {
  const int tid = threadIdx.x, run = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * run), hi = min(n, lo + run);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int lane = tid & 31, warp = tid >> 5;
  int incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sh.red_i[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += sh.red_i[w];
  int acc = base + incl - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    off[i] = acc;
    acc += v;
  }
  if (tid == kThreads - 1) off[n] = acc;
  __syncthreads();
}

// Ascending bitonic sort of (key, pay) pairs, n a power of two >= 32.  Up
// to a block's threads, each thread holds one entry and the stages whose
// partner is in its warp (distance below 32) run on shuffles, so only the
// longer-distance stages end in a barrier; larger n takes every stage
// through the buffer.
__device__ void bitonic(u64* key, uint32_t* pay, int n) {
  const int t = threadIdx.x;
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j >= (n <= kThreads ? 32 : 1); j >>= 1) {
      for (int e = t; e < (n >> 1); e += blockDim.x) {
        const int i = 2 * e - (e & (j - 1));
        const int l = i + j;
        const u64 ki = key[i], kl = key[l];
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
    if (j > 0) {   // n <= kThreads: the distances below 32, in registers
      if (t < n) {
        u64 kk = key[t];
        uint32_t pp = pay[t];
        for (; j > 0; j >>= 1) {
          const u64 ko = __shfl_xor_sync(kFull, kk, j);
          const uint32_t po = __shfl_xor_sync(kFull, pp, j);
          const bool self_less = kk < ko || (kk == ko && pp < po);
          const bool want_min = ((t & j) == 0) == ((t & k) == 0);
          if (want_min != self_less) {
            kk = ko;
            pp = po;
          }
        }
        key[t] = kk;
        pay[t] = pp;
      }
      __syncthreads();
    }
  }
}

// The sort buffer: sb entries (a power of two).
struct SortBuf {
  u64* key;
  uint32_t* pay;
  int sb;
};

// The k <= total smallest keys in [lo, hi) of src[0, n) (total of them),
// ascending, handed to sink(j, key, index into src) for j < k.  Radix
// select: while the keys below the boundary bucket and in it exceed the
// sort buffer, a histogram pass over the next 8-bit digit of the keys in
// the boundary bucket narrows it.  Then those keys are sorted and the first
// k written.  Equal keys may fill the last places (only once all 64 bits
// are resolved); the sink then gets the key with index ~0.  Every thread
// calls it; it ends with a barrier.
template <class Sink>
__device__ void top_sorted(const u64* src, int n, u64 lo, u64 hi, int total, int k,
                           const SortBuf& buf, Shared& sh, Sink sink) {
  if (k <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31;
  u64 prefix = 0;
  int shift = 64, count_lt = 0, n_match = total;
  while (count_lt + n_match > buf.sb && shift > 0) {
    const u64 above = shift >= 64 ? 0ull : (~0ull << shift);   // resolved bits
    shift -= 8;
    for (int i = tid; i < kBins; i += kThreads) sh.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      const u64 key = i < n ? src[i] : kNoKey;
      const bool ok = i < n && key >= lo && key < hi && (key & above) == prefix;
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) {
        const unsigned dig = static_cast<unsigned>(key >> shift) & (kBins - 1);
        const unsigned peers = __match_any_sync(m, dig);
        if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[dig], __popc(peers));
      }
    }
    __syncthreads();
    if (tid < 32) {   // the digit at which the count reaches k
      constexpr int per = kBins / 32;
      int c[per], s = 0;
#pragma unroll
      for (int q = 0; q < per; ++q) {
        c[q] = sh.hist[per * lane + q];
        s += c[q];
      }
      int incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int need = k - count_lt;
      int run = incl - s;
      if (run < need && need <= incl) {
#pragma unroll
        for (int q = 0; q < per; ++q) {
          if (run < need && need <= run + c[q]) {
            sh.count_lt = count_lt + run;
            sh.n_match = c[q];
            sh.digit = per * lane + q;
          }
          run += c[q];
        }
      }
    }
    __syncthreads();
    count_lt = sh.count_lt;
    n_match = sh.n_match;
    prefix |= static_cast<u64>(sh.digit) << shift;
  }
  // collect the keys below the boundary bucket and (unless only equal keys
  // remain beyond the buffer) in it
  const bool fill = count_lt + n_match > buf.sb;
  const u64 rmask = shift >= 64 ? 0ull : (~0ull << shift);
  if (tid == 0) sh.cnt = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const u64 key = i < n ? src[i] : kNoKey;
    const u64 top = key & rmask;
    const bool ok = i < n && key >= lo && key < hi && (top < prefix || (!fill && top == prefix));
    const unsigned m = __ballot_sync(kFull, ok);
    if (m) {
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&sh.cnt, __popc(m));
      at = __shfl_sync(kFull, at, leader) + __popc(m & ((1u << lane) - 1));
      if (ok) {
        buf.key[at] = key;
        buf.pay[at] = static_cast<uint32_t>(i);
      }
    }
  }
  __syncthreads();
  const int c = sh.cnt;
  int np2 = 32;
  while (np2 < c) np2 <<= 1;
  for (int i = c + tid; i < np2; i += kThreads) {
    buf.key[i] = kNoKey;
    buf.pay[i] = ~0u;
  }
  __syncthreads();
  bitonic(buf.key, buf.pay, np2);
  for (int j = tid; j < k; j += kThreads) {
    if (j < c)
      sink(j, buf.key[j], buf.pay[j]);
    else
      sink(j, prefix, ~0u);
  }
  __syncthreads();
}

// The lattice mode's outputs and scratch (per utterance, by block).
struct LatArgs {
  int nlat;
  float* alt_s;   // (U, kcap, nlat)
  int* alt_a;
  int* cnt;       // (U, kcap): per-slot counts, then cursors, then the large buckets' slots
  int* off;       // (U, kcap + 1): table index of a live slot, then bucket offsets
  u64* bucket;    // (U, n)
};

// Where the arrays are: the table (2^bits entries) and the sort buffer (sb
// entries) in shared memory or in the device scratch; in the scratch, the
// arrays of all utterances one after the other, at these byte offsets.
// compact: the table is in the scratch, filled by insert_kernel and
// keyed by keys_kernel, which also lists the live and below-NEG keys in the
// compact arrays (key, table index, payload) and clears the table's values.
struct Geometry {
  int bits, sb, table_shared, sbuf_shared, compact, n;
  size_t hdr_at, tkey_at, tval_at, ckey_at, cidx_at, cpay_at, sbuf_at;
};

// Per utterance, in the scratch (compact mode): set by insert_kernel and
// keys_kernel, read by select_kernel.
struct Header {
  unsigned vmax;   // ordered(max score)
  int dup, distinct, na, nb, nc, ncomp, pad;
};

struct Arrays {
  u64* tkey;      // winner words, then keys
  int* tval;      // dsts, then payloads (or -1 in compact mode), then slots
  u64* ckey;      // compact mode
  uint32_t* cidx;
  uint32_t* cpay;
  Header* hdr;
  SortBuf buf;
};

__device__ Arrays arrays(const Geometry& g, unsigned char* smem, unsigned char* gs, int u) {
  const size_t cap = 1ull << g.bits;
  Arrays a;
  unsigned char* t = g.table_shared ? smem : gs + g.tkey_at + 8 * cap * u;
  a.tkey = reinterpret_cast<u64*>(t);
  a.tval = g.table_shared ? reinterpret_cast<int*>(smem + 8 * cap)
                          : reinterpret_cast<int*>(gs + g.tval_at + 4 * cap * u);
  a.ckey = reinterpret_cast<u64*>(gs + g.ckey_at + 8ull * g.n * u);
  a.cidx = reinterpret_cast<uint32_t*>(gs + g.cidx_at + 4ull * g.n * u);
  a.cpay = reinterpret_cast<uint32_t*>(gs + g.cpay_at + 4ull * g.n * u);
  a.hdr = reinterpret_cast<Header*>(gs + g.hdr_at) + u;
  unsigned char* sb = g.sbuf_shared ? smem + (g.table_shared ? 12 * cap : 0)
                                    : gs + g.sbuf_at + 12ull * g.sb * u;
  a.buf = SortBuf{reinterpret_cast<u64*>(sb), reinterpret_cast<uint32_t*>(sb + 8ull * g.sb),
                  g.sb};
  return a;
}

constexpr int kBatch = 4;   // candidates a thread has in flight

// Recombination: candidates i0, i0 + stride, ... < n of the row go into the
// table (claim the dst's entry by atomicCAS, then atomicMin the word);
// the thread's best score, duplicate flag and claims are accumulated.
__device__ void insert(const float* score, const int* dst, const int* arc, size_t row, int i0,
                       int stride, int n, u64* tkey, int* tval, int bits, float* vmax,
                       int* dup, int* claimed) {
  const uint32_t mask = (1u << bits) - 1;
  for (int base = i0; base < n; base += kBatch * stride) {
    float s[kBatch];
    int d[kBatch], old[kBatch];
    uint32_t a[kBatch], t[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * stride;
      ok[q] = i < n;
      s[q] = ok[q] ? score[row + i] : 0.f;
      d[q] = ok[q] ? dst[row + i] : 0;
      a[q] = ok[q] ? static_cast<uint32_t>(arc[row + i]) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      t[q] = hash_of(d[q], bits);
      if (ok[q]) old[q] = volatile_load(&tval[t[q]]);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (!ok[q]) continue;
      // an entry once claimed keeps its dst: a plain read that finds one
      // needs no atomic; an empty one is claimed by atomicCAS
      for (;;) {
        if (old[q] == kEmpty) old[q] = atomicCAS(&tval[t[q]], kEmpty, d[q]);
        if (old[q] == kEmpty || old[q] == d[q]) break;
        t[q] = (t[q] + 1) & mask;
        old[q] = volatile_load(&tval[t[q]]);
      }
      *claimed += old[q] == kEmpty;
      *dup |= old[q] == d[q];
      *vmax = fmaxf(*vmax, s[q]);
      // the words only decrease: one already at or below w needs no atomic
      const u64 w = (static_cast<u64>(~ordered(s[q])) << 32) | ((a[q] << 1) | negzero(s[q]));
      if (w < volatile_load(&tkey[t[q]])) atomicMin(&tkey[t[q]], w);
    }
  }
}

// The winners' keys: entries i0, i0 + stride, ... < cap get the key
// (~ordered(v) << 32 | dst) and the payload (arc << 1 | negzero(v)), v the
// score if it beats thr, else NEG; counted as live (below the NEG keys),
// NEG, or below NEG.  Compact mode: the live and below-NEG keys are listed
// with their index and payload (position by a warp-aggregated atomic on
// *ncomp), and the values cleared to -1.
template <bool kCompact>
__device__ void make_keys(int i0, int stride, int cap, float thr, const Arrays& A, int* na,
                          int* nb, int* nc, int* ncomp) {
  const uint32_t neg_hi = ~ordered(kNeg);
  const u64 neg_lo = static_cast<u64>(neg_hi) << 32, neg_end = neg_lo + (1ull << 32);
  const int lane = threadIdx.x & 31;
  for (int base = i0 - (i0 & 31); base < cap; base += stride) {
    const int i = base + lane;
    const int d = i < cap ? A.tval[i] : kEmpty;
    u64 key = kNoKey;
    uint32_t pay = 0;
    if (d != kEmpty) {
      const u64 w = A.tkey[i];
      const float s = unordered(~static_cast<uint32_t>(w >> 32), static_cast<uint32_t>(w) & 1u);
      const float v = s > thr ? s : kNeg;
      key = (static_cast<u64>(~ordered(v)) << 32) | static_cast<uint32_t>(d);
      pay = ((static_cast<uint32_t>(w) >> 1) << 1) | negzero(v);
      *na += key < neg_lo;
      *nb += key >= neg_lo && key < neg_end;
      *nc += key >= neg_end;
      A.tkey[i] = key;
      A.tval[i] = kCompact ? -1 : static_cast<int>(pay);
    }
    if constexpr (kCompact) {
      const bool list = d != kEmpty && (key < neg_lo || key >= neg_end);
      const unsigned m = __ballot_sync(kFull, list);
      if (m) {
        const int leader = __ffs(m) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(ncomp, __popc(m));
        at = __shfl_sync(kFull, at, leader) + __popc(m & ((1u << lane) - 1));
        if (list) {
          A.ckey[at] = key;
          A.cidx[at] = static_cast<uint32_t>(i);
          A.cpay[at] = pay;
        }
      }
    }
  }
}

// Compact mode, step 1: grid (blocks, U); the table is all 0xff bytes and
// the headers 0 (cudaMemsetAsync).
__global__ void __launch_bounds__(kThreads)
insert_kernel(const float* __restrict__ score, const int* __restrict__ dst,
              const int* __restrict__ arc, Geometry geo, unsigned char* __restrict__ gs) {
  __shared__ Shared sh;
  const int u = blockIdx.y, n = geo.n;
  const Arrays A = arrays(geo, nullptr, gs, u);
  float vmax = -INFINITY;
  int dup = 0, claimed = 0;
  insert(score, dst, arc, static_cast<size_t>(u) * n, blockIdx.x * kThreads + threadIdx.x,
         gridDim.x * kThreads, n, A.tkey, A.tval, geo.bits, &vmax, &dup, &claimed);
  dup = __syncthreads_or(dup);
  vmax = block_max(vmax, sh);
  claimed = block_sum(claimed, sh);
  if (threadIdx.x == 0) {
    atomicMax(&A.hdr->vmax, ordered(vmax));
    if (dup) atomicOr(&A.hdr->dup, 1);
    atomicAdd(&A.hdr->distinct, claimed);
  }
}

__device__ float threshold(float mx, int dup, float beam) {
  return (dup ? fmaxf(mx, kNeg) : mx) - beam;
}

// Compact mode, step 2: grid (blocks, U).
__global__ void __launch_bounds__(kThreads)
keys_kernel(const float* __restrict__ beam, Geometry geo, unsigned char* __restrict__ gs) {
  __shared__ Shared sh;
  const int u = blockIdx.y;
  const Arrays A = arrays(geo, nullptr, gs, u);
  const float thr = threshold(unordered(A.hdr->vmax, 0u), A.hdr->dup, beam[u]);
  int na = 0, nb = 0, nc = 0;
  make_keys<true>(blockIdx.x * kThreads + threadIdx.x, gridDim.x * kThreads, 1 << geo.bits, thr,
                  A, &na, &nb, &nc, &A.hdr->ncomp);
  na = block_sum(na, sh);
  nb = block_sum(nb, sh);
  nc = block_sum(nc, sh);
  if (threadIdx.x == 0) {
    atomicAdd(&A.hdr->na, na);
    atomicAdd(&A.hdr->nb, nb);
    atomicAdd(&A.hdr->nc, nc);
  }
}

// The slot of each candidate above thr whose dst has a live slot (-1
// otherwise), kBatch candidates a thread in flight; then, to count, an
// atomicAdd on cnt[slot], or to scatter, the candidate's key into its
// bucket at off[slot] + a cursor.
template <bool kScatter>
__device__ void bucket_pass(const float* score, const int* dst, const int* arc, size_t row,
                            int n, float thr, const Arrays& A, int bits, int* cnt,
                            const int* off, u64* bucket) {
  const uint32_t mask = (1u << bits) - 1;
  for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
    float s[kBatch];
    int d[kBatch];
    uint32_t t[kBatch];
    u64 k[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * kThreads;
      s[q] = i < n ? score[row + i] : kNeg;
      ok[q] = i < n && s[q] > thr;
      d[q] = ok[q] ? dst[row + i] : 0;
      t[q] = hash_of(d[q], bits);
      k[q] = ok[q] ? A.tkey[t[q]] : 0ull;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (!ok[q]) continue;
      while (static_cast<int>(static_cast<uint32_t>(k[q])) != d[q]) {
        t[q] = (t[q] + 1) & mask;
        k[q] = A.tkey[t[q]];
      }
      const int j = A.tval[t[q]];
      if (j < 0) continue;
      if constexpr (kScatter) {
        const int i = base + q * kThreads;
        bucket[off[j] + atomicAdd(&cnt[j], 1)] =
            (static_cast<u64>(~ordered(s[q])) << 32) |
            ((static_cast<uint32_t>(arc[row + i]) << 1) | negzero(s[q]));
      } else {
        atomicAdd(&cnt[j], 1);
      }
    }
  }
}

// One block per utterance.  Without compact mode it also recombines and
// keys (phases 1 and 2); with it, insert_kernel and keys_kernel have.
template <bool kLat>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ score, const int* __restrict__ dst,
              const int* __restrict__ arc, const float* __restrict__ beam, int kcap,
              float* __restrict__ out_s, int* __restrict__ out_d, int* __restrict__ out_a,
              Geometry geo, unsigned char* __restrict__ gs, LatArgs lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int u = blockIdx.x, tid = threadIdx.x, lane = tid & 31, n = geo.n;
  const int cap = 1 << geo.bits;
  const Arrays A = arrays(geo, smem, gs, u);
  const size_t row = static_cast<size_t>(u) * n;
  float thr;
  int na, nb, nc;
  const u64 neg_lo = static_cast<u64>(~ordered(kNeg)) << 32, neg_end = neg_lo + (1ull << 32);
  const u64* src = A.tkey;   // the keys top_sorted reads, and their count
  int nsrc = cap;
  if (!geo.compact) {
    // 1. recombine by destination
    for (int i = tid; i < cap; i += kThreads) {
      A.tkey[i] = kNoKey;
      A.tval[i] = kEmpty;
    }
    __syncthreads();
    float vmax = -INFINITY;
    int dup = 0, claimed = 0;
    insert(score, dst, arc, row, tid, kThreads, n, A.tkey, A.tval, geo.bits, &vmax, &dup,
           &claimed);
    dup = __syncthreads_or(dup);
    const float mx = block_max(vmax, sh);
    const int distinct = block_sum(claimed, sh);
    thr = threshold(mx, dup, beam[u]);
    // 2. the winners' keys
    na = nb = nc = 0;
    make_keys<false>(tid, kThreads, cap, thr, A, &na, &nb, &nc, nullptr);
    na = block_sum(na, sh);
    nb = block_sum(nb, sh) + (n - distinct);
    nc = block_sum(nc, sh);
  } else {
    const Header h = *A.hdr;
    thr = threshold(unordered(h.vmax, 0u), h.dup, beam[u]);
    na = h.na;
    nb = h.nb + (n - h.distinct);
    nc = h.nc;
    src = A.ckey;
    nsrc = h.ncomp;
  }

  // 3. the top kcap: live keys, NEG slots, kept values below NEG
  const int k = min(kcap, n), ka = min(k, na), kb = min(k - ka, nb), kc = k - ka - kb;
  const size_t orow = static_cast<size_t>(u) * kcap;
  const size_t lrow = static_cast<size_t>(u) * kcap;
  const bool compact = geo.compact;
  top_sorted(src, nsrc, 0ull, neg_lo, na, ka, A.buf, sh, [&](int j, u64 key, uint32_t at) {
    const uint32_t pay = compact ? A.cpay[at] : static_cast<uint32_t>(A.tval[at]);
    const float v = key_value(key, pay & 1u);
    const bool alive = v > kNeg / 2;
    out_s[orow + j] = v;
    out_d[orow + j] = alive ? static_cast<int>(static_cast<uint32_t>(key)) : 0;
    out_a[orow + j] = alive ? static_cast<int>(pay >> 1) : -1;
    if constexpr (kLat)
      lat.off[lrow + u + j] = alive ? static_cast<int>(compact ? A.cidx[at] : at) : -1;
  });
  // below NEG: never -0, so the payload is not read
  top_sorted(src, nsrc, neg_end, kNoKey, nc, kc, A.buf, sh, [&](int j, u64 key, uint32_t) {
    out_s[orow + ka + kb + j] = key_value(key, 0u);
    out_d[orow + ka + kb + j] = 0;
    out_a[orow + ka + kb + j] = -1;
  });
  for (int j = ka + tid; j < kcap; j += kThreads) {
    if (j >= ka + kb && j < k) continue;
    out_s[orow + j] = kNeg;
    out_d[orow + j] = 0;
    out_a[orow + j] = -1;
  }
  if constexpr (kLat) {
    // 4. the live slots' buckets of candidates above thr
    const int nlat = lat.nlat;
    int* cnt = lat.cnt + lrow;
    int* off = lat.off + lrow + u;   // kcap + 1 entries per utterance
    u64* bucket = lat.bucket + row;
    float* alt_s = lat.alt_s + lrow * nlat;
    int* alt_a = lat.alt_a + lrow * nlat;
    int live = 0;
    for (int j = tid; j < ka; j += kThreads) live += off[j] >= 0;
    live = block_sum(live, sh);      // the live slots are a prefix of the top
    if (!compact) {                  // (keys_kernel cleared the values)
      for (int i = tid; i < cap; i += kThreads) A.tval[i] = -1;
      __syncthreads();
    }
    for (int j = tid; j < live; j += kThreads) {
      A.tval[off[j]] = j;
      cnt[j] = 0;
    }
    __syncthreads();
    bucket_pass<false>(score, dst, arc, row, n, thr, A, geo.bits, cnt, nullptr, nullptr);
    __syncthreads();
    block_scan(cnt, off, live, sh);
    for (int j = tid; j < live; j += kThreads) cnt[j] = 0;
    if (tid == 0) sh.cnt = 0;
    __syncthreads();
    bucket_pass<true>(score, dst, arc, row, n, thr, A, geo.bits, cnt, off, bucket);
    __syncthreads();
    // a warp per slot: rank a bucket of up to kWarpBucket in registers, fill
    // the columns past the bucket (the whole row of a dead slot); larger
    // buckets are listed in cnt for the block
    for (int j = tid >> 5; j < kcap; j += kThreads / 32) {
      float* as = alt_s + static_cast<size_t>(j) * nlat;
      int* aa = alt_a + static_cast<size_t>(j) * nlat;
      const int lo = j < live ? off[j] : 0, b = j < live ? off[j + 1] - lo : 0;
      if (b <= kWarpBucket) {
        constexpr int kPer = kWarpBucket / 32;
        const int q_n = (b + 31) / 32;
        u64 mine[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int e = lane + 32 * q;
          mine[q] = e < b ? bucket[lo + e] : kNoKey;
        }
        int rank[kPer] = {};
#pragma unroll
        for (int q2 = 0; q2 < kPer; ++q2) {
          if (q2 < q_n) {   // compare with the bucket's keys only
            const int lim = min(32, b - 32 * q2);
            for (int src_lane = 0; src_lane < lim; ++src_lane) {
              const u64 other = __shfl_sync(kFull, mine[q2], src_lane);
              const int e2 = src_lane + 32 * q2;
#pragma unroll
              for (int q = 0; q < kPer; ++q) {
                if (q < q_n)
                  rank[q] += other < mine[q] || (other == mine[q] && e2 < lane + 32 * q);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (lane + 32 * q < b && rank[q] < nlat) {
            as[rank[q]] = key_value(mine[q], static_cast<uint32_t>(mine[q]) & 1u);
            aa[rank[q]] = static_cast<int>(static_cast<uint32_t>(mine[q]) >> 1);
          }
        }
      } else if (lane == 0) {
        cnt[atomicAdd(&sh.cnt, 1)] = j;
      }
      for (int c = min(nlat, b) + lane; c < nlat; c += 32) {
        as[c] = kNeg;
        aa[c] = -1;
      }
    }
    __syncthreads();
    // the large buckets, one at a time through the block's radix select
    const int nbig = sh.cnt;
    __syncthreads();   // every thread has read the count before top_sorted reuses it
    for (int i = 0; i < nbig; ++i) {
      const int j = cnt[i], lo = off[j], b = off[j + 1] - lo;
      float* as = alt_s + static_cast<size_t>(j) * nlat;
      int* aa = alt_a + static_cast<size_t>(j) * nlat;
      top_sorted(bucket + lo, b, 0ull, kNoKey, b, min(nlat, b), A.buf, sh,
                 [&](int c, u64 key, uint32_t) {
                   as[c] = key_value(key, static_cast<uint32_t>(key) & 1u);
                   aa[c] = static_cast<int>(static_cast<uint32_t>(key) >> 1);
                 });
    }
  }
}

int pow2_at_least(long long v) {
  int bits = 5;
  while ((1ll << bits) < v) ++bits;
  return bits;
}

size_t align256(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

// The dynamic shared memory a block may take, and the SMs.
int device_limits(int* bytes, int* sms) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *bytes = optin - kStaticSmem;
  return static_cast<int>(e);
}

// Where the table and the sort buffer go, and the device scratch in all
// (*bytes; the lattice mode's buffers after the rest, at *lat_at).
int plan(int U, int n, int kcap, int nlat, Geometry* geo, size_t* bytes, size_t* lat_at) {
  int budget, sms;
  const int rc = device_limits(&budget, &sms);
  if (rc) return rc;
  const long long keff = kcap < n ? kcap : n, leff = nlat < n ? nlat : n;
  const long long want = 2 * (keff > leff ? keff : leff);
  const int sbits = pow2_at_least(want > 256 ? want : 256);
  if (sbits > 30 || n > (1 << 28)) return kNoFit;
  geo->n = n;
  geo->sb = 1 << sbits;
  geo->bits = pow2_at_least((4ll * n + 2) / 3);   // a load of at most 3/4
  const size_t sbuf = 12ull * geo->sb;
  geo->table_shared = (12ull << geo->bits) + sbuf <= static_cast<size_t>(budget);
  geo->compact = !geo->table_shared;
  geo->sbuf_shared = sbuf + (geo->table_shared ? 12ull << geo->bits : 0) <=
                     static_cast<size_t>(budget);
  const size_t cap = 1ull << geo->bits;
  size_t at = 0;
  geo->hdr_at = at;
  geo->tkey_at = at = align256(at + (geo->compact ? sizeof(Header) * U : 0));
  geo->tval_at = at = align256(at + (geo->compact ? 8 * cap * U : 0));
  geo->ckey_at = at = align256(at + (geo->compact ? 4 * cap * U : 0));
  geo->cidx_at = at = align256(at + (geo->compact ? 8ull * n * U : 0));
  geo->cpay_at = at = align256(at + (geo->compact ? 4ull * n * U : 0));
  geo->sbuf_at = at = align256(at + (geo->compact ? 4ull * n * U : 0));
  at = align256(at + (geo->sbuf_shared ? 0 : sbuf * U));
  *lat_at = at;
  if (nlat > 0) at += align256(4ull * U * kcap) + align256(4ull * U * (kcap + 1)) + 8ull * U * n;
  *bytes = at;
  return 0;
}

template <bool kLat>
int allow_smem(int budget) {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel<kLat>, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// The device scratch, in bytes, that dsr_select needs for these arguments
// (0 when the table and sort buffer fit shared memory in 1-best mode).
int dsr_select_scratch(int U, int n, int kcap, int nlat, long long* bytes) {
  if (U < 1 || n < 1 || kcap < 1 || nlat < 0) return kNoFit;
  Geometry geo;
  size_t b, lat_at;
  const int rc = plan(U, n, kcap, nlat, &geo, &b, &lat_at);
  *bytes = static_cast<long long>(b);
  return rc;
}

// score (U, n) f32, dst and arc (U, n) i32 (dst in [0, 2^31 - 1), arc in
// [0, 2^31)), beam (U,) f32 -> out_s/out_d/out_a (U, kcap); nlat > 0: the
// lattice mode, alternates to alt_s/alt_a (U, kcap, nlat).  scratch: the
// bytes dsr_select_scratch asks for (null when it asks for none).  One
// launch, one block per utterance; a pool whose table exceeds shared
// memory first takes two memsets and two grid-wide launches (insert_kernel,
// keys_kernel: several blocks per utterance) on the same stream.
int dsr_select(const float* score, const int* dst, const int* arc, const float* beam, int U,
               int n, int kcap, int nlat, float* out_s, int* out_d, int* out_a, float* alt_s,
               int* alt_a, void* scratch, void* stream) {
  if (U < 1 || n < 1 || kcap < 1 || nlat < 0) return kNoFit;
  Geometry geo;
  size_t bytes, lat_at;
  int rc = plan(U, n, kcap, nlat, &geo, &bytes, &lat_at);
  if (rc) return rc;
  if (bytes > 0 && scratch == nullptr) return kNoFit;
  int budget, sms;
  rc = device_limits(&budget, &sms);
  if (rc) return rc;
  const size_t smem = (geo.table_shared ? 12ull << geo.bits : 0) +
                      (geo.sbuf_shared ? 12ull * geo.sb : 0);
  unsigned char* gs = static_cast<unsigned char*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (geo.compact) {
    const size_t cap = 1ull << geo.bits;
    cudaError_t e = cudaMemsetAsync(gs + geo.hdr_at, 0, sizeof(Header) * U, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(gs + geo.tkey_at, 0xff, 8 * cap * U, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(gs + geo.tval_at, 0xff, 4 * cap * U, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    // about two blocks an SM over all utterances
    const int per = (2 * sms + U - 1) / U;
    const int gi = static_cast<int>((n + kThreads * kBatch - 1) / (kThreads * kBatch));
    const int gk = static_cast<int>((cap + kThreads - 1) / kThreads);
    insert_kernel<<<dim3(gi < per ? gi : per, U), kThreads, 0, st>>>(score, dst, arc, geo, gs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    keys_kernel<<<dim3(gk < per ? gk : per, U), kThreads, 0, st>>>(beam, geo, gs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nlat == 0) {
    rc = allow_smem<false>(budget);
    if (rc) return rc;
    select_kernel<false><<<U, kThreads, smem, st>>>(score, dst, arc, beam, kcap, out_s, out_d,
                                                    out_a, geo, gs, LatArgs{});
  } else {
    rc = allow_smem<true>(budget);
    if (rc) return rc;
    unsigned char* lb = gs + lat_at;
    LatArgs lat;
    lat.nlat = nlat;
    lat.alt_s = alt_s;
    lat.alt_a = alt_a;
    lat.cnt = reinterpret_cast<int*>(lb);
    lb += align256(4ull * U * kcap);
    lat.off = reinterpret_cast<int*>(lb);
    lb += align256(4ull * U * (kcap + 1));
    lat.bucket = reinterpret_cast<u64*>(lb);
    select_kernel<true><<<U, kThreads, smem, st>>>(score, dst, arc, beam, kcap, out_s, out_d,
                                                   out_a, geo, gs, lat);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
