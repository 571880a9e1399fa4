// GSC-NLMS for Hopper (sm_90a): the generalised sidelobe canceller's whole
// frame recurrence, per (utterance, subband bin), in two launches.  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/gsc.py; the entry
// point launches on the caller's stream, allocates nothing (the front
// work's array is the caller's scratch), and returns cudaGetLastError()
// (or kNoFit for an input it does not take).
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
// order.  Blocks on this card run in no order, so each bin's recurrence
// lives in one thread or one group of lanes, and the frames are a loop.
// yc, z and |z|^2 do not depend on wa: only y, the update, the norm and the
// cap form the serial chain, O(N) a frame.  The O(N^2) front work is taken
// off the chain's lanes entirely:
//   1. gsc_front_kernel, fully parallel over (utterance, bin group, frame
//      range): O = [wq, B]^H x for tiles of 16 frames, a small complex
//      matrix product per bin, W = [wq, B] in shared memory when small
//      (else read through L1), the next tile's x arriving by cp.async while
//      this one is computed; O goes to the caller's scratch from registers
//      as one record a (bin, frame), entries [yc, z_0 .. z_{N-2}, (g, 0)]
//      with g = mu / (|z|^2 + eps), laid out (U, bin groups, T, entry, bin
//      of the group), so the chain's loads are coalesced across bins and a
//      group's frames are contiguous;
//   2. gsc_chain_kernel, one warp a bin group: the group's records arrive
//      in chunks of ~16 KB by TMA bulk copies (one copy a chunk, completing
//      on the ring slot's mbarrier, kSlots - 1 chunks ahead), and the lanes
//      run only the chain, wa in registers.  G lanes share a bin (1 up to 4
//      channels, 2 up to 16, then a power of two up to 32 that leaves a lane
//      at most 8 entries, 16 at G = 32), lane s owning entries m = s, s + G,
//      ...; sums over a bin's lanes by butterfly shuffles within the group
//      (the same bits in every lane).  The chain is cut to its dependent
//      core: wa = sc u with the cap's scale sc applied in the next update,
//      so the next frame's u^H z (read into registers during this frame)
//      runs beside the norm and the cap; the cap's sqrt and division run
//      only in lanes where it binds (below the largest float whose sqrtf is
//      <= cap the scale is exactly 1); and the frames of a chunk are an
//      inner loop with no bookkeeping (a chunk's last frame peeled).
//   Above 513 channels (more entries than a warp's registers hold) the
//   same records come from gsc_front_many_kernel (a block a frame and bin)
//   and gsc_chain_many_kernel (a warp a bin, wa in device memory, the plain
//   order of the sums), so every channel count is taken.
//
// What bounds it on this card.  X must be read once: 1 x 8 ch x 1000 frames
// x 129 bins x 8 bytes is 8.3 MB, 2.5 us at 3.35 TB/s (the scratch's
// round trip doubles that), and the front work is ~8 N^2 operations a
// (frame, bin), 4.2 GFLOP at 64 channels (63 us at 67 TFLOP/s).  But only U
// K chains exist, each T dependent steps, so T times one step's dependent
// latency bounds the chain: from the scale, y, g y, the update, |u|^2's
// partial sums, the group's shuffles and the cap's compare, ~60-80 cycles
// at N = 8 (chip_smoke.py prints the estimate); measured on an H100 a step
// takes ~250 cycles (0.127 ms for 1000 frames, PERF.md): one warp issuing
// ~40 instructions a frame, most of them dependent.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kNoFit = -1;
constexpr int kMaxOwn = 8;         // entries of wa a lane owns when lanes share a bin (G < 32)
constexpr int kLanesSmall = 2;     // lanes a bin from 5 to 16 channels (1 or 2)
constexpr int kMaxRegN = 513;      // 32 lanes x 16 entries + 1: wa in registers up to here
constexpr int kSlots = 4;          // the chain's ring: kSlots - 1 chunks in flight
constexpr int kChunkBytes = 16384; // about a chunk's size
constexpr int kThreadsF = 256;     // front blocks
constexpr int kTT = 16;            // frames a front tile
constexpr int kWSharedBytes = 48 * 1024;   // W in a front block's shared memory up to this
constexpr int kBlockSlots = 8;     // front blocks an SM at most (2,048 threads)

// The record layout for N channels: G lanes a bin, KB = 32 / G bins a group,
// RS entries a (frame, bin) (N + 1, one more when a frame's record would not
// be a multiple of 16 bytes), E entries of wa a lane (above kMaxRegN
// channels, the "many" kernels': any count, wa in device memory).
struct Layout {
  int G, KB, RS, E, groups;
};

Layout layout_for(int N, int K) {
  const int NM = N - 1;
  Layout l;
  l.G = N > 16 || NM < 2 * kLanesSmall ? 1 : kLanesSmall;
  if (N > 16)
    while (l.G < 32 && l.G * kMaxOwn < NM) l.G *= 2;
  l.KB = 32 / l.G;
  l.E = (NM + l.G - 1) / l.G;
  if (N > 16 && N <= kMaxRegN) l.E = l.E <= kMaxOwn ? kMaxOwn : 16;
  l.RS = N + 1 + ((N + 1) * l.KB % 2);
  l.groups = (K + l.KB - 1) / l.KB;
  return l;
}

// ---- 1. the front work --------------------------------------------------------

// cp.async of 8 bytes from global g to the shared-window address d, the
// bytes zero when !in; committed in groups, waited for by cp_wait<N> (all
// but the newest N groups complete).
__device__ __forceinline__ void cp_async8(unsigned d, const void* g, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(g), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid (groups, frame ranges, U).  Block (grp, q, u): bins k = grp KB + kb
// (kb < KB; zeros beyond K) and frames [q TQ, (q + 1) TQ) in tiles of kTT,
// the next tile's x arriving by cp.async while this one is computed.
// Shared memory: W (N, N, KB) = [wq, B] when kWShared (else read through
// L1 from device memory), two tiles of x (N, kTT, KB), and |z_m|^2 (kTT, N,
// KB).  A thread takes (entry e, bin kb) pairs, kb fastest when W is in
// shared memory (its reads then hit 32 banks), e fastest when W comes from
// device memory (its reads then coalesce): O[tl][e] = sum_n conj(W[n][e])
// x[n][tl], n ascending, for the tile's kTT frames in registers, written
// to the records from there; then a thread a (frame, bin) sums |z|^2 over
// m ascending and writes g.
template <int KB, bool kWShared>
__global__ void __launch_bounds__(kThreadsF)
gsc_front_kernel(const float2* __restrict__ X, const float2* __restrict__ wq,
                 const float2* __restrict__ B, float2* __restrict__ front, int N, int T, int K,
                 int RS, int TQ, float mu, float eps) {
  extern __shared__ __align__(16) float2 shf[];
  const int NM = N - 1, grp = blockIdx.x, u = blockIdx.z, groups = gridDim.x;
  const int xtile = N * kTT * KB;
  float2* Ws = shf;
  float2* xs = Ws + (kWShared ? N * N * KB : 0);   // two tiles
  float* zz = reinterpret_cast<float*>(xs + 2 * xtile);
  // column e of bin kb's W: its entries n at col[n * stride] (null: a pad bin)
  const auto column = [&](int e, int kb, int* stride) -> const float2* {
    const int k = grp * KB + kb;
    *stride = e == 0 ? 1 : NM;
    if (k >= K) return nullptr;
    const size_t uk = static_cast<size_t>(u) * K + k;
    return e == 0 ? wq + uk * N : B + uk * N * NM + e - 1;
  };
  const int t_first = static_cast<int>(blockIdx.y) * TQ;
  const int t_end = min(T, t_first + TQ);
  const float2* Xu = X + static_cast<size_t>(u) * N * T * K;
  // x[n][tl][kb] of the tile from t0 into buffer `half`, zeros outside
  const auto fetch = [&](int t0, int half) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(xs + half * xtile));
    for (int i = threadIdx.x; i < xtile; i += blockDim.x) {
      const int kb = i % KB, tl = (i / KB) % kTT, n = i / (KB * kTT), k = grp * KB + kb;
      const bool in = t0 + tl < t_end && k < K;
      cp_async8(d + 8u * i, in ? Xu + (static_cast<size_t>(n) * T + t0 + tl) * K + k : Xu, in);
    }
    cp_commit();
  };
  if (t_first < t_end) fetch(t_first, 0);
  if constexpr (kWShared)
    for (int i = threadIdx.x; i < N * N * KB; i += blockDim.x) {
      const int kb = i % KB, ne = i / KB, n = ne / N;
      int stride;
      const float2* col = column(ne - n * N, kb, &stride);
      Ws[i] = col ? __ldg(col + n * stride) : make_float2(0.f, 0.f);
    }
  for (int t0 = t_first, half = 0; t0 < t_end; t0 += kTT, half ^= 1) {
    const int nt = min(kTT, t_end - t0);
    float2* rec0 = front + ((static_cast<size_t>(u) * groups + grp) * T + t0) * RS * KB;
    if (t0 + kTT < t_end) {   // the other buffer was last read before the previous tile's end
      fetch(t0 + kTT, half ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // this tile's x (and W) in place; the last tile's |z|^2 read
    const float2* xt = xs + half * xtile;
    for (int p = threadIdx.x; p < N * KB; p += blockDim.x) {
      const int e = kWShared ? p / KB : p % N, kb = kWShared ? p % KB : p / N;
      int stride;
      const float2* col = kWShared ? nullptr : column(e, kb, &stride);
      float ar[kTT], ai[kTT];
#pragma unroll
      for (int tl = 0; tl < kTT; ++tl) ar[tl] = ai[tl] = 0.f;
      for (int n = 0; n < N; ++n) {
        float2 w;
        if constexpr (kWShared)
          w = Ws[(n * N + e) * KB + kb];
        else
          w = col ? __ldg(col + n * stride) : make_float2(0.f, 0.f);
        const float2* xn = xt + n * kTT * KB + kb;
#pragma unroll
        for (int tl = 0; tl < kTT; ++tl) {
          const float2 x = xn[tl * KB];
          ar[tl] = fmaf(w.x, x.x, fmaf(w.y, x.y, ar[tl]));   // conj(w) x
          ai[tl] = fmaf(w.x, x.y, fmaf(-w.y, x.x, ai[tl]));
        }
      }
#pragma unroll
      for (int tl = 0; tl < kTT; ++tl) {
        if (tl < nt) rec0[(tl * RS + e) * KB + kb] = make_float2(ar[tl], ai[tl]);
        if (e > 0) zz[(tl * N + e) * KB + kb] = fmaf(ar[tl], ar[tl], ai[tl] * ai[tl]);
      }
    }
    __syncthreads();   // |z_m|^2 in place
    for (int p = threadIdx.x; p < nt * KB; p += blockDim.x) {
      const int tl = p / KB, kb = p - tl * KB;
      const float* z2 = zz + (tl * N + 1) * KB + kb;
      float zn = 0.f;
      for (int m = 0; m < NM; ++m) zn += z2[m * KB];
      rec0[(tl * RS + N) * KB + kb] = make_float2(mu / (zn + eps), 0.f);
      if (RS > N + 1) rec0[(tl * RS + N + 1) * KB + kb] = make_float2(0.f, 0.f);
    }
  }
}

// ---- 2. the chain ---------------------------------------------------------------

// The mbarrier at bar expects `bytes` more (an arrival), then the TMA bulk
// copy of them (a multiple of 16) from global src to shared dst (both
// 16-byte aligned), completing on it.  The proxy fence orders the warp's
// earlier reads of the slot before the copy's writes.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// The sum of v over the G lanes of this lane's group (G a power of two,
// the group's lanes consecutive), by butterfly: every lane gets the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The norm cap's scale, min(1, cap / max(sqrt(s), 1e-30)), with IEEE sqrtf
// and division.  s_cap is the largest float whose sqrtf is <= cap (or -1):
// up to it the scale is exactly 1 (cap / x >= 1 rounds to >= 1 for x <=
// cap, and cap >= 1e-30), so the sqrt and the division, most of the
// chain's latency, run only in lanes where the cap binds.
__device__ __forceinline__ float cap_scale(float s, float cap, float s_cap) {
  float scale = 1.f;
  if (!(s <= s_cap)) scale = fminf(1.f, cap / fmaxf(sqrtf(s), 1e-30f));
  return scale;
}

// One frame's record as a lane reads it: yc, the gain, and z at the lane's
// entries (zero beyond N - 1).
template <int kE>
struct Frame {
  float2 yc;
  float g, zr[kE], zi[kE];
};

template <int kG, int kE>
__device__ __forceinline__ void read_frame(Frame<kE>& f, const float2* rec, int N, int KB, int s) {
  f.yc = rec[0];
  f.g = rec[N * KB].x;
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int m = s + kG * i;
    const float2 z = m < N - 1 ? rec[(1 + m) * KB] : make_float2(0.f, 0.f);
    f.zr[i] = z.x;
    f.zi[i] = z.y;
  }
}

// grid (groups, U), one warp.  Lane = kb kG + s: bin k = grp KB + kb, owning
// wa entries m = s + kG i, i < kE (those below N - 1).  Chunk c (frames c R
// ..) of the group's records goes to ring slot c mod kSlots; frame t + 1's
// record is read into registers while frame t's chain runs.  Shared
// memory: the kSlots mbarriers, then the slots of R frames (RS KB float2
// each).
template <int kG, int kE>
__global__ void __launch_bounds__(32)
gsc_chain_kernel(const float2* __restrict__ front, const float2* __restrict__ wa0,
                 float2* __restrict__ Y, float2* __restrict__ wa_out, int N, int T, int K,
                 int RS, int R, float cap, float s_cap) {
  extern __shared__ __align__(16) unsigned long long shc[];
  constexpr int KB = 32 / kG;
  const int lane = threadIdx.x, kb = lane / kG, s = lane - kb * kG;
  const int grp = blockIdx.x, u = blockIdx.y, NM = N - 1, k = grp * KB + kb;
  const bool live = k < K;
  const int fb = RS * KB;   // float2 a frame's records
  const float2* src = front + (static_cast<size_t>(u) * gridDim.x + grp) * T * fb;
  const float2* ring = reinterpret_cast<const float2*>(shc + kSlots);
  const unsigned bars = static_cast<unsigned>(__cvta_generic_to_shared(shc));
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int nchunk = (T + R - 1) / R;
  const auto issue = [&](int c) {
    if (lane == 0 && c < nchunk)
      bulk_load(ring_s + 8u * (c % kSlots) * R * fb, src + static_cast<size_t>(c) * R * fb,
                8u * min(R, T - c * R) * fb, bars + 8u * (c % kSlots));
  };
  const auto wait = [&](int c) {
    while (!mbar_done(bars + 8u * (c % kSlots), (c / kSlots) & 1)) {
    }
  };
  if (lane == 0) {
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8u * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int c = 0; c < kSlots - 1; ++c) issue(c);

  // wa = sc u: u, the lane's entries, and the pending scale sc of the norm
  // cap, applied in the next update (wa0, sc = 1 at the start)
  float ur[kE], ui[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int m = s + kG * i;
    const float2 w = wa0 && live && m < NM ? __ldg(wa0 + (static_cast<size_t>(u) * K + k) * NM + m)
                                           : make_float2(0.f, 0.f);
    ur[i] = w.x;
    ui[i] = w.y;
  }
  // u^H z of a frame: two partial sums by entry parity, then over the group
  const auto dot = [&](const Frame<kE>& f, float& dr, float& di) {
    float r0 = 0.f, i0 = 0.f, r1 = 0.f, i1 = 0.f;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      if (i & 1) {
        r1 = fmaf(ur[i], f.zr[i], fmaf(ui[i], f.zi[i], r1));
        i1 = fmaf(ur[i], f.zi[i], fmaf(-ui[i], f.zr[i], i1));
      } else {
        r0 = fmaf(ur[i], f.zr[i], fmaf(ui[i], f.zi[i], r0));
        i0 = fmaf(ur[i], f.zi[i], fmaf(-ui[i], f.zr[i], i0));
      }
    }
    dr = group_sum<kG>(r0 + r1);
    di = group_sum<kG>(i0 + i1);
  };
  float2* Yt = Y + static_cast<size_t>(u) * T * K + k;   // frame t's output
  float sc = 1.f, dr, di;
  // frame t, its record in a; b, the next frame's (read already), when
  // `more`: y = yc - sc u^H z; u <- sc u + g z conj(y), |u|^2 in two
  // partial sums and over the group; the next frame's u^H z beside the
  // norm's sum and the cap
  const auto step = [&](const Frame<kE>& a, const Frame<kE>& b, bool more) {
    const float yr = fmaf(-sc, dr, a.yc.x), yi = fmaf(-sc, di, a.yc.y);
    if (live && s == 0) *Yt = make_float2(yr, yi);
    Yt += K;
    const float gr = a.g * yr, gi = a.g * yi;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      ur[i] = fmaf(a.zr[i], gr, fmaf(a.zi[i], gi, sc * ur[i]));   // z conj(y) g
      ui[i] = fmaf(a.zi[i], gr, fmaf(-a.zr[i], gi, sc * ui[i]));
      if (i & 1)
        s1 = fmaf(ur[i], ur[i], fmaf(ui[i], ui[i], s1));
      else
        s0 = fmaf(ur[i], ur[i], fmaf(ui[i], ui[i], s0));
    }
    if (more) dot(b, dr, di);
    sc = cap_scale(group_sum<kG>(s0 + s1), cap, s_cap);
  };
  Frame<kE> cur, nxt;
  wait(0);
  read_frame<kG>(cur, ring + kb, N, KB, s);
  dot(cur, dr, di);
  for (int c = 0; c < nchunk; ++c) {
    __syncwarp();   // chunk c - 1's slot is read
    issue(c + kSlots - 1);
    const float2* rows = ring + (c % kSlots) * R * fb + kb;
    const int nt = min(R, T - c * R);
    for (int tl = 0; tl + 1 < nt; ++tl) {   // the next frame is in this chunk
      read_frame<kG>(nxt, rows + (tl + 1) * fb, N, KB, s);
      asm volatile("" ::: "memory");   // its loads issue before the chain
      step(cur, nxt, true);
      cur = nxt;
    }
    const bool more = c + 1 < nchunk;   // the chunk's last frame: the next opens chunk c + 1
    if (more) {
      wait(c + 1);
      read_frame<kG>(nxt, ring + ((c + 1) % kSlots) * R * fb + kb, N, KB, s);
    }
    step(cur, nxt, more);
    cur = nxt;
  }
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int m = s + kG * i;
    if (live && m < NM)
      wa_out[(static_cast<size_t>(u) * K + k) * NM + m] = make_float2(sc * ur[i], sc * ui[i]);
  }
}

// ---- more than kMaxRegN channels ------------------------------------------------
// The same records (G = 32 lanes a bin, KB = 1) and the chain in the plain
// order (wa scaled each frame), with nothing sized by N in registers or,
// beyond N floats, in shared memory, so any channel count the card's memory
// holds is taken; chip_smoke.py checks them at 600 channels, untimed.

// grid (T, K, U): block (t, k, u) writes its record, its threads strided
// over the entries e < N (W and x read from device memory, n ascending),
// then thread 0 sums |z|^2 over m ascending.  Shared memory: N - 1 float2.
__global__ void __launch_bounds__(kThreadsF)
gsc_front_many_kernel(const float2* __restrict__ X, const float2* __restrict__ wq,
                      const float2* __restrict__ B, float2* __restrict__ front, int N, int T,
                      int K, int RS, float mu, float eps) {
  extern __shared__ __align__(16) float2 zs[];
  const int t = blockIdx.x, k = blockIdx.y, u = blockIdx.z, NM = N - 1;
  const size_t uk = static_cast<size_t>(u) * K + k;
  const float2* xu = X + (static_cast<size_t>(u) * N * T + t) * K + k;   // x[n] at n T K
  float2* rec = front + (uk * T + t) * RS;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int n = 0; n < N; ++n) {
      const float2 w = e == 0 ? __ldg(wq + uk * N + n) : __ldg(B + (uk * N + n) * NM + e - 1);
      const float2 x = __ldg(xu + static_cast<size_t>(n) * T * K);
      ar = fmaf(w.x, x.x, fmaf(w.y, x.y, ar));
      ai = fmaf(w.x, x.y, fmaf(-w.y, x.x, ai));
    }
    rec[e] = make_float2(ar, ai);
    if (e > 0) zs[e - 1] = make_float2(ar, ai);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float zn = 0.f;
    for (int m = 0; m < NM; ++m) zn = fmaf(zs[m].x, zs[m].x, fmaf(zs[m].y, zs[m].y, zn));
    rec[N] = make_float2(mu / (zn + eps), 0.f);
    if (RS > N + 1) rec[N + 1] = make_float2(0.f, 0.f);
  }
}

// grid (K, U), one warp a bin: lane s owns entries m = s + 32 i < N - 1,
// kept in wa_out itself (from wa0 or zero; each lane touches only its
// own); the records read from device memory.
__global__ void __launch_bounds__(32)
gsc_chain_many_kernel(const float2* __restrict__ front, const float2* __restrict__ wa0,
                      float2* __restrict__ Y, float2* wa_out, int N, int T, int K, int RS,
                      float cap, float s_cap) {
  const int lane = threadIdx.x, k = blockIdx.x, u = blockIdx.y, NM = N - 1;
  const size_t uk = static_cast<size_t>(u) * K + k;
  float2* w = wa_out + uk * NM;
  for (int m = lane; m < NM; m += 32) w[m] = wa0 ? __ldg(wa0 + uk * NM + m) : make_float2(0.f, 0.f);
  const float2* recs = front + uk * T * RS;
  for (int t = 0; t < T; ++t) {
    const float2* rec = recs + static_cast<size_t>(t) * RS;
    const float2 yc = rec[0];
    const float g = rec[N].x;
    float ar0 = 0.f, ai0 = 0.f, ar1 = 0.f, ai1 = 0.f;
    for (int m = lane, i = 0; m < NM; m += 32, ++i) {
      const float2 z = rec[1 + m], v = w[m];
      if (i & 1) {
        ar1 += v.x * z.x + v.y * z.y;
        ai1 += v.x * z.y - v.y * z.x;
      } else {
        ar0 += v.x * z.x + v.y * z.y;
        ai0 += v.x * z.y - v.y * z.x;
      }
    }
    const float yr = yc.x - group_sum<32>(ar0 + ar1);
    const float yi = yc.y - group_sum<32>(ai0 + ai1);
    if (lane == 0) Y[(static_cast<size_t>(u) * T + t) * K + k] = make_float2(yr, yi);
    float s0 = 0.f, s1 = 0.f;
    for (int m = lane, i = 0; m < NM; m += 32, ++i) {
      const float2 z = rec[1 + m];
      float2 v = w[m];
      v.x += (z.x * yr + z.y * yi) * g;
      v.y += (z.y * yr - z.x * yi) * g;
      w[m] = v;
      if (i & 1)
        s1 += v.x * v.x + v.y * v.y;
      else
        s0 += v.x * v.x + v.y * v.y;
    }
    const float scale = cap_scale(group_sum<32>(s0 + s1), cap, s_cap);
    for (int m = lane; m < NM; m += 32) {
      float2 v = w[m];
      v.x *= scale;
      v.y *= scale;
      w[m] = v;
    }
  }
}

// ---- the launch ---------------------------------------------------------------

int device_limits(int* optin, int* sms) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

using FrontKernel = void (*)(const float2*, const float2*, const float2*, float2*, int, int, int,
                             int, int, float, float);

template <int KB>
FrontKernel front_for(int kb, bool w_shared) {
  if constexpr (KB < 1) {
    return nullptr;
  } else {
    if (kb != KB) return front_for<KB / 2>(kb, w_shared);
    return w_shared ? gsc_front_kernel<KB, true> : gsc_front_kernel<KB, false>;
  }
}

FrontKernel front_kernel(int kb, bool w_shared) { return front_for<32>(kb, w_shared); }

using ChainKernel = void (*)(const float2*, const float2*, float2*, float2*, int, int, int, int,
                             int, float, float);

// The chain kernel of a layout: kG = 1 (or kLanesSmall) with kE = the
// lane's share of N - 1, or kG = 2 to 32 with kE = 8 (and 16 at 32).
template <int kG, int kE, int kMaxE>
ChainKernel chain_for(int E) {
  if constexpr (kE > kMaxE) {
    return nullptr;
  } else {
    return E == kE ? gsc_chain_kernel<kG, kE> : chain_for<kG, kE + 1, kMaxE>(E);
  }
}

ChainKernel chain_kernel(const Layout& l) {
  switch (l.G) {
    case 1: return chain_for<1, 1, 15>(l.E);
    case 2: return chain_for<2, 1, kMaxOwn>(l.E);
    case 4: return chain_for<4, kMaxOwn, kMaxOwn>(l.E);
    case 8: return chain_for<8, kMaxOwn, kMaxOwn>(l.E);
    case 16: return chain_for<16, kMaxOwn, kMaxOwn>(l.E);
    case 32: return l.E == 16 ? gsc_chain_kernel<32, 16> : chain_for<32, kMaxOwn, kMaxOwn>(l.E);
    default: return nullptr;
  }
}

// The largest float whose sqrtf is <= cap (IEEE sqrt is monotonic and
// correctly rounded on host and card alike), or -1 where cap_scale must
// always compute (cap not finite, or below 1e-30).
float cap_threshold(float cap) {
  if (!(cap >= 1e-30f) || !std::isfinite(cap)) return -1.f;
  float s = cap * cap;
  while (std::sqrt(std::nextafter(s, INFINITY)) <= cap) s = std::nextafter(s, INFINITY);
  while (std::sqrt(s) > cap) s = std::nextafter(s, 0.f);
  return s;
}

}  // namespace

extern "C" {

// Device scratch (float2 elements) the call needs for U utterances of T
// frames of K bins at N channels: the front work's records.  0 for an input
// the kernel does not take (dsr_gsc_nlms then returns kNoFit).
long long dsr_gsc_scratch(int U, int N, int T, int K) {
  if (N < 2 || T < 1) return 0;
  const Layout l = layout_for(N, K);
  return static_cast<long long>(U) * l.groups * T * l.RS * l.KB;
}

// X (U, N, T, K), wq (U, K, N), B (U, K, N, N-1), wa0 (U, K, N-1) or null,
// all complex64 as interleaved float2 → Y (U, T, K), wa (U, K, N-1).
// N >= 2, T >= 1; scratch: the float2 elements dsr_gsc_scratch asks for,
// 16-byte aligned.
int dsr_gsc_nlms(const void* X, const void* wq, const void* B, const void* wa0, void* Y,
                 void* wa, int U, int N, int T, int K, float mu, float eps, float cap,
                 void* scratch, void* stream) {
  if (N < 2 || T < 1 || U < 1 || K < 1) return kNoFit;
  if (scratch == nullptr) return kNoFit;
  int optin, sms;
  int rc = device_limits(&optin, &sms);
  if (rc) return rc;
  const Layout l = layout_for(N, K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* front = static_cast<float2*>(scratch);
  if (N > kMaxRegN) {
    const size_t smem = 8ull * (N - 1);
    if (smem > static_cast<size_t>(optin)) return kNoFit;
    rc = set_smem(reinterpret_cast<const void*>(gsc_front_many_kernel), smem);
    if (rc) return rc;
    gsc_front_many_kernel<<<dim3(T, K, U), kThreadsF, smem, st>>>(
        static_cast<const float2*>(X), static_cast<const float2*>(wq),
        static_cast<const float2*>(B), front, N, T, K, l.RS, mu, eps);
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    gsc_chain_many_kernel<<<dim3(K, U), 32, 0, st>>>(front, static_cast<const float2*>(wa0),
                                                      static_cast<float2*>(Y),
                                                      static_cast<float2*>(wa), N, T, K, l.RS,
                                                      cap, cap_threshold(cap));
    return static_cast<int>(cudaGetLastError());
  }

  // 1: W in shared memory when it is small (else the blocks' footprint
  // would cut the SM's blocks); frame ranges so the grid fills the SMs
  const size_t tiles_smem = 8ull * (2 * N * kTT) * l.KB + 4ull * kTT * N * l.KB;
  const size_t w_smem = 8ull * N * N * l.KB;
  const bool w_shared = w_smem <= kWSharedBytes;
  const size_t smem_f = tiles_smem + (w_shared ? w_smem : 0);
  const FrontKernel front_k = front_kernel(l.KB, w_shared);
  if (front_k == nullptr || smem_f > static_cast<size_t>(optin)) return kNoFit;
  const long long per_sm = std::min<long long>(kBlockSlots, (optin + 1024) / (smem_f + 1024));
  const long long want = per_sm * sms, cells = static_cast<long long>(l.groups) * U;
  const int ttiles = (T + kTT - 1) / kTT;
  const int split = static_cast<int>(std::min<long long>((want + cells - 1) / cells, ttiles));
  const int TQ = (ttiles + split - 1) / split * kTT;
  rc = set_smem(reinterpret_cast<const void*>(front_k), smem_f);
  if (rc) return rc;
  front_k<<<dim3(l.groups, (T + TQ - 1) / TQ, U), kThreadsF, smem_f, st>>>(
      static_cast<const float2*>(X), static_cast<const float2*>(wq),
      static_cast<const float2*>(B), front, N, T, K, l.RS, TQ, mu, eps);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;

  // 2: chunks of about kChunkBytes
  const int fbytes = 8 * l.RS * l.KB;
  const int R = kChunkBytes / fbytes > 1 ? kChunkBytes / fbytes : 1;
  const size_t smem_c = 8ull * kSlots + static_cast<size_t>(kSlots) * R * fbytes;
  const ChainKernel chain = chain_kernel(l);
  if (chain == nullptr || smem_c > static_cast<size_t>(optin)) return kNoFit;
  rc = set_smem(reinterpret_cast<const void*>(chain), smem_c);
  if (rc) return rc;
  chain<<<dim3(l.groups, U), 32, smem_c, st>>>(front, static_cast<const float2*>(wa0),
                                                static_cast<float2*>(Y), static_cast<float2*>(wa),
                                                N, T, K, l.RS, R, cap, cap_threshold(cap));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
