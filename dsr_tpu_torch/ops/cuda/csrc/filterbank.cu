// Oversampled DFT filterbank synthesis for Hopper (sm_90a), as an inverse
// real FFT of each frame.  (The analysis and the fused analysis + beamform
// are forward FFTs, csrc/analysis.cu; both sources take the FFT from
// csrc/fft.cuh.)  Plain C interface, loaded with ctypes by
// dsr_tpu_torch/ops/cuda/filterbank.py; the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// kNoFit: never for a valid config).
//
// Replaces (dsr_tpu/ops/pallas/filterbank.py) :710 _synthesis_kernel_v5
// and :578 _synthesis_kernel: one kernel for every M, m and D.
//
// The function (the conventions of dsr_tpu/ops/filterbank.py): M subbands,
// prototype length L = m*M, hop D = M/r, K = M/2+1 bins.  Frame t's
// samples are v_t = irfft(A[t], n = M), windowed by gf and overlap-added at
// hop D; output sample j is padded-stream sample s = start + j:
//     y[s] = sum_{jj < m r} gf[d + jj D] v_{floor(s/D) - jj}[(jj mod r) D + d],
// d = s mod D, frames outside [0, T) zero.
//
// The inverse transform, for even M, is an n = M/2 point complex FFT: the
// K bins are packed into
//     Z[k] = ((A[k] + conj A[n-k]) + i e^{2 pi i k/M} (A[k] - conj A[n-k])) / M,
// k < n, whose inverse DFT z gives v[2j] = Re z[j], v[2j+1] = Im z[j].
// For odd M, the M-point inverse DFT of the Hermitian extension
// (A[M-k] = conj A[k]) / M.  irfft ignores the imaginary parts of the DC
// and (even M) Nyquist bins, so the pack drops them.  The inverse DFT is
// the analysis's forward Stockham FFT run on the conjugate of Z (its
// result read back conjugated): the same plan, stages and twiddle table of
// e^{-2 pi i j / M} (sincospif, exact zeros at the quarter turns), so
// there is one FFT code in the repository.
//
// What bounds it on this card: each frame's transform is ~2.5 M log2 M
// operations against 8 K bytes of spectrum read, and the overlap-add 2 m r
// operations a sample against 4 bytes written, so bytes bound the function
// (the serving output, 1 ch x 8 s at M = 256: 1.5 MB, 0.0005 ms at 3.35
// TB/s); what is left above that is a block's latency (the spectra's loads,
// a barrier a stage, the gather).  Two routes:
//   - tiles: a block produces the samples of F consecutive output frames
//     (hop periods) of one channel.  It transforms the F + m r - 1 frames
//     they read (the tile's and the m r - 1 before it: the halo, recomputed
//     by the neighbouring block), ping-pong in shared memory (padded
//     buffers, the fused kernel's radix-8 plan), unpacks each frame's M
//     samples into the free buffer, and overlap-adds as a gather, one
//     thread per output sample summing its m r terms in a fixed order: no
//     atomics, a deterministic result.  F is chosen for about one block an
//     SM, at most kSynTilePoints points a tile;
//   - when even F = 1 does not fit shared memory (large M, or m r^2 large:
//     M = 4096, m = 8, r = 4096 reads 32,768 frames a sample), every frame
//     the output needs is transformed by the same pack, FFT and unpack into
//     the caller's device scratch (several frames a block, or a block a
//     frame with the stages held in registers or, beyond what shared memory
//     holds, with the buffers in the scratch), then synthesis_ola_kernel
//     sums each sample's m r terms in double, a warp's 32 samples walking
//     the rows they read so that each row's reads are coalesced (split over
//     the rows, with a second kernel adding the partial sums in a fixed
//     order, when m r is large).
// At the main path's M = 256 the tiles' stages are the fused kernel's
// constant ones (stages_pow2, fft.cuh).

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kNoFit = -1;
constexpr int kSynTilePoints = 4096;   // a tile's transforms, both routes: at most this many points
                                       // (or the frames one output frame reads, or one frame)
constexpr int kIdftBlocksPerSm = 4;    // the device-memory route's IDFT grid, at most
constexpr int kOlaWarpsPerSm = 32;     // the overlap-add's grid: about this many warps an SM
constexpr int kOlaRowsMin = 64;        // rows a warp walks, at least, when they are split

// Frames t0 .. t0 + nf - 1 of one channel's spectra Ac (T, K), packed for
// the inverse transform into b (frame f at points f n .. f n + n - 1): the
// conjugate of Z[k], the note's pack (even M) or the Hermitian extension
// (odd M), each scaled by 1 / M; zeros outside [0, T).  A thread loads the
// spectra of kPackBatch of its points before it packs them, so that many
// loads are in flight (one at a time, their latency set the tile's).
constexpr int kPackBatch = 8;

template <bool kPad>
__device__ __forceinline__ void pack(float2* b, const float2* __restrict__ Ac, int T, int M,
                                     long long t0, int nf, const Plan& pl, const Twiddle& tw) {
  const int n = pl.n, K = M / 2 + 1, total = nf * n;
  const float sc = 1.f / M;
  for (int e0 = threadIdx.x; e0 < total; e0 += kPackBatch * blockDim.x) {
    float2 a[kPackBatch], c[kPackBatch];   // A[k] and A[n - k] (odd M: A[k] or A[M - k])
#pragma unroll
    for (int j = 0; j < kPackBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      a[j] = c[j] = make_float2(0.f, 0.f);
      if (e < total) {
        const int f = pl.by_n.div(e), k = e - f * n;
        const long long t = t0 + f;
        if (t >= 0 && t < T) {
          const float2* at_t = Ac + t * K;
          if (pl.s == 2) {
            a[j] = __ldg(at_t + k);
            c[j] = __ldg(at_t + n - k);
          } else {
            a[j] = __ldg(at_t + (k < K ? k : M - k));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPackBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e >= total) break;
      const int k = e - pl.by_n.div(e) * n;
      float2 z;
      if (pl.s == 2) {
        float2 p0 = a[j], p1 = c[j];
        if (k == 0) {   // DC and Nyquist: real parts only
          p0.y = 0.f;
          p1.y = 0.f;
        }
        const float2 p = make_float2(p0.x + p1.x, p0.y - p1.y);   // A[k] + conj A[n-k]
        const float2 q = make_float2(p0.x - p1.x, p0.y + p1.y);   // A[k] - conj A[n-k]
        const float2 w = tw(k);                                    // e^{-2 pi i k / M}
        const float2 wq = make_float2(w.x * q.x + w.y * q.y, w.x * q.y - w.y * q.x);  // conj(w) q
        z = make_float2(p.x - wq.y, p.y + wq.x);                   // p + i conj(w) q
      } else {
        z = a[j];
        if (k >= K) z.y = -z.y;   // A[M - k] = conj A[k]
        if (k == 0) z.y = 0.f;
      }
      b[at<kPad>(e)] = make_float2(z.x * sc, -z.y * sc);
    }
  }
}

// The nf frames' inverse transforms, from the stages' output Z (the forward
// FFT of the conjugate: z = conj Z), as M real samples a frame into rows
// of v (row stride M): v[2j] = Re z[j], v[2j+1] = Im z[j] (even M), v[p] =
// Re z[p] (odd M).  Point e = f n + j of Z is row f's sample 2 e - f M (even
// M) or e - f M (odd M), so no division is needed.
template <bool kPad>
__device__ __forceinline__ void unpack(float* v, const float2* Z, int nf, const Plan& pl) {
  for (int e = threadIdx.x; e < nf * pl.n; e += blockDim.x) {
    const float2 z = Z[at<kPad>(e)];
    if (pl.s == 2)
      *reinterpret_cast<float2*>(v + 2ll * e) = make_float2(z.x, -z.y);
    else
      v[e] = z.x;
  }
}

// ---- tiles ------------------------------------------------------------------

// grid (tiles, C).  Tile b holds output frames tf = tf0 + b F .. + F - 1
// (samples tf D .. tf D + D - 1) and transforms frames tf0 + b F - (m r - 1)
// onwards, nf = F + m r - 1 of them.  A: (C, T, K) complex, y: (C,
// out_len).  Shared memory: the twiddle table (M entries) when `table`,
// then two padded buffers of nf n points.
__global__ void __launch_bounds__(kThreadsS)
synthesis_kernel(const float2* __restrict__ A, const float* __restrict__ gf,
                 float* __restrict__ y, int T, int M, int m, int D, int F, long long tf0,
                 long long start, int out_len, int table, Plan pl, FastDiv by_d) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = pl.n, K = M / 2 + 1, mr = m * (M / D), nf = F + mr - 1;
  float2* b0 = smem + (table ? M : 0);
  float2* b1 = b0 + padded(nf * n);
  const Twiddle tw{smem, M, table != 0};
  const int c = blockIdx.y;
  const long long tf_b = tf0 + static_cast<long long>(blockIdx.x) * F;

  if (table) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) smem[j] = twiddle(j, M);
    __syncthreads();
  }
  pack<true>(b0, A + static_cast<long long>(c) * T * K, T, M, tf_b - (mr - 1), nf, pl, tw);
  __syncthreads();
  // the stages (constant ones at the main path's M = 256)
  const float2* Z = M == 256 ? stages_pow2<128, 1, true>(b0, b1, nf, tw)
                             : run_stages<false, 8, true>(b0, b1, nf, pl, tw);
  float* v = reinterpret_cast<float*>(Z == b0 ? b1 : b0);   // row f: frame tf_b - (mr - 1) + f
  unpack<true>(v, Z, nf, pl);
  __syncthreads();

  // sample (fb, d) takes frames tf_b + fb - jj, jj < mr: rows fb + mr - 1 - jj
  float* yc = y + static_cast<long long>(c) * out_len;
  for (int e = threadIdx.x; e < F * D; e += blockDim.x) {
    const int fb = by_d.div(e), d = e - fb * D;
    const long long j = (tf_b + fb) * D + d - start;
    if (j < 0 || j >= out_len) continue;
    const float* row = v + (fb + mr - 1) * M;
    float acc = 0.f;
    int q = d;   // (jj D + d) mod M = (jj mod r) D + d
#pragma unroll 4
    for (int jj = 0; jj < mr; ++jj) {
      acc = fmaf(__ldg(gf + d + jj * D), row[q], acc);
      row -= M;
      q += D;
      if (q >= M) q -= M;
    }
    yc[j] = acc;
  }
}

// ---- through device memory --------------------------------------------------

// Rows t_lo .. t_lo + nrows - 1 of the frames' inverse transforms into v
// (C, nrows, M), tiles of F rows (grid-stride).  The buffers: shared memory
// after the twiddle table (M entries, when `table`), or 2 padded(F n)
// points a block at gbuf; kHeldLayout: one frame a block in one buffer,
// the stages held in registers.
template <bool kHeldLayout>
__global__ void __launch_bounds__(kHeldLayout ? kThreadsH : kThreadsS)
synthesis_idft_kernel(const float2* __restrict__ A, float* __restrict__ v, int C, int T, int M,
                      long long t_lo, int nrows, int F, int table, Plan pl,
                      float2* __restrict__ gbuf) {
  extern __shared__ __align__(16) float2 smem[];
  constexpr bool kPad = !kHeldLayout;
  const int n = pl.n, K = M / 2 + 1, ntile = (nrows + F - 1) / F;
  const int nb = kPad ? padded(F * n) : F * n;
  float2* b0 = gbuf ? gbuf + 2ll * nb * blockIdx.x : smem + (table ? M : 0);
  float2* b1 = b0 + nb;
  const Twiddle tw{smem, M, table != 0};
  if (table) {
    for (int j = threadIdx.x; j < M; j += blockDim.x) smem[j] = twiddle(j, M);
    __syncthreads();
  }
  for (int tile = blockIdx.x; tile < C * ntile; tile += gridDim.x) {
    const int c = tile / ntile, f0 = (tile - c * ntile) * F, nf = min(F, nrows - f0);
    pack<kPad>(b0, A + static_cast<long long>(c) * T * K, T, M, t_lo + f0, nf, pl, tw);
    __syncthreads();
    const float2* Z = run_stages<kHeldLayout, 8, kPad>(b0, b1, nf, pl, tw);
    unpack<kPad>(v + (static_cast<long long>(c) * nrows + f0) * M, Z, nf, pl);
    __syncthreads();   // the buffers are free for the next tile
  }
}

// The overlap-add from the rows, as frame rho's scatter read backwards:
// y[c][j] = sum over rows rho of gf[p] v[rho][p mod M], p = s - rho D in
// [0, L), padded-stream sample s = start + j, summed in double over rho
// ascending.  A warp takes 32 consecutive samples and walks the rows their
// terms lie in: at a row, its lanes read 32 consecutive columns (p mod M
// steps by one from sample to sample), so every read is coalesced (a warp
// a sample, its lanes over the terms, read one row a lane).  Where a warp
// has many rows (m r large and D small: M = 4096, r = 4096 gives 32,768),
// split z of nsplit takes a share of them and writes its partial sums to
// part (nsplit, C, out_len); synthesis_ola_sum_kernel then adds them in
// split order, a fixed order.  grid (ceil(out_len / 256), C, nsplit), 256
// threads.
__global__ void __launch_bounds__(256)
synthesis_ola_kernel(const float* __restrict__ v, const float* __restrict__ gf,
                     float* __restrict__ y, double* __restrict__ part, int T, int M, int m, int D,
                     long long t_lo, int nrows, long long start, int out_len, int nsplit) {
  const int lane = threadIdx.x % 32, c = blockIdx.y, z = blockIdx.z;
  const long long j0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x - lane;
  if (j0 >= out_len) return;   // the whole warp
  const long long j = j0 + lane, s = start + j, L = static_cast<long long>(m) * M;
  const long long last = start + (j0 + 31 < out_len ? j0 + 31 : out_len - 1);
  // the warp's rows: frames whose span [rho D, rho D + L) meets its samples
  const long long lo = start + j0 - L + 1;
  long long r_lo = lo >= 0 ? (lo + D - 1) / D : 0;
  r_lo = r_lo > t_lo ? r_lo : t_lo;
  long long r_hi = last / D;
  r_hi = r_hi < t_lo + nrows - 1 ? r_hi : t_lo + nrows - 1;
  r_hi = r_hi < T - 1 ? r_hi : T - 1;
  const long long per = (r_hi - r_lo + nsplit) / nsplit;
  const long long a = r_lo + z * per;
  const long long b = a + per - 1 < r_hi ? a + per - 1 : r_hi;
  double acc = 0.0;
  if (j < out_len && a <= b) {
    long long p = s - a * D;
    long long q = p % M;   // p mod M, stepped with p
    if (q < 0) q += M;
    const float* row = v + (static_cast<long long>(c) * nrows + (a - t_lo)) * M;
    for (long long rho = a; rho <= b; ++rho) {
      if (p >= 0 && p < L)
        acc = fma(static_cast<double>(__ldg(gf + p)), static_cast<double>(__ldg(row + q)), acc);
      p -= D;
      q -= D;
      if (q < 0) q += M;
      row += M;
    }
  }
  if (j >= out_len) return;
  if (nsplit == 1)
    y[static_cast<long long>(c) * out_len + j] = static_cast<float>(acc);
  else
    part[(static_cast<long long>(z) * gridDim.y + c) * out_len + j] = acc;
}

// y = the sum of the nsplit partials, in split order.  n = C out_len.
__global__ void __launch_bounds__(256)
synthesis_ola_sum_kernel(const double* __restrict__ part, float* __restrict__ y, long long n,
                         int nsplit) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double acc = 0.0;
  for (int z = 0; z < nsplit; ++z) acc += part[z * n + e];
  y[e] = static_cast<float>(acc);
}

// ---- the launch --------------------------------------------------------------

// route 0: tiles of F output frames from tf0 (grid tiles x C); route 1: the
// IDFT of rows t_lo .. t_lo + nrows - 1 into the scratch (layout 0: F rows
// a block in shared memory, 1: a block a row with the stages held, 2: a
// block a row with its buffers in the scratch after the rows; grid blocks),
// then the overlap-add.  scratch: floats of device memory the call needs.
struct SynLaunch {
  int route, layout, F, table, nsplit;
  long long grid, t0, nrows, scratch, gbuf, part;   // t0: tf0 (route 0) or t_lo; gbuf, part: offsets, floats
  size_t smem;
};

// Points a padded buffer of np points spans, in 64 bits.
long long padded_ll(long long np) { return np + (np + 15) / 16; }

// The IDFT's launch over `frames` rows (of nrows a channel): tiles of F
// rows (at most kSynTilePoints points), F smaller while the grid has fewer
// than kIdftBlocksPerSm blocks an SM, at most that many blocks, striding
// over the tiles so each fills its twiddle table once for many; layout 0
// in shared memory, else 1 a block a row with the stages held, else 2 the
// buffers in device memory.
void idft_layout(long long frames, long long nrows, long long n, long long tab, int budget,
                 int sms, const Plan& pl, SynLaunch* ln) {
  const long long blocks = static_cast<long long>(kIdftBlocksPerSm) * sms;
  long long F = n < kSynTilePoints ? kSynTilePoints / n : 1;
  const long long spread = (frames + blocks - 1) / blocks;
  F = F < spread ? F : spread;
  F = F < nrows ? F : nrows;
  F = F > 1 ? F : 1;
  for (int table = 1; table >= 0; --table) {
    const long long smem = 16 * padded_ll(F * n) + (table ? tab : 0);
    if (smem <= budget) {
      ln->layout = 0;
      ln->F = static_cast<int>(F);
      ln->table = table;
      ln->grid = frames / nrows * ((nrows + F - 1) / F);
      ln->grid = ln->grid < blocks ? ln->grid : blocks;
      ln->smem = static_cast<size_t>(smem);
      return;
    }
  }
  ln->F = 1;
  ln->grid = frames < blocks ? frames : blocks;
  if (held_fits(pl))
    for (int table = 1; table >= 0; --table) {
      const long long smem = 8 * n + (table ? tab : 0);
      if (smem <= budget) {
        ln->layout = 1;
        ln->table = table;
        ln->smem = static_cast<size_t>(smem);
        return;
      }
    }
  ln->layout = 2;
  ln->grid = frames < 2ll * sms ? frames : 2ll * sms;
  ln->table = tab <= budget;
  ln->smem = ln->table ? static_cast<size_t>(tab) : 0;
}

int synthesis_plan(int C, int M, int m, int D, long long start, int out_len, const Plan& pl,
                   SynLaunch* ln) {
  int budget, sms;
  const int rc = smem_budget(&budget, &sms);
  if (rc) return rc;
  const long long n = pl.n, mr = static_cast<long long>(m) * (M / D), tab = 8ll * M;
  const long long tf0 = start / D, tf1 = (start + out_len - 1) / D, fo = tf1 - tf0 + 1;
  *ln = SynLaunch{};
  // tiles: about one block an SM, at most kSynTilePoints points (or F = 1)
  long long F = (C * fo + sms - 1) / sms;
  const long long cap = kSynTilePoints / n - mr + 1;
  F = F < cap ? F : cap;
  F = F < fo ? F : fo;
  F = F > 1 ? F : 1;
  for (;;) {
    for (int table = 1; table >= 0; --table) {
      const long long smem = 16 * padded_ll((F + mr - 1) * n) + (table ? tab : 0);
      if (smem <= budget) {
        ln->route = 0;
        ln->F = static_cast<int>(F);
        ln->table = table;
        ln->t0 = tf0;
        ln->grid = (fo + F - 1) / F;
        ln->smem = static_cast<size_t>(smem);
        return 0;
      }
    }
    if (F == 1) break;
    F = (F + 1) / 2;
  }
  // through device memory: every frame the samples read
  ln->route = 1;
  ln->t0 = tf0 - mr + 1 > 0 ? tf0 - mr + 1 : 0;
  ln->nrows = tf1 - ln->t0 + 1;
  ln->scratch = (C * ln->nrows * M + 3) & ~3ll;   // the rows; what follows 16-byte aligned
  idft_layout(C * ln->nrows, ln->nrows, n, tab, budget, sms, pl, ln);
  if (ln->layout == 2) {   // two padded buffers of n complex points a block
    ln->gbuf = ln->scratch;
    ln->scratch += 4 * padded_ll(n) * ln->grid;
  }
  // the overlap-add: a warp's rows split so the grid has about kOlaWarpsPerSm
  // warps an SM, each keeping at least kOlaRowsMin rows
  const long long warps = C * ((out_len + 31) / 32);
  const long long rows = mr + 31 / D + 1, want = static_cast<long long>(kOlaWarpsPerSm) * sms;
  long long split = (want + warps - 1) / warps;
  const long long most = (rows + kOlaRowsMin - 1) / kOlaRowsMin;
  split = split < most ? split : most;
  ln->nsplit = static_cast<int>(split < 65535 ? split : 65535);
  if (ln->nsplit > 1) {   // the partial sums, doubles
    ln->part = ln->scratch;
    ln->scratch += 2ll * ln->nsplit * C * out_len;
  }
  return 0;
}

int plan_for(int C, int M, int m, int D, long long start, int out_len, Plan* pl, SynLaunch* ln) {
  if (C < 1 || M < 1 || D < 1 || out_len < 1) return kNoFit;
  make_plan(M, pl, 8);
  if (pl->nst > kMaxStages) return kNoFit;
  return synthesis_plan(C, M, m, D, start, out_len, *pl, ln);
}

}  // namespace

extern "C" {

// The device-memory scratch (floats) dsr_fb_synthesis needs for these
// arguments, in *floats (0 for the tile route).  0, kNoFit, or a CUDA error.
int dsr_fb_synthesis_scratch(int C, int M, int m, int D, long long start, int out_len,
                             long long* floats) {
  Plan pl;
  SynLaunch ln;
  const int rc = plan_for(C, M, m, D, start, out_len, &pl, &ln);
  *floats = rc ? 0 : ln.scratch;
  return rc;
}

// A: (C, T, K) complex64, gf: (L,) float32, y: (C, out_len) float32;
// y[c, j] is padded-stream sample start + j (start >= 0); scratch: the
// floats dsr_fb_synthesis_scratch asks for, or null when it asks for none.
int dsr_fb_synthesis(const float2* A, const float* gf, float* y, float* scratch, int C, int T,
                     int M, int m, int D, long long start, int out_len, void* stream) {
  Plan pl;
  SynLaunch ln;
  int rc = plan_for(C, M, m, D, start, out_len, &pl, &ln);
  if (rc) return rc;
  if (ln.scratch > 0 && scratch == nullptr) return kNoFit;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln.route == 0) {
    rc = set_smem(reinterpret_cast<const void*>(synthesis_kernel), ln.smem);
    if (rc) return rc;
    synthesis_kernel<<<dim3(static_cast<unsigned>(ln.grid), C), kThreadsS, ln.smem, st>>>(
        A, gf, y, T, M, m, D, ln.F, ln.t0, start, out_len, ln.table, pl,
        FastDiv(static_cast<unsigned>(D)));
    return static_cast<int>(cudaGetLastError());
  }
  const bool held = ln.layout == 1;
  const auto idft = held ? synthesis_idft_kernel<true> : synthesis_idft_kernel<false>;
  rc = set_smem(reinterpret_cast<const void*>(idft), ln.smem);
  if (rc) return rc;
  float2* gbuf = ln.layout == 2 ? reinterpret_cast<float2*>(scratch + ln.gbuf) : nullptr;
  idft<<<static_cast<unsigned>(ln.grid), held ? kThreadsH : kThreadsS, ln.smem, st>>>(
      A, scratch, C, T, M, ln.t0, static_cast<int>(ln.nrows), ln.F, ln.table, pl, gbuf);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  double* part = ln.nsplit > 1 ? reinterpret_cast<double*>(scratch + ln.part) : nullptr;
  synthesis_ola_kernel<<<dim3(static_cast<unsigned>((out_len + 255) / 256), C, ln.nsplit), 256, 0,
                         st>>>(scratch, gf, y, part, T, M, m, D, ln.t0, static_cast<int>(ln.nrows),
                               start, out_len, ln.nsplit);
  if (ln.nsplit == 1) return static_cast<int>(cudaGetLastError());
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const long long total = static_cast<long long>(C) * out_len;
  synthesis_ola_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      part, y, total, ln.nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
