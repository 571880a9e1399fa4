// Oversampled DFT filterbank synthesis for Hopper (sm_90a).  (The analysis
// and the fused analysis + beamform are FFTs, csrc/analysis.cu.)  Plain C
// interface, loaded with ctypes by dsr_tpu_torch/ops/cuda/filterbank.py;
// the entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or kNoFit: never for a valid config).
//
// Conventions (the same as dsr_tpu/ops/filterbank.py): M subbands, prototype
// length L = m*M, hop D = M/r, K = M/2+1 bins, front pad P = L-D.  Synthesis
// is the irfft of each frame, windowed by gf and overlap-added at hop D;
// output sample j is the padded-stream sample start + j.  The kernels are
// D-parametric: one kernel serves all (M, m, r), where the TPU needed a
// D == 128 kernel and a general one.
//
// Replaces (dsr_tpu/ops/pallas/filterbank.py) _synthesis_kernel_v5 and
// _synthesis_kernel.
//
// What bounds it on this card: the IDFT is evaluated directly, O(M) per
// sample index, as the TPU kernels did with matmuls; at M = 256 that is
// far above the card's flop/byte balance, so operations bound it, while the
// function itself needs only a real FFT per frame and its least time is set
// by bytes (chip_smoke.py prints both).  This version runs the direct IDFT
// as FP32 FMAs on the CUDA cores, as small register-tiled matrix products
// out of shared memory:
//   - each block builds its samples' IDFT columns once, from a length-M
//     twiddle table indexed by (n*k) mod M;
//   - a thread owns 1 frame x 8 IDFT indices in registers, so each
//     shared-memory load feeds several FMAs (measured on the card, the loop
//     is bound by instruction issue rather than by shared-memory bandwidth);
//   - the blocks split each tile's samples by residue mod D, so a short
//     output still spreads over the card, and do the overlap-add as a
//     gather from shared memory: no atomics, a deterministic result.
//
// A config whose block does not fit shared memory that way (M >= 768, large
// m r^2) runs the "slab" kernel below: the IDFT sum over bins in slabs,
// with fewer residues per block when needed; without room for the twiddle
// table (M above ~20,000), each IDFT entry is computed directly, with the
// same sincospi, so the same value.  The main path's configs never reach
// it, so its kernel keeps the simpler layout and its register budget.
// A synthesis whose slab block cannot hold the frames' IDFT (m r^2 above
// ~7,000, e.g. M = 256 m = 8 r = 32) takes two kernels through device
// memory: every frame's IDFT at all M indices into the caller's scratch,
// then the overlap-add as a gather, one warp per output sample.  (A slab
// block holds the IDFT of the m r frames behind its samples, so its blocks
// recompute each frame's IDFT about m r / (its tile's frames) times, and
// holding that IDFT in device memory would need, at M = 4096 m = 8 r =
// 4096, 4 GB per block.)

#include <cuda_runtime.h>

namespace {

constexpr int kNoFit = -1;        // returned when the config's tile exceeds shared memory

// ---- geometry --------------------------------------------------------------
constexpr int kThreadsS = 256;    // 32 frames (lanes) x 8 warps of 8 samples
constexpr int kDS = 32;           // residues mod D per block

// tw[j] = (cos 2 pi j / M, sin 2 pi j / M); sincospi in double keeps the
// exact zeros (sin at j = M/2, cos at j = M/4) that irfft relies on.
__device__ void fill_twiddles(float2* tw, int M) {
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * j / M, &s, &c);
    tw[j] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
}

// ---- synthesis ------------------------------------------------------------
// A block produces the padded-stream samples s = (b*nt + fb)*D + d for
// fb < nt and d in its residue group [d0, d0 + kDS), from the nf = nt+mr-1
// frames overlapping them.  Sample s takes frame floor(s/D) - jj (jj < mr)
// at offset d + jj*D, whose IDFT index is d + (jj mod r)*D: so the block
// needs the IDFT at NQ = r*kDS indices n only.
__host__ __device__ int synthesis_frames(int mr) { return 32 * ((mr + 15) / 16); }

struct SynthLayout {
  int K, NQ, nf, AS, VS;
  int fs, as, v, tw, total;  // offsets (floats)
  __host__ __device__ SynthLayout(int M, int m, int D) {
    const int r = M / D, mr = m * r;
    K = M / 2 + 1;
    NQ = r * kDS;
    nf = synthesis_frames(mr);
    AS = 2 * nf + 4;   // spectra row stride: float4-aligned, fewer bank conflicts
    VS = NQ + 1;
    fs = 0;                       // Fs (K, 2*NQ): [cos, sin] of 2 pi n k / M
    as = fs + K * 2 * NQ;         // AsT (K, AS): irfft-scaled spectra, [re, im] per frame
    v = as + K * AS;              // v (nf, VS): the frames' IDFT at the block's indices
    tw = v + ((nf * VS + 1) & ~1);
    total = tw + 2 * M;
  }
};

// grid (tiles, C, residue groups).  A: (C, T, K) complex, y: (C, out_len).
__global__ void __launch_bounds__(kThreadsS)
synthesis_kernel(const float2* __restrict__ A, const float* __restrict__ gf,
                 float* __restrict__ y, int T, int M, int m, int D, int b0,
                 long long start, int out_len) {
  extern __shared__ __align__(16) float smem[];
  const SynthLayout lay(M, m, D);
  const int K = lay.K, NQ = lay.NQ, nf = lay.nf, AS = lay.AS, VS = lay.VS;
  const int r = M / D, mr = m * r, nt = nf - mr + 1;
  float* Fs = smem + lay.fs;
  float* AsT = smem + lay.as;
  float* v = smem + lay.v;
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  const int c = blockIdx.y, d0 = blockIdx.z * kDS;
  const long long b = b0 + blockIdx.x;
  const long long tfirst = b * nt - (mr - 1);   // frame of local row 0
  const int tid = threadIdx.x;

  fill_twiddles(tw, M);
  // irfft scale folded into the staged spectra: 1/M at DC and (M even)
  // Nyquist, 2/M elsewhere.  Frames outside [0, T) are zero.
  const float2* Ac = A + static_cast<long long>(c) * T * K;
  for (int e = tid; e < nf * K; e += blockDim.x) {
    const int fl = e / K;
    const int k = e - fl * K;
    const long long t = tfirst + fl;
    float2 a = make_float2(0.f, 0.f);
    if (t >= 0 && t < T) {
      a = Ac[t * K + k];
      const float s = (k == 0 || 2 * k == M) ? 1.f / M : 2.f / M;
      a.x *= s;
      a.y *= s;
    }
    *reinterpret_cast<float2*>(AsT + k * AS + 2 * fl) = a;
  }
  __syncthreads();
  for (int e = tid; e < K * NQ; e += blockDim.x) {
    const int k = e / NQ;
    const int nl = e - k * NQ;
    const int d = d0 + nl % kDS;
    const int n = (nl / kDS) * D + d;
    const float2 t = d < D ? tw[(n * k) % M] : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(Fs + k * 2 * NQ + 2 * nl) = t;
  }
  __syncthreads();

  // v[f][nl] = sum_k Re A[f,k] cos(2 pi n k / M) - Im A[f,k] sin(2 pi n k / M);
  // a thread takes frame `lane` and the warp's 8 indices, so all lanes read
  // the same Fs entries (a broadcast) and neighbouring frames of AsT.
  const int lane = tid % 32, warp = tid / 32;
  for (int fl = lane; fl < nf; fl += 32) {
    for (int nb = warp; 8 * nb < NQ; nb += kThreadsS / 32) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      const float2* ap = reinterpret_cast<const float2*>(AsT) + fl;
      const float4* fq = reinterpret_cast<const float4*>(Fs) + 4 * nb;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float2 a = ap[k * (AS / 2)];
        const float4* f = fq + k * (NQ / 2);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 fk = f[q];
          acc[2 * q] = fmaf(a.x, fk.x, fmaf(-a.y, fk.y, acc[2 * q]));
          acc[2 * q + 1] = fmaf(a.x, fk.z, fmaf(-a.y, fk.w, acc[2 * q + 1]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) v[fl * VS + 8 * nb + j] = acc[j];
    }
  }
  __syncthreads();

  // Overlap-add as a gather: sample s = (b*nt + fb)*D + d takes frames
  // floor(s/D) - jj, jj < mr, local row fb + mr - 1 - jj.
  float* yc = y + static_cast<long long>(c) * out_len;
  for (int e = tid; e < nt * kDS; e += blockDim.x) {
    const int fb = e / kDS;
    const int dl = e - fb * kDS;
    const int d = d0 + dl;
    const long long j_out = (b * nt + fb) * D + d - start;
    if (d >= D || j_out < 0 || j_out >= out_len) continue;
    float acc = 0.f;
    for (int jj = 0; jj < mr; ++jj)
      acc = fmaf(__ldg(gf + d + jj * D), v[(fb + mr - 1 - jj) * VS + (jj % r) * kDS + dl], acc);
    yc[j_out] = acc;
  }
}

// ---- slab kernel: configs whose block does not fit as above ----------------

// (cos, sin) of 2 pi idx / M: the table entry (kTable), or the same
// sincospi that filled the table.
template <bool kTable>
__device__ __forceinline__ float2 twiddle(const float2* tw, int idx, int M) {
  if constexpr (kTable) {
    return tw[idx];
  } else {
    double sn, cs;
    sincospi(2.0 * idx / M, &sn, &cs);
    return make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
}

// synthesis_kernel in slabs of KS bins, each slab's spectra and DFT columns
// staged in turn and its part added to the frames' IDFT v; ds residues per
// block (a power of two, 8 to kDS).  The layout, in floats of shared memory:
//   Fs  (KS, 2 NQ)  [cos, sin] of 2 pi n k / M for the slab's bins
//   AsT (KS, AS)    the slab's irfft-scaled spectra, [re, im] per frame
//   v   (nf, VS)    the frames' IDFT at the block's indices
//   tw  (2M)        the twiddle table, when use_tw
struct SynLayout {
  int ds, nf, KS, use_tw;
  int ds_shift, NQ, AS, VS, as, v, tw, total;  // log2(ds), sizes, offsets (floats)
  __host__ __device__ SynLayout() {}
  __host__ __device__ SynLayout(int M, int r, int ds_, int nf_, int KS_, int use_tw_)
      : ds(ds_), nf(nf_), KS(KS_), use_tw(use_tw_) {
    for (ds_shift = 0; (1 << ds_shift) < ds; ++ds_shift) {
    }
    NQ = r * ds;
    AS = 2 * nf + 4;
    VS = NQ + 1;
    as = KS * 2 * NQ;
    v = as + KS * AS;
    tw = v + ((nf * VS + 1) & ~1);
    total = tw + (use_tw ? 2 * M : 0);
  }
};

// grid (tiles, C, residue groups).  A: (C, T, K) complex, y: (C, out_len).
template <bool kTable>
__global__ void __launch_bounds__(kThreadsS)
synthesis_slab_kernel(const float2* __restrict__ A, const float* __restrict__ gf,
                      float* __restrict__ y, int T, int M, int m, int D, int b0,
                      long long start, int out_len, SynLayout lay) {
  extern __shared__ __align__(16) float smem[];
  const int K = M / 2 + 1, NQ = lay.NQ, nf = lay.nf, AS = lay.AS, VS = lay.VS, ds = lay.ds;
  const int r = M / D, mr = m * r, nt = nf - mr + 1;
  float* Fs = smem;
  float* AsT = smem + lay.as;
  float* v = smem + lay.v;
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  const int c = blockIdx.y, d0 = blockIdx.z * ds;
  const long long b = b0 + blockIdx.x;
  const long long tfirst = b * nt - (mr - 1);   // frame of local row 0
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float2* Ac = A + static_cast<long long>(c) * T * K;

  if constexpr (kTable) fill_twiddles(tw, M);
  for (int ka = 0; ka < K; ka += lay.KS) {
    const int ks = min(lay.KS, K - ka);
    __syncthreads();   // the twiddles are in place; the last slab is read
    for (int e = tid; e < nf * ks; e += blockDim.x) {
      const int fl = e / ks;
      const int kl = e - fl * ks;
      const int k = ka + kl;
      const long long t = tfirst + fl;
      float2 a = make_float2(0.f, 0.f);
      if (t >= 0 && t < T) {
        a = Ac[t * K + k];
        const float sc = (k == 0 || 2 * k == M) ? 1.f / M : 2.f / M;
        a.x *= sc;
        a.y *= sc;
      }
      *reinterpret_cast<float2*>(AsT + kl * AS + 2 * fl) = a;
    }
    for (int e = tid; e < ks * NQ; e += blockDim.x) {
      const int kl = e / NQ;
      const int nl = e - kl * NQ;
      const int d = d0 + (nl & (ds - 1));
      const int n = (nl >> lay.ds_shift) * D + d;
      const float2 t = d < D ? twiddle<kTable>(tw, static_cast<int>(
                                              static_cast<long long>(n) * (ka + kl) % M), M)
                             : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(Fs + kl * 2 * NQ + 2 * nl) = t;
    }
    __syncthreads();
    for (int fl = lane; fl < nf; fl += 32) {
      for (int nb = warp; 8 * nb < NQ; nb += kThreadsS / 32) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        const float2* ap = reinterpret_cast<const float2*>(AsT) + fl;
        const float4* fq = reinterpret_cast<const float4*>(Fs) + 4 * nb;
#pragma unroll 2
        for (int k = 0; k < ks; ++k) {
          const float2 a = ap[k * (AS / 2)];
          const float4* f = fq + k * (NQ / 2);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 fk = f[q];
            acc[2 * q] = fmaf(a.x, fk.x, fmaf(-a.y, fk.y, acc[2 * q]));
            acc[2 * q + 1] = fmaf(a.x, fk.z, fmaf(-a.y, fk.w, acc[2 * q + 1]));
          }
        }
        float* vp = v + fl * VS + 8 * nb;
#pragma unroll
        for (int j = 0; j < 8; ++j) vp[j] = ka == 0 ? acc[j] : vp[j] + acc[j];
      }
    }
  }
  __syncthreads();

  float* yc = y + static_cast<long long>(c) * out_len;
  for (int e = tid; e < nt * ds; e += blockDim.x) {
    const int fb = e >> lay.ds_shift;
    const int dl = e - fb * ds;
    const int d = d0 + dl;
    const long long j_out = (b * nt + fb) * D + d - start;
    if (d >= D || j_out < 0 || j_out >= out_len) continue;
    float acc = 0.f;
    for (int jj = 0; jj < mr; ++jj)
      acc = fmaf(__ldg(gf + d + jj * D), v[(fb + mr - 1 - jj) * VS + (jj % r) * ds + dl], acc);
    yc[j_out] = acc;
  }
}

// ---- synthesis through device memory ---------------------------------------
// For configs whose slab block does not fit (m r^2 above ~7,000).  Rows t_lo ..
// t_lo + nrows - 1 of the frames' IDFT go to v (C, nrows, M) in device
// memory; frames outside [0, T) are zero.
constexpr int kGF = 32;    // frames per IDFT block
constexpr int kGN = 256;   // IDFT indices per block, one per thread
constexpr int kGK = 32;    // bins per staged slab of spectra

// v[c][f][n] = sum_k Re A cos(2 pi n k / M) - Im A sin(2 pi n k / M), A
// irfft-scaled.  grid (row tiles, index groups, C).  A thread owns index n
// and kGF frames; the block's spectra slab is read as a broadcast.
template <bool kTable>
__global__ void __launch_bounds__(kGN)
synthesis_idft_kernel(const float2* __restrict__ A, float* __restrict__ v, int T, int M,
                      long long t_lo, int nrows) {
  extern __shared__ __align__(16) float smem[];
  float2* As = reinterpret_cast<float2*>(smem);   // (kGK, kGF)
  float2* tw = As + kGK * kGF;                     // (M,), kTable
  const int K = M / 2 + 1, c = blockIdx.z, f0 = blockIdx.x * kGF;
  const int n = blockIdx.y * kGN + threadIdx.x;
  const int step = n < M ? n : 0;
  const float2* Ac = A + static_cast<long long>(c) * T * K;
  if constexpr (kTable) fill_twiddles(tw, M);
  float acc[kGF];
#pragma unroll
  for (int f = 0; f < kGF; ++f) acc[f] = 0.f;
  int idx = 0;   // (n k) mod M, stepped by n
  for (int ka = 0; ka < K; ka += kGK) {
    const int ks = min(kGK, K - ka);
    __syncthreads();   // the twiddles are in place; the last slab is read
    for (int e = threadIdx.x; e < kGK * kGF; e += blockDim.x) {
      const int kl = e / kGF, fl = e - kl * kGF;
      const long long t = t_lo + f0 + fl;
      float2 a = make_float2(0.f, 0.f);
      if (kl < ks && f0 + fl < nrows && t >= 0 && t < T) {
        const int k = ka + kl;
        a = Ac[t * K + k];
        const float sc = (k == 0 || 2 * k == M) ? 1.f / M : 2.f / M;
        a.x *= sc;
        a.y *= sc;
      }
      As[e] = a;
    }
    __syncthreads();
    const float4* a4 = reinterpret_cast<const float4*>(As);
    for (int kl = 0; kl < ks; ++kl) {
      const float2 t = twiddle<kTable>(tw, idx, M);
      idx += step;
      if (idx >= M) idx -= M;
#pragma unroll
      for (int f = 0; f < kGF; f += 2) {
        const float4 a = a4[(kl * kGF + f) / 2];
        acc[f] = fmaf(a.x, t.x, fmaf(-a.y, t.y, acc[f]));
        acc[f + 1] = fmaf(a.z, t.x, fmaf(-a.w, t.y, acc[f + 1]));
      }
    }
  }
  if (n >= M) return;
  float* vc = v + static_cast<long long>(c) * nrows * M;
#pragma unroll
  for (int f = 0; f < kGF; ++f)
    if (f0 + f < nrows) vc[static_cast<long long>(f0 + f) * M + n] = acc[f];
}

// y[c][j] = sum_{jj < mr} gf[d + jj D] v[t - jj][(jj mod r) D + d], padded-
// stream sample s = start + j = t D + d; one warp per sample, its lanes
// taking jj = lane, lane + 32, ..., summed in double (the sum has up to m r
// terms; the gather reads device memory, so the double adds cost nothing
// measurable).  grid (ceil(out_len / 8), C), 256 threads.
__global__ void __launch_bounds__(256)
synthesis_ola_kernel(const float* __restrict__ v, const float* __restrict__ gf,
                     float* __restrict__ y, int T, int M, int m, int D, long long t_lo,
                     int nrows, long long start, int out_len) {
  const long long j = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32, c = blockIdx.y;
  if (j >= out_len) return;
  const long long s = start + j, tf = s / D;
  const int d = static_cast<int>(s - tf * D), r = M / D, mr = m * r;
  const float* vc = v + static_cast<long long>(c) * nrows * M;
  double acc = 0.0;   // up to m r terms a sample (32,768 at M = 4096 r = 4096)
  for (int jj = lane; jj < mr; jj += 32) {
    const long long t = tf - jj;
    if (t < 0) break;
    if (t < T)
      acc = fma(static_cast<double>(__ldg(gf + d + jj * D)),
                static_cast<double>(__ldg(vc + (t - t_lo) * M + (jj % r) * D + d)), acc);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) y[static_cast<long long>(c) * out_len + j] = static_cast<float>(acc);
}

// The rows of the frames' IDFT the samples [start, start + out_len) need:
// frames t_lo .. floor((start + out_len - 1) / D).
void synthesis_rows(int M, int m, int D, long long start, int out_len, long long* t_lo,
                    long long* nrows) {
  const long long mr = static_cast<long long>(m) * (M / D);
  const long long tf0 = start / D, tf1 = (start + out_len - 1) / D;
  *t_lo = tf0 - mr + 1 > 0 ? tf0 - mr + 1 : 0;
  *nrows = tf1 - *t_lo + 1;
}

// The largest dynamic shared memory a block of this device may opt in to.
int smem_optin(int* bytes) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// Whether a slab block fits at all: its smallest layout (one bin per slab,
// 8 residues, mr frames, no twiddle table), counted in 64 bits.  Above it
// the layouts' int offsets could overflow, and neither block fits.
bool synthesis_block_fits(int M, int m, int D, int budget) {
  const long long r = M / D, mr = m * r;
  return 16 * r + 2 * mr + 4 + mr * (8 * r + 1) <= budget;
}

// The slab synthesis layout, in order of preference: the twiddle table, 32
// residues per block, tiles of synthesis_frames(mr) frames, and the most
// bins per slab; the first choice with slabs of at least min(K, 32) bins,
// else the first that fits at all.  0 and the layout, kNoFit, or a CUDA
// error.
int synthesis_slab_layout(int M, int m, int D, SynLayout* lay) {
  int optin;
  const int rc = smem_optin(&optin);
  if (rc) return rc;
  const int budget = optin / 4;
  if (!synthesis_block_fits(M, m, D, budget)) return kNoFit;
  const int r = M / D, mr = m * r, K = M / 2 + 1;
  const int frames[2] = {synthesis_frames(mr), mr};
  for (int pass = 0; pass < 2; ++pass) {
    const int want = pass == 0 ? (K < 32 ? K : 32) : 1;
    for (int use_tw = 1; use_tw >= 0; --use_tw)
      for (int ds = kDS; ds >= 8; ds /= 2)
        for (int fi = 0; fi < 2; ++fi) {
          const SynLayout one(M, r, ds, frames[fi], 1, use_tw);
          const int per = 2 * one.NQ + one.AS;
          int ks = (budget - (one.total - per)) / per;
          ks = ks < K ? ks : K;
          if (ks >= want) {
            *lay = SynLayout(M, r, ds, frames[fi], ks, use_tw);
            return 0;
          }
        }
  }
  return kNoFit;
}

// The synthesis's launch: whole-IDFT block (*slab = 0), slab layout (1),
// or the two kernels through device memory (2); grid (tiles, C, residue
// groups) from tile b0 on (for 2: b0 is the first IDFT row t_lo and the
// grid is unused), shared memory in bytes, and the device-memory scratch
// in floats (for 2: the frames' IDFT rows; 0 otherwise).  0 or a CUDA
// error.
int synthesis_plan(int C, int M, int m, int D, long long start, int out_len, int* slab,
                   SynLayout* lay, dim3* grid, long long* b0, size_t* smem,
                   long long* scratch) {
  int optin;
  int rc = smem_optin(&optin);
  if (rc) return rc;
  *scratch = 0;
  int nf = 0, ds = kDS;
  rc = kNoFit;
  if (synthesis_block_fits(M, m, D, optin / 4)) {
    const SynthLayout whole(M, m, D);
    *slab = 4ull * whole.total > static_cast<size_t>(optin);
    nf = whole.nf;
    *smem = 4ull * whole.total;
    rc = *slab ? synthesis_slab_layout(M, m, D, lay) : 0;
    if (rc && rc != kNoFit) return rc;
    if (*slab && rc == 0) {
      nf = lay->nf;
      ds = lay->ds;
      *smem = 4ull * lay->total;
    }
  }
  if (rc == kNoFit) {   // no block holds it: the frames' IDFT in device memory
    long long t_lo, nrows;
    synthesis_rows(M, m, D, start, out_len, &t_lo, &nrows);
    *slab = 2;
    *b0 = t_lo;
    *scratch = static_cast<long long>(C) * nrows * M;
    *smem = 8ull * (kGK * kGF + (8ull * (M + kGK * kGF) <= static_cast<size_t>(optin) ? M : 0));
    return 0;
  }
  const int mr = m * M / D;
  const long long tile = static_cast<long long>(nf - mr + 1) * D;
  *b0 = start / tile;
  const long long b1 = (start + out_len - 1) / tile;
  *grid = dim3(static_cast<unsigned>(b1 - *b0 + 1), C, (D + ds - 1) / ds);
  return 0;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// The device-memory scratch (floats) dsr_fb_synthesis needs for these
// arguments, in *floats (0 for most configs).  0, kNoFit, or a CUDA error.
int dsr_fb_synthesis_scratch(int C, int M, int m, int D, long long start, int out_len,
                             long long* floats) {
  int slab;
  SynLayout lay;
  dim3 grid;
  long long b0;
  size_t smem;
  return synthesis_plan(C, M, m, D, start, out_len, &slab, &lay, &grid, &b0, &smem, floats);
}

// A: (C, T, K) complex64, gf: (L,) float32, y: (C, out_len) float32;
// y[c, j] is padded-stream sample start + j (start >= 0); scratch: the
// floats dsr_fb_synthesis_scratch asks for, or null when it asks for none.
int dsr_fb_synthesis(const float2* A, const float* gf, float* y, float* scratch, int C, int T,
                     int M, int m, int D, long long start, int out_len, void* stream) {
  int slab;
  SynLayout lay;
  dim3 grid;
  long long b0, need;
  size_t smem;
  int rc = synthesis_plan(C, M, m, D, start, out_len, &slab, &lay, &grid, &b0, &smem, &need);
  if (rc) return rc;
  if (need > 0 && scratch == nullptr) return kNoFit;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!slab) {
    rc = set_smem(reinterpret_cast<const void*>(synthesis_kernel), smem);
    if (rc) return rc;
    synthesis_kernel<<<grid, kThreadsS, smem, st>>>(A, gf, y, T, M, m, D, static_cast<int>(b0),
                                                    start, out_len);
  } else if (slab == 2) {
    const long long nrows = need / (static_cast<long long>(C) * M);
    const bool table = smem > 8ull * kGK * kGF;
    auto idft = table ? synthesis_idft_kernel<true> : synthesis_idft_kernel<false>;
    rc = set_smem(reinterpret_cast<const void*>(idft), smem);
    if (rc) return rc;
    idft<<<dim3(static_cast<unsigned>((nrows + kGF - 1) / kGF), (M + kGN - 1) / kGN, C), kGN,
           smem, st>>>(A, scratch, T, M, b0, static_cast<int>(nrows));
    rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    synthesis_ola_kernel<<<dim3(static_cast<unsigned>((out_len + 7) / 8), C), 256, 0, st>>>(
        scratch, gf, y, T, M, m, D, b0, static_cast<int>(nrows), start, out_len);
  } else {
    auto kernel = lay.use_tw ? synthesis_slab_kernel<true> : synthesis_slab_kernel<false>;
    rc = set_smem(reinterpret_cast<const void*>(kernel), smem);
    if (rc) return rc;
    kernel<<<grid, kThreadsS, smem, st>>>(A, gf, y, T, M, m, D, static_cast<int>(b0),
                                          start, out_len, lay);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
