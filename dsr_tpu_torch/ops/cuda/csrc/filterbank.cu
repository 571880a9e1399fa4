// Oversampled DFT filterbank kernels for Hopper (sm_90a): analysis, fused
// analysis + fixed-weight beamform, and synthesis.  Plain C interface,
// loaded with ctypes by dsr_tpu_torch/ops/cuda/filterbank.py; each entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or kNoFit when a config needs more shared memory than
// a block may have).
//
// Conventions (the same as dsr_tpu/ops/filterbank.py): M subbands, prototype
// length L = m*M, hop D = M/r, K = M/2+1 bins, front pad P = L-D.  Frame t
// covers x[t*D - P, t*D - P + L) (zeros outside the signal); its windowed
// samples are folded modulo M and transformed:
//     A[t, k] = sum_{p<M} u[t, p] e^{-2 pi i p k / M},
//     u[t, p] = sum_{q<m} x[t*D - P + q*M + p] hf[q*M + p].
// Synthesis is the irfft of each frame, windowed by gf and overlap-added at
// hop D; output sample j is the padded-stream sample start + j.
//
// Every kernel is D-parametric: one kernel serves all (M, m, r), where the
// TPU needed a D == 128 kernel and a general one.
//
// Replaces (dsr_tpu/ops/pallas/filterbank.py):
//   analysis           <- _analysis_kernel_v5 and _analysis_kernel
//   analysis_beamform  <- _analysis_bf_kernel
//   synthesis          <- _synthesis_kernel_v5 and _synthesis_kernel
//
// What bounds them on this card: the DFTs are evaluated directly, O(M) per
// bin, as the TPU kernels did with matmuls.  At M = 256 that is about 2M
// flops per (frame, bin) against 8 bytes written, far above the card's
// flop/byte balance, so operations bound them.  The functions themselves
// need only a real FFT per frame (about 13x fewer operations at M = 256), so
// their least time is set by bytes, far below these kernels' times
// (chip_smoke.py prints both).  This version runs the direct DFTs as
// FP32 FMAs on the CUDA cores (no tensor cores yet), as small register-tiled
// matrix products out of shared memory:
//   - each block builds its slice of the DFT matrix (its bins' cos/sin rows,
//     or for synthesis its samples' columns) once, from a length-M twiddle
//     table indexed by (p*k) mod M: the full (M, K) tables would not fit a
//     block's shared memory at M = 256;
//   - a thread owns 2 frames x 8 bins (analysis) or 1 frame x 8 IDFT
//     indices (synthesis) in registers, so each shared-memory load feeds 3
//     to 5 FMAs: measured on the card, the loops are bound by instruction
//     issue rather than by shared-memory bandwidth, and this keeps most
//     issued instructions FMAs;
//   - the analysis pairs p with M-p (real input: their twiddles differ only
//     in the sine's sign), which halves its FMAs and its DFT rows;
//   - the analysis splits each DFT sum over 8 thread groups (interleaved p)
//     and adds the partial sums once at the end, which puts 16 warps on an
//     SM even when a call has few frame tiles (the fused kernel has one
//     block per tile and bin group).
// The fused kernel loops over channels inside the block: on the TPU the
// channel axis was a sequential grid axis carrying the sum in VMEM, but CUDA
// blocks run in no order, so no sum may span blocks.  The beamformed sum
// stays in registers and the per-channel (C, T, K) tensor is never stored;
// the next channel's signal is copied in (cp.async) while this one's DFT
// runs.  Synthesis splits each tile's samples by residue mod D over blocks,
// so a short output still spreads over the card, and does the overlap-add
// as a gather from shared memory: no atomics, a deterministic result.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNoFit = -1;        // returned when the config's tile exceeds shared memory

// ---- analysis geometry ----------------------------------------------------
constexpr int kTF = 32;           // frames per block
constexpr int kUS = kTF + 2;      // row stride of the folded frames uT[p][f]
constexpr int kMaxBins = 32;      // bins per block
constexpr int kBT = 8;            // bins per thread
constexpr int kTile = 16 * kMaxBins / kBT;  // threads per group: 16 frame pairs x 4 bin octets
constexpr int kThreadsA = 512;
constexpr int kPS = kThreadsA / kTile;      // thread groups splitting each DFT sum over p
constexpr int kNA = 4 * kBT;      // sums per thread: 2 frames x kBT bins x (re, im)

// ---- synthesis geometry ---------------------------------------------------
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

// sig[i] = xc[start + i] for i < W, zero outside [0, S); asynchronous
// (cp.async) and committed as one batch.
__device__ void stage_signal_async(float* sig, const float* __restrict__ xc, int S,
                                   long long start, int W) {
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long long s = start + i;
    const bool in = s >= 0 && s < S;
    __pipeline_memcpy_async(sig + i, in ? xc + s : xc, sizeof(float), in ? 0 : sizeof(float));
  }
  __pipeline_commit();
}

// Bins of the analysis: the main bins are [0, M/2) (all K for odd M), in G
// groups of kpb; the Nyquist bin M/2 (even M) is a separate alternating sum.
__host__ __device__ int main_bins(int M) { return (M % 2 == 0) ? M / 2 : M / 2 + 1; }

// Shared memory of an analysis block, in floats:
//   F   (M/2+1, FS)  DFT rows p <= M/2 of the block's bins, [cos, sin] per bin
//   uT  (M, kUS)     folded frames, transposed; the twiddle table while F
//                    is built; the cross-group sums at the end
//   hf  (L), sig (W) prototype and signal window
__host__ __device__ int analysis_fs(int kpb) { return 2 * kBT * ((kpb + kBT - 1) / kBT); }

__host__ __device__ int analysis_region0(int M, int kpb) {
  const int work = (M / 2 + 1) * analysis_fs(kpb) + M * kUS;
  const int sums = (kPS - 1) * kNA * kTile + 2 * kThreadsA;
  return work > sums ? work : sums;
}

__host__ __device__ int analysis_smem_floats(int M, int m, int D, int kpb) {
  return analysis_region0(M, kpb) + m * M + (kTF - 1) * D + m * M;
}

// uT[p][f] = sum_q sig[f*D + q*M + p] * hf[q*M + p], for the kTF frames.
__device__ void fold(float* uT, const float* sig, const float* hf, int M, int m, int D) {
  constexpr int kFG = 8;  // frames per work item
  for (int e = threadIdx.x; e < M * (kTF / kFG); e += blockDim.x) {
    const int p = e % M;
    const int f0 = (e / M) * kFG;
    float acc[kFG];
#pragma unroll
    for (int f = 0; f < kFG; ++f) acc[f] = 0.f;
    for (int q = 0; q < m; ++q) {
      const float h = hf[q * M + p];
      const float* s = sig + f0 * D + q * M + p;
#pragma unroll
      for (int f = 0; f < kFG; ++f) acc[f] = fmaf(s[f * D], h, acc[f]);
    }
    float* dst = uT + p * kUS + f0;
#pragma unroll
    for (int f = 0; f < kFG; f += 2)
      *reinterpret_cast<float2*>(dst + f) = make_float2(acc[f], acc[f + 1]);
  }
}

// F[p][2kk], F[p][2kk+1] = cos, sin of 2 pi p k / M for block bin kk (k = k0+kk)
// and p <= M/2.
// A thread fills one bin's column over a run of p, stepping the twiddle
// index by k (mod M) instead of dividing.
__device__ void build_dft_rows(float* F, const float2* tw, int M, int k0, int k1, int FS) {
  const int cols = FS / 2, rows = M / 2 + 1, run = (rows + 31) / 32;
  float2* F2 = reinterpret_cast<float2*>(F);
  for (int e = threadIdx.x; e < cols * 32; e += blockDim.x) {
    const int kk = e % cols;
    const int p0 = (e / cols) * run, p1 = min(rows, p0 + run);
    const bool valid = k0 + kk < k1;
    const int k = valid ? k0 + kk : 0;
    int idx = (p0 * k) % M;
    for (int p = p0; p < p1; ++p) {
      F2[p * cols + kk] = valid ? tw[idx] : make_float2(0.f, 0.f);
      idx += k;
      if (idx >= M) idx -= M;
    }
  }
}

// The thread's part of the DFT: frames 2fp, 2fp+1 and bins kBT*bo ..
// kBT*bo + kBT-1 of the block; a[2kBT i + 2j], a[2kBT i + 2j + 1] = re, im
// of frame i, bin j.  The input is real, so p and M-p share their twiddles
// up to the sign of the sine: A[k] = u[0] + (-1)^k u[M/2] + sum_{0<p<M/2}
// (u[p] + u[M-p]) cos - i (u[p] - u[M-p]) sin, half the FMAs of the plain
// sum.  The pairs are split over the kPS groups (p = 1 + ps, 1 + ps + kPS,
// ...); group 0 adds the p = 0 and p = M/2 terms.  Per pair a thread issues
// 2 + kBT/2 loads and 4 kBT FMAs.
__device__ void dft_tile(const float* uT, const float* F, int M, int FS, int k0, int fp,
                         int bo, int ps, float* a) {
#pragma unroll
  for (int j = 0; j < kNA; ++j) a[j] = 0.f;
  const float* up = uT + 2 * fp;
  const float4* fq = reinterpret_cast<const float4*>(F) + (kBT / 2) * bo;
  const int fs4 = FS / 4;
#pragma unroll 2
  for (int p = 1 + ps; 2 * p < M; p += kPS) {
    const float2 u1 = *reinterpret_cast<const float2*>(up + p * kUS);
    const float2 u2 = *reinterpret_cast<const float2*>(up + (M - p) * kUS);
    const float e0 = u1.x + u2.x, o0 = u1.x - u2.x, e1 = u1.y + u2.y, o1 = u1.y - u2.y;
#pragma unroll
    for (int q = 0; q < kBT / 2; ++q) {
      const float4 f = fq[p * fs4 + q];
      float* a0 = a + 4 * q;
      float* a1 = a + 2 * kBT + 4 * q;
      a0[0] = fmaf(e0, f.x, a0[0]);
      a0[1] = fmaf(-o0, f.y, a0[1]);
      a0[2] = fmaf(e0, f.z, a0[2]);
      a0[3] = fmaf(-o0, f.w, a0[3]);
      a1[0] = fmaf(e1, f.x, a1[0]);
      a1[1] = fmaf(-o1, f.y, a1[1]);
      a1[2] = fmaf(e1, f.z, a1[2]);
      a1[3] = fmaf(-o1, f.w, a1[3]);
    }
  }
  if (ps == 0) {
    const float2 z = *reinterpret_cast<const float2*>(up);
    const float2 h = (M % 2 == 0) ? *reinterpret_cast<const float2*>(up + (M / 2) * kUS)
                                  : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kBT; ++j) {
      const bool odd = (k0 + kBT * bo + j) & 1;
      a[2 * j] += z.x + (odd ? -h.x : h.x);
      a[2 * kBT + 2 * j] += z.y + (odd ? -h.y : h.y);
    }
  }
}

// Thread tid's part of the Nyquist sum sum_p (-1)^p uT[p][f], f = tid % 32,
// over p = tid / 32 + j * kThreadsA / 32.
__device__ float nyquist_part(const float* uT, int M) {
  const int f = threadIdx.x % 32;
  float s = 0.f;
  for (int p = threadIdx.x / 32; p < M; p += kThreadsA / 32)
    s += (p & 1) ? -uT[p * kUS + f] : uT[p * kUS + f];
  return s;
}

// Block set-up shared by both analysis kernels: twiddles -> DFT rows, the
// prototype, and the first channel's window, folded into uT.
__device__ void analysis_setup(float* F, float* uT, float* hf_s, float* sig,
                               const float* __restrict__ hf, const float* __restrict__ x0,
                               int S, int M, int m, int D, int t0, int k0, int k1, int FS) {
  const int L = m * M, P = L - D, W = (kTF - 1) * D + L;
  stage_signal_async(sig, x0, S, static_cast<long long>(t0) * D - P, W);
  fill_twiddles(reinterpret_cast<float2*>(uT), M);
  for (int i = threadIdx.x; i < L; i += blockDim.x) hf_s[i] = __ldg(hf + i);
  __syncthreads();
  build_dft_rows(F, reinterpret_cast<const float2*>(uT), M, k0, k1, FS);
  __pipeline_wait_prior(0);
  __syncthreads();
  fold(uT, sig, hf_s, M, m, D);
  __syncthreads();
}

// Sum the kPS groups' partial tiles and Nyquist sums in shared memory `red`
// (uT and F are dead by now).  Group 0 ends with the totals in a[] and, for
// tid < 32, frame tid's Nyquist total in ny[].
__device__ void reduce_groups(float* red, float* a, float* ny, int nny, bool nyq) {
  const int tid = threadIdx.x, ps = tid / kTile, r = tid % kTile;
  __syncthreads();
  if (ps > 0) {
#pragma unroll
    for (int j = 0; j < kNA; ++j) red[((ps - 1) * kNA + j) * kTile + r] = a[j];
  }
  float* nyred = red + (kPS - 1) * kNA * kTile;
  if (nyq) {
    for (int j = 0; j < nny; ++j) nyred[j * kThreadsA + tid] = ny[j];
  }
  __syncthreads();
  if (ps == 0) {
    for (int g = 0; g < kPS - 1; ++g) {
#pragma unroll
      for (int j = 0; j < kNA; ++j) a[j] += red[(g * kNA + j) * kTile + r];
    }
  }
  if (nyq && tid < 32) {
    for (int j = 0; j < nny; ++j) {
      float s = 0.f;
      for (int pc = 0; pc < kThreadsA / 32; ++pc) s += nyred[j * kThreadsA + pc * 32 + tid];
      ny[j] = s;
    }
  }
}

// grid (frame tiles, C, bin groups).  out: (C, T, K) complex.
__global__ void __launch_bounds__(kThreadsA)
analysis_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                float2* __restrict__ out, int S, int T, int M, int m, int D, int kpb) {
  extern __shared__ __align__(16) float smem[];
  const int K = M / 2 + 1, FS = analysis_fs(kpb);
  float* F = smem;
  float* uT = F + (M / 2 + 1) * FS;
  float* hf_s = smem + analysis_region0(M, kpb);
  float* sig = hf_s + m * M;
  const int t0 = blockIdx.x * kTF, c = blockIdx.y;
  const int k0 = blockIdx.z * kpb, k1 = min(main_bins(M), k0 + kpb);
  const bool nyq = (M % 2 == 0) && blockIdx.z == gridDim.z - 1;
  const int tid = threadIdx.x, ps = tid / kTile, r = tid % kTile;
  const int fp = r % 16, bo = r / 16;
  const bool active = kBT * bo < kpb;

  analysis_setup(F, uT, hf_s, sig, hf, x + static_cast<long long>(c) * S, S, M, m, D,
                 t0, k0, k1, FS);
  float a[kNA];
  if (active) {
    dft_tile(uT, F, M, FS, k0, fp, bo, ps, a);
  } else {
#pragma unroll
    for (int j = 0; j < kNA; ++j) a[j] = 0.f;
  }
  float ny[1] = {nyq ? nyquist_part(uT, M) : 0.f};
  reduce_groups(smem, a, ny, 1, nyq);

  float2* oc = out + static_cast<long long>(c) * T * K;
  if (ps == 0 && active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + 2 * fp + i;
#pragma unroll
      for (int j = 0; j < kBT; ++j) {
        const int k = k0 + kBT * bo + j;
        if (t < T && k < k1)
          oc[static_cast<long long>(t) * K + k] =
              make_float2(a[2 * kBT * i + 2 * j], a[2 * kBT * i + 2 * j + 1]);
      }
    }
  }
  if (nyq && tid < 32 && t0 + tid < T)
    oc[static_cast<long long>(t0 + tid) * K + M / 2] = make_float2(ny[0], 0.f);
}

// Fused analysis + beamform: y[t, k] = sum_c conj(w[k, c]) A_c[t, k].
// grid (frame tiles, 1, bin groups).  w: (K, C) complex, y: (T, K) complex.
__global__ void __launch_bounds__(kThreadsA)
analysis_beamform_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                         const float2* __restrict__ w, float2* __restrict__ y,
                         int C, int S, int T, int M, int m, int D, int kpb) {
  extern __shared__ __align__(16) float smem[];
  const int K = M / 2 + 1, FS = analysis_fs(kpb);
  const int L = m * M, P = L - D, W = (kTF - 1) * D + L;
  float* F = smem;
  float* uT = F + (M / 2 + 1) * FS;
  float* hf_s = smem + analysis_region0(M, kpb);
  float* sig = hf_s + L;
  const int t0 = blockIdx.x * kTF;
  const int k0 = blockIdx.z * kpb, k1 = min(main_bins(M), k0 + kpb);
  const bool nyq = (M % 2 == 0) && blockIdx.z == gridDim.z - 1;
  const int tid = threadIdx.x, ps = tid / kTile, r = tid % kTile;
  const int fp = r % 16, bo = r / 16;
  const bool active = kBT * bo < kpb;

  analysis_setup(F, uT, hf_s, sig, hf, x, S, M, m, D, t0, k0, k1, FS);
  float acc[kNA], ny[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNA; ++j) acc[j] = 0.f;
  for (int c = 0; c < C; ++c) {
    if (c + 1 < C)  // the next window lands while this channel's DFT runs
      stage_signal_async(sig, x + static_cast<long long>(c + 1) * S, S,
                         static_cast<long long>(t0) * D - P, W);
    if (active) {
      float a[kNA];
      dft_tile(uT, F, M, FS, k0, fp, bo, ps, a);
#pragma unroll
      for (int j = 0; j < kBT; ++j) {  // y += conj(w) * A
        const int k = min(k0 + kBT * bo + j, K - 1);
        const float2 wk = __ldg(w + static_cast<long long>(k) * C + c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* yy = acc + 2 * kBT * i + 2 * j;
          const float* aa = a + 2 * kBT * i + 2 * j;
          yy[0] = fmaf(wk.x, aa[0], fmaf(wk.y, aa[1], yy[0]));
          yy[1] = fmaf(wk.x, aa[1], fmaf(-wk.y, aa[0], yy[1]));
        }
      }
    }
    if (nyq) {
      const float2 wn = __ldg(w + static_cast<long long>(M / 2) * C + c);
      const float s = nyquist_part(uT, M);
      ny[0] = fmaf(wn.x, s, ny[0]);
      ny[1] = fmaf(-wn.y, s, ny[1]);
    }
    if (c + 1 < C) {
      __pipeline_wait_prior(0);
      __syncthreads();  // uT is free and the next window is in place
      fold(uT, sig, hf_s, M, m, D);
      __syncthreads();
    }
  }
  reduce_groups(smem, acc, ny, 2, nyq);

  if (ps == 0 && active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + 2 * fp + i;
#pragma unroll
      for (int j = 0; j < kBT; ++j) {
        const int k = k0 + kBT * bo + j;
        if (t < T && k < k1)
          y[static_cast<long long>(t) * K + k] =
              make_float2(acc[2 * kBT * i + 2 * j], acc[2 * kBT * i + 2 * j + 1]);
      }
    }
  }
  if (nyq && tid < 32 && t0 + tid < T)
    y[static_cast<long long>(t0 + tid) * K + M / 2] = make_float2(ny[0], ny[1]);
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

// The largest dynamic shared memory a block of this device may opt in to.
int smem_optin(int* bytes) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

// The fewest bin groups of at most kMaxBins main bins whose analysis block
// fits shared memory: 0 and (groups, kpb, smem bytes), or kNoFit, or a CUDA
// error.
int analysis_groups(int M, int m, int D, int* groups, int* kpb, size_t* smem) {
  int optin;
  const int rc = smem_optin(&optin);
  if (rc) return rc;
  const int nb = main_bins(M);
  for (*groups = (nb + kMaxBins - 1) / kMaxBins; *groups <= nb; ++*groups) {
    *kpb = (nb + *groups - 1) / *groups;
    *smem = 4ull * analysis_smem_floats(M, m, D, *kpb);
    if (*smem <= static_cast<size_t>(optin)) return 0;
  }
  return kNoFit;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// x: (C, S) float32, hf: (L,) float32, out: (C, T, K) complex64.
int dsr_fb_analysis(const float* x, const float* hf, float2* out, int C, int S, int T,
                    int M, int m, int D, void* stream) {
  int groups, kpb;
  size_t smem;
  int rc = analysis_groups(M, m, D, &groups, &kpb, &smem);
  if (rc) return rc;
  rc = set_smem(reinterpret_cast<const void*>(analysis_kernel), smem);
  if (rc) return rc;
  const dim3 grid((T + kTF - 1) / kTF, C, groups);
  analysis_kernel<<<grid, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      x, hf, out, S, T, M, m, D, kpb);
  return static_cast<int>(cudaGetLastError());
}

// x: (C, S) float32, hf: (L,), w: (K, C) complex64, y: (T, K) complex64.
int dsr_fb_analysis_beamform(const float* x, const float* hf, const float2* w, float2* y,
                             int C, int S, int T, int M, int m, int D, void* stream) {
  int groups, kpb;
  size_t smem;
  int rc = analysis_groups(M, m, D, &groups, &kpb, &smem);
  if (rc) return rc;
  rc = set_smem(reinterpret_cast<const void*>(analysis_beamform_kernel), smem);
  if (rc) return rc;
  const dim3 grid((T + kTF - 1) / kTF, 1, groups);
  analysis_beamform_kernel<<<grid, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      x, hf, w, y, C, S, T, M, m, D, kpb);
  return static_cast<int>(cudaGetLastError());
}

// A: (C, T, K) complex64, gf: (L,) float32, y: (C, out_len) float32;
// y[c, j] is padded-stream sample start + j (start >= 0).
int dsr_fb_synthesis(const float2* A, const float* gf, float* y, int C, int T, int M,
                     int m, int D, long long start, int out_len, void* stream) {
  int optin;
  int rc = smem_optin(&optin);
  if (rc) return rc;
  const SynthLayout lay(M, m, D);
  const size_t smem = 4ull * lay.total;
  if (smem > static_cast<size_t>(optin)) return kNoFit;
  rc = set_smem(reinterpret_cast<const void*>(synthesis_kernel), smem);
  if (rc) return rc;
  const int mr = m * M / D;
  const long long tile = static_cast<long long>(lay.nf - mr + 1) * D;
  const long long b0 = start / tile;
  const long long b1 = (start + out_len - 1) / tile;
  const dim3 grid(static_cast<unsigned>(b1 - b0 + 1), C, (D + kDS - 1) / kDS);
  synthesis_kernel<<<grid, kThreadsS, smem, static_cast<cudaStream_t>(stream)>>>(
      A, gf, y, T, M, m, D, static_cast<int>(b0), start, out_len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
