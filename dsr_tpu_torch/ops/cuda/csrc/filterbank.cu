// Oversampled DFT filterbank kernels for Hopper (sm_90a): fused analysis +
// fixed-weight beamform, and synthesis.  (The unfused analysis is an FFT,
// csrc/analysis.cu.)  Plain C interface, loaded with ctypes by
// dsr_tpu_torch/ops/cuda/filterbank.py; each entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// kNoFit: never for a valid config).
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
//   analysis_beamform  <- _analysis_bf_kernel, unstaged and over the staged
//                         buffer bank (stage_for_beamform / _analysis_bf_staged)
//   synthesis          <- _synthesis_kernel_v5 and _synthesis_kernel
//
// The staged bank: the TPU kernel read a (B, C*rows, 128) bank of padded
// frames and took the buffer's index by scalar prefetch, so one compiled
// kernel served a whole serving loop with no host work per call.  Here the
// bank is the (B, C, S) signals as they are (the kernels need no padded
// frame grid), and the fused kernel's staged instantiation reads the index
// from device memory itself (or takes it as an argument): a loop over the
// bank needs no host readback.  An index outside [0, B) read from device
// memory makes the kernel write NaN (it cannot raise).
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
//
// A config whose block does not fit shared memory that way (M = 512 at
// r = 4, M >= 768, large m r^2) runs a second family of kernels, the
// "slab" kernels below: the fused analysis takes its DFT sum over p in
// slabs of pairs and reads the signal and prototype from device memory; the
// synthesis takes its IDFT sum over bins in slabs, with fewer residues per
// block when needed; without room for the twiddle table (M above
// ~20,000), each DFT entry is computed directly, with the same sincospi,
// so the same value.  The main path's configs never reach them, so their
// kernels keep the simpler layout and its register budget.
// A synthesis whose slab block cannot hold the frames' IDFT (m r^2 above
// ~7,000, e.g. M = 256 m = 8 r = 32) takes two kernels through device
// memory: every frame's IDFT at all M indices into the caller's scratch,
// then the overlap-add as a gather, one warp per output sample.  (A slab
// block holds the IDFT of the m r frames behind its samples, so its blocks
// recompute each frame's IDFT about m r / (its tile's frames) times, and
// holding that IDFT in device memory would need, at M = 4096 m = 8 r =
// 4096, 4 GB per block.)

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

// Block set-up of the fused kernel: twiddles -> DFT rows, the
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

// The staged bank's buffer: x (B, C, S) at index *idx (device memory) or
// idx_host; out of range, buffer 0 is read and *bad set.
struct Staged {
  const int* idx;
  int idx_host, nbuf;
  long long stride;
};

__device__ __forceinline__ const float* staged_buffer(const float* x, const Staged& st,
                                                      bool* bad) {
  const int b = st.idx ? __ldg(st.idx) : st.idx_host;
  *bad = b < 0 || b >= st.nbuf;
  return x + (*bad ? 0 : static_cast<long long>(b) * st.stride);
}

__device__ __forceinline__ void poison(float* a, int n) {
  for (int j = 0; j < n; ++j) a[j] = __int_as_float(0x7fffffff);
}

// Fused analysis + beamform: y[t, k] = sum_c conj(w[k, c]) A_c[t, k].
// grid (frame tiles, 1, bin groups).  w: (K, C) complex, y: (T, K) complex.
// kStaged: x is the staged bank and `st` names the buffer; otherwise `st`
// is not read and the code is the unstaged kernel's.
template <bool kStaged>
__global__ void __launch_bounds__(kThreadsA)
analysis_beamform_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                         const float2* __restrict__ w, float2* __restrict__ y,
                         int C, int S, int T, int M, int m, int D, int kpb, Staged st) {
  extern __shared__ __align__(16) float smem[];
  bool bad = false;
  if constexpr (kStaged) x = staged_buffer(x, st, &bad);
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
  if constexpr (kStaged) {
    if (bad) {
      poison(acc, kNA);
      poison(ny, 2);
    }
  }

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

// ---- slab kernels: configs whose block does not fit as above ---------------

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

// The DFT sum over p runs over p = 0, p = M/2 (even M) and the pairs
// (p, M-p), 0 < p < M/2, taken in slabs of at most np pairs.
__host__ __device__ int num_pairs(int M) { return (M - 1) / 2; }

// The layout of a slab analysis block, in floats of shared memory:
//   F   (np, FS)        DFT rows of the slab's pairs, [cos, sin] per bin
//   uT  (2np+2, kUS)    folded frames, transposed: rows [0, ns) hold p =
//                       pa + i, rows [ns, 2ns) M - pa - (i - ns), row 2ns
//                       p = 0 and row 2ns+1 p = M/2 (first slab only); the
//                       cross-group sums (over F and uT) at the end
//   tw  (2M)            the twiddle table, when use_tw
struct SlabLayout {
  int kpb, np, FS, use_tw, uT, tw, total;  // offsets (floats) and size
  __host__ __device__ SlabLayout() {}
  __host__ __device__ SlabLayout(int M, int kpb_, int np_, int use_tw_)
      : kpb(kpb_), np(np_), FS(analysis_fs(kpb_)), use_tw(use_tw_) {
    uT = np * FS;
    tw = uT + (2 * np + 2) * kUS;
    const int work = tw + (use_tw ? 2 * M : 0);
    const int sums = (kPS - 1) * kNA * kTile + 2 * kThreadsA;
    total = work > sums ? work : sums;
  }
};

__device__ __forceinline__ int slab_p(int i, int M, int pa, int ns) {
  if (i < ns) return pa + i;
  if (i < 2 * ns) return M - pa - (i - ns);
  return i == 2 * ns ? 0 : M / 2;
}

// uT[i][f] = sum_q x[f*D + q*M + p] * hf[q*M + p], p = slab_p(i), for the
// kTF frames and the slab's `rows` rows; the channel signal xc (padded-
// stream offset `start`) and the prototype read from device memory.
__device__ void fold_slab(float* uT, const float* __restrict__ xc, long long start, int S,
                          const float* __restrict__ hf, int M, int m, int D, int pa, int ns,
                          int rows) {
  constexpr int kFG = 8;  // frames per work item
  for (int e = threadIdx.x; e < rows * (kTF / kFG); e += blockDim.x) {
    const int i = e % rows;
    const int p = slab_p(i, M, pa, ns);
    const int f0 = (e / rows) * kFG;
    float acc[kFG];
#pragma unroll
    for (int f = 0; f < kFG; ++f) acc[f] = 0.f;
    for (int q = 0; q < m; ++q) {
      const float h = __ldg(hf + q * M + p);
      const long long g0 = start + f0 * D + q * M + p;
#pragma unroll
      for (int f = 0; f < kFG; ++f) {
        const long long g = g0 + f * D;
        acc[f] = fmaf((g >= 0 && g < S) ? __ldg(xc + g) : 0.f, h, acc[f]);
      }
    }
    float* dst = uT + i * kUS + f0;
#pragma unroll
    for (int f = 0; f < kFG; f += 2)
      *reinterpret_cast<float2*>(dst + f) = make_float2(acc[f], acc[f + 1]);
  }
}

// F[j][2kk], F[j][2kk+1] = cos, sin of 2 pi p k / M for block bin kk (k =
// k0+kk) and slab row j (p = pa + j), stepping the twiddle index by k.
template <bool kTable>
__device__ void build_slab_rows(float* F, const float2* tw, int M, int k0, int k1, int FS,
                                int pa, int ns) {
  const int cols = FS / 2, run = (ns + 31) / 32;
  float2* F2 = reinterpret_cast<float2*>(F);
  for (int e = threadIdx.x; e < cols * 32; e += blockDim.x) {
    const int kk = e % cols;
    const int j0 = (e / cols) * run, j1 = min(ns, j0 + run);
    const bool valid = k0 + kk < k1;
    const int k = valid ? k0 + kk : 0;
    int idx = static_cast<int>((static_cast<long long>(pa + j0) * k) % M);
    for (int j = j0; j < j1; ++j) {
      F2[j * cols + kk] = valid ? twiddle<kTable>(tw, idx, M) : make_float2(0.f, 0.f);
      idx += k;
      if (idx >= M) idx -= M;
    }
  }
}

// dft_tile over one slab, added to a[]: the slab's ns pairs split over the
// kPS groups; in the first slab group 0 adds the p = 0 and p = M/2 terms.
__device__ void dft_slab(const float* uT, const float* F, int M, int FS, int k0, int fp,
                         int bo, int ps, int ns, bool first, float* a) {
  const float* up = uT + 2 * fp;
  const float4* fq = reinterpret_cast<const float4*>(F) + (kBT / 2) * bo;
  const int fs4 = FS / 4;
#pragma unroll 2
  for (int j = ps; j < ns; j += kPS) {
    const float2 u1 = *reinterpret_cast<const float2*>(up + j * kUS);
    const float2 u2 = *reinterpret_cast<const float2*>(up + (ns + j) * kUS);
    const float e0 = u1.x + u2.x, o0 = u1.x - u2.x, e1 = u1.y + u2.y, o1 = u1.y - u2.y;
#pragma unroll
    for (int q = 0; q < kBT / 2; ++q) {
      const float4 f = fq[j * fs4 + q];
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
  if (ps == 0 && first) {
    const float2 z = *reinterpret_cast<const float2*>(up + 2 * ns * kUS);
    const float2 h = (M % 2 == 0) ? *reinterpret_cast<const float2*>(up + (2 * ns + 1) * kUS)
                                  : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kBT; ++j) {
      const bool odd = (k0 + kBT * bo + j) & 1;
      a[2 * j] += z.x + (odd ? -h.x : h.x);
      a[2 * kBT + 2 * j] += z.y + (odd ? -h.y : h.y);
    }
  }
}

// nyquist_part over the slab's rows.
__device__ float nyquist_slab(const float* uT, int M, int pa, int ns, int rows) {
  const int f = threadIdx.x % 32;
  float s = 0.f;
  for (int i = threadIdx.x / 32; i < rows; i += kThreadsA / 32) {
    const float v = uT[i * kUS + f];
    s += (slab_p(i, M, pa, ns) & 1) ? -v : v;
  }
  return s;
}

// A slab analysis block's geometry and shared-memory regions.
struct SlabBlock {
  float* F;
  float* uT;
  float2* tw;
  int M, m, D, np, t0, k0, k1, nslabs;
  long long start;
  bool nyq;
  __device__ SlabBlock(float* smem, const SlabLayout& lay, int M_, int m_, int D_)
      : M(M_), m(m_), D(D_), np(lay.np) {
    F = smem;
    uT = smem + lay.uT;
    tw = reinterpret_cast<float2*>(smem + lay.tw);
    t0 = blockIdx.x * kTF;
    start = static_cast<long long>(t0) * D - (m * M - D);
    k0 = blockIdx.z * lay.kpb;
    k1 = min(main_bins(M), k0 + lay.kpb);
    nyq = (M % 2 == 0) && blockIdx.z == gridDim.z - 1;
    const int npr = num_pairs(M);
    nslabs = npr > 0 ? (npr + np - 1) / np : 1;
  }
  __device__ int pa(int s) const { return 1 + s * np; }
  __device__ int ns(int s) const { return min(np, num_pairs(M) - s * np); }
  // slab rows: its pairs' 2 ns, and in the first slab p = 0 and p = M/2
  __device__ int rows(int s) const { return 2 * ns(s) + (s == 0 ? 1 + (M % 2 == 0) : 0); }
  // build slab s's DFT rows (the caller synchronises before and after)
  template <bool kTable>
  __device__ void build(int s, int FS) {
    build_slab_rows<kTable>(F, tw, M, k0, k1, FS, pa(s), ns(s));
  }
  __device__ void fold(int s, const float* __restrict__ xc, int S,
                       const float* __restrict__ hf) {
    fold_slab(uT, xc, start, S, hf, M, m, D, pa(s), ns(s), rows(s));
  }
  // group 0 writes the block's main bins of a[], the last bin group's first
  // warp the Nyquist bin (ny_re, ny_im)
  __device__ void store(float2* o, const float* a, int T, int bo, int fp, bool write,
                        float ny_re, float ny_im) const {
    const int K = M / 2 + 1;
    if (write) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + 2 * fp + i;
#pragma unroll
        for (int j = 0; j < kBT; ++j) {
          const int k = k0 + kBT * bo + j;
          if (t < T && k < k1)
            o[static_cast<long long>(t) * K + k] =
                make_float2(a[2 * kBT * i + 2 * j], a[2 * kBT * i + 2 * j + 1]);
        }
      }
    }
    const int tid = threadIdx.x;
    if (nyq && tid < 32 && t0 + tid < T)
      o[static_cast<long long>(t0 + tid) * K + M / 2] = make_float2(ny_re, ny_im);
  }
};

// analysis_beamform_kernel in slabs: the slabs are the outer loop and the
// channels the inner one (the sum is linear in both).  grid (frame tiles,
// 1, bin groups).
template <bool kTable, bool kStaged>
__global__ void __launch_bounds__(kThreadsA)
analysis_beamform_slab_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                              const float2* __restrict__ w, float2* __restrict__ y, int C,
                              int S, int T, int M, int m, int D, SlabLayout lay, Staged st) {
  extern __shared__ __align__(16) float smem[];
  bool bad = false;
  if constexpr (kStaged) x = staged_buffer(x, st, &bad);
  SlabBlock blk(smem, lay, M, m, D);
  const int K = M / 2 + 1;
  const int tid = threadIdx.x, ps = tid / kTile, r = tid % kTile;
  const int fp = r % 16, bo = r / 16;
  const bool active = kBT * bo < lay.kpb;

  if constexpr (kTable) fill_twiddles(blk.tw, M);
  float acc[kNA], ny[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNA; ++j) acc[j] = 0.f;
  for (int sl = 0; sl < blk.nslabs; ++sl) {
    const int ns = blk.ns(sl);
    __syncthreads();
    blk.template build<kTable>(sl, lay.FS);
    for (int c = 0; c < C; ++c) {
      __syncthreads();   // F is in place; uT is free
      blk.fold(sl, x + static_cast<long long>(c) * S, S, hf);
      __syncthreads();
      if (active) {
        float a[kNA];
#pragma unroll
        for (int j = 0; j < kNA; ++j) a[j] = 0.f;
        dft_slab(blk.uT, blk.F, M, lay.FS, blk.k0, fp, bo, ps, ns, sl == 0, a);
#pragma unroll
        for (int j = 0; j < kBT; ++j) {  // y += conj(w) * A
          const int k = min(blk.k0 + kBT * bo + j, K - 1);
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
      if (blk.nyq) {
        const float2 wn = __ldg(w + static_cast<long long>(M / 2) * C + c);
        const float sn = nyquist_slab(blk.uT, M, blk.pa(sl), ns, blk.rows(sl));
        ny[0] = fmaf(wn.x, sn, ny[0]);
        ny[1] = fmaf(-wn.y, sn, ny[1]);
      }
    }
  }
  reduce_groups(smem, acc, ny, 2, blk.nyq);
  if constexpr (kStaged) {
    if (bad) {
      poison(acc, kNA);
      poison(ny, 2);
    }
  }
  blk.store(y, acc, T, bo, fp, ps == 0 && active, ny[0], ny[1]);
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

// The analysis's bin groups of at most kMaxBins main bins, and whether its
// whole-DFT block fits (*slabs = 0) or, if not, the slab layout: the most
// pairs per slab that fit, with the twiddle table if it leaves room.  0,
// or a CUDA error.
int analysis_layout(int M, int m, int D, int* groups, int* kpb, int* slabs, SlabLayout* lay) {
  int optin;
  const int rc = smem_optin(&optin);
  if (rc) return rc;
  const int budget = optin / 4;
  const int nb = main_bins(M);
  *groups = (nb + kMaxBins - 1) / kMaxBins;
  *kpb = (nb + *groups - 1) / *groups;
  *slabs = analysis_smem_floats(M, m, D, *kpb) > budget;
  if (!*slabs) return 0;
  const int npr = num_pairs(M) > 0 ? num_pairs(M) : 1;
  for (int use_tw = 1;; use_tw = 0) {
    const SlabLayout one(M, *kpb, 1, use_tw);
    const int room = budget - (2 * kUS + (use_tw ? 2 * M : 0));
    int np = room / (one.FS + 2 * kUS);
    np = np < npr ? np : npr;
    if (np >= 1 || !use_tw) {   // without the table one pair always fits
      *lay = SlabLayout(M, *kpb, np, use_tw);
      return 0;
    }
  }
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

// The fused kernel's launch, unstaged (x (C, S)) or over the staged bank
// (x (B, C, S), the buffer named by st).
template <bool kStaged>
int launch_analysis_beamform(const float* x, const float* hf, const float2* w, float2* y,
                             int C, int S, int T, int M, int m, int D, Staged stg,
                             void* stream) {
  int groups, kpb, slabs;
  SlabLayout lay;
  int rc = analysis_layout(M, m, D, &groups, &kpb, &slabs, &lay);
  if (rc) return rc;
  const dim3 grid((T + kTF - 1) / kTF, 1, groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!slabs) {
    const size_t smem = 4ull * analysis_smem_floats(M, m, D, kpb);
    rc = set_smem(reinterpret_cast<const void*>(analysis_beamform_kernel<kStaged>), smem);
    if (rc) return rc;
    analysis_beamform_kernel<kStaged><<<grid, kThreadsA, smem, st>>>(x, hf, w, y, C, S, T, M,
                                                                     m, D, kpb, stg);
  } else {
    const size_t smem = 4ull * lay.total;
    auto kernel = lay.use_tw ? analysis_beamform_slab_kernel<true, kStaged>
                             : analysis_beamform_slab_kernel<false, kStaged>;
    rc = set_smem(reinterpret_cast<const void*>(kernel), smem);
    if (rc) return rc;
    kernel<<<grid, kThreadsA, smem, st>>>(x, hf, w, y, C, S, T, M, m, D, lay, stg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (C, S) float32, hf: (L,), w: (K, C) complex64, y: (T, K) complex64.
int dsr_fb_analysis_beamform(const float* x, const float* hf, const float2* w, float2* y,
                             int C, int S, int T, int M, int m, int D, void* stream) {
  return launch_analysis_beamform<false>(x, hf, w, y, C, S, T, M, m, D, Staged{}, stream);
}

// The staged bank: xbank (B, C, S) float32; the buffer is idx[0] (device
// memory) when idx is not null, else idx_host.  Otherwise as above.
int dsr_fb_analysis_beamform_staged(const float* xbank, const int* idx, int idx_host, int B,
                                    const float* hf, const float2* w, float2* y, int C, int S,
                                    int T, int M, int m, int D, void* stream) {
  const Staged stg{idx, idx_host, B, static_cast<long long>(C) * S};
  return launch_analysis_beamform<true>(xbank, hf, w, y, C, S, T, M, m, D, stg, stream);
}

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
