// Oversampled DFT filterbank analysis for Hopper (sm_90a) as a factorised
// real FFT.  Plain C interface, loaded with ctypes by
// dsr_tpu_torch/ops/cuda/filterbank.py; the entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// kNoFit: never for a valid config).
//
// Replaces dsr_tpu/ops/pallas/filterbank.py:188 _analysis_kernel_v5 and :83
// _analysis_kernel (one kernel for every M, m and D).
//
// The function (the conventions of dsr_tpu/ops/filterbank.py): M subbands,
// prototype length L = m*M, hop D, K = M/2+1 bins, front pad P = L-D.
// Frame t covers x[t*D - P, t*D - P + L) (zeros outside the signal):
//     u[t, p] = sum_{q<m} x[t*D - P + q*M + p] hf[q*M + p],   p < M,
//     A[t, k] = sum_{p<M} u[t, p] e^{-2 pi i p k / M},         k < K.
//
// The transform: for even M the folded frame is packed as z[j] = u[2j] +
// i u[2j+1], an n = M/2 point complex FFT, and split into the K bins:
//     A[k] = (Z[k] + conj Z[n-k]) / 2 - i e^{-2 pi i k/M} (Z[k] - conj Z[n-k]) / 2,
// with A[0] = Re Z[0] + Im Z[0] and A[n] = Re Z[0] - Im Z[0] written as real
// (the exact zeros of rfft's DC and Nyquist).  For odd M, an n = M point
// complex FFT of u.  The FFT is a mixed-radix Stockham FFT (out of place,
// natural order in and out): radix-4 stages, one radix-2 stage for an odd
// power of two, radix-3 stages, and a direct length-q DFT stage for any
// other prime factor q, so a prime M is a direct DFT and every M is
// taken.  Stage s of radix R, with Ns the product of the earlier radices,
// maps element j + r n/R (j < n/R, r < R) through the twiddle
// W_n^{(j mod Ns) r n/(Ns R)} and a length-R DFT to
// (j div Ns) Ns R + (j mod Ns) + k Ns.  Twiddles come from a table of
// e^{-2 pi i j / M}, j < M, filled with sincospif (exact zeros at the
// quarter turns); without room for it they are computed in place by the
// same sincospif, so they are the same values.  Index arithmetic divides
// by multiply-shift (FastDiv): runtime integer divisions dominated the
// stages otherwise.
//
// What bounds it on this card: a real FFT of M points is about 2.5 M log2 M
// operations a frame against 4 L bytes of signal read (mostly from L1) and
// 8 K written, so bytes bound it (the main path's 8 ch x 4 s: 6.2 MB, 1.9 us
// at 3.35 TB/s).  What is left above that is a block's latency: the
// loads, the fold, one barrier a stage and the split, a few microseconds.
//
// Layout, by the FFT's size n (complex points a frame):
//   - n < 1024 (the main path's M = 256, D = 256's M = 512, M = 1024): a
//     block of 256 threads folds F frames (F n <= 1024 points; F smaller
//     when the call has few frames, so the grid gives about four blocks an
//     SM) into shared memory and runs the F FFTs together, ping-pong
//     between two buffers, one barrier a stage;
//   - larger n while two buffers fit shared memory: a block per frame, the
//     same code;
//   - up to n = 16,384 (M = 32,768): one buffer in shared memory, each
//     stage's outputs held in registers (32 values a thread of 512) until
//     every thread has read its inputs;
//   - beyond: a block per frame with its two buffers in the caller's
//     device scratch (a grid-stride loop over frames bounds the scratch).
// The ping-pong blocks copy the prototype and each tile's signal window
// into shared memory with cp.async (every load in flight at once) when
// they fit; otherwise, and in the other layouts, the fold reads them from
// device memory.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNoFit = -1;
constexpr int kMaxStages = 24;
constexpr int kTilePoints = 1024;   // complex points a small block transforms at once
constexpr int kThreadsS = 256;      // ping-pong blocks
constexpr int kThreadsH = 512;      // the register-held block
constexpr int kHeld = 32;           // values a thread holds in a stage (kThreadsH)
constexpr int kStaticSmem = 1024;

// x / d for 0 <= x < 2^31 by a multiply and a shift (d >= 1; the
// round-up method: l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d) + 1).
struct FastDiv {
  unsigned d, mul, shift;
  FastDiv() = default;
  explicit FastDiv(unsigned d_) : d(d_) {
    shift = 0;
    while ((1ull << shift) < d) ++shift;
    mul = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int x) const {
    const unsigned u = static_cast<unsigned>(x);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

// A stage: radix R, Ns the product of the earlier radices, n / R, and
// n / (Ns R), the twiddle step.
struct Stage {
  int R, Ns, nR, step;
  FastDiv by_ns, by_nr;
};

struct Plan {
  int n, s, nst;          // FFT length, M / n, stages
  FastDiv by_m, by_k, by_n;
  Stage st[kMaxStages];
};

// e^{-2 pi i j / M} by sincospif: exact zeros where cos or sin vanishes.
__device__ __forceinline__ float2 twiddle(int j, int M) {
  float sn, cs;
  sincospif(2.0f * j / M, &sn, &cs);
  return make_float2(cs, -sn);
}

// The table's entry, or the same value computed in place.
struct Twiddle {
  const float2* tab;
  int M;
  __device__ __forceinline__ float2 operator()(int j) const {
    if (tab) return tab[j];
    return twiddle(j, M);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = csub(v[1], v[3]);
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = make_float2(t1.x + t3.y, t1.y - t3.x);   // t1 - i t3
    v[3] = make_float2(t1.x - t3.y, t1.y + t3.x);   // t1 + i t3
  } else {   // R == 3: W = e^{-2 pi i / 3} = c + i sn
    constexpr float c = -0.5f, sn = -0.866025403784438647f;
    const float2 t = cadd(v[1], v[2]), d = csub(v[1], v[2]);
    const float2 mid = make_float2(v[0].x + c * t.x, v[0].y + c * t.y);
    v[0] = cadd(v[0], t);
    v[1] = make_float2(mid.x - sn * d.y, mid.y + sn * d.x);   // mid + i sn d
    v[2] = make_float2(mid.x + sn * d.y, mid.y - sn * d.x);   // mid - i sn d
  }
}

// Butterfly j (< n/R) of a radix-R stage: its inputs, twiddled, transformed.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&v)[R], const float2* in, int j,
                                          const Stage& g, int jm, const Twiddle& tw, int s) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = in[j + r * g.nR];
    if (r > 0 && jm > 0) v[r] = cmul(v[r], tw(s * jm * r * g.step));
  }
  dft<R>(v);
}

// Where butterfly j's output 0 goes: (j div Ns) Ns R + (j mod Ns); jm = j mod Ns.
__device__ __forceinline__ int dest(int j, const Stage& g, int* jm) {
  const int jq = g.by_ns.div(j);
  *jm = j - jq * g.Ns;
  return jq * g.Ns * g.R + *jm;
}

// Output k (< R) of butterfly j of a direct length-R stage (any R):
// sum_r in[j + r n/R] W_n^{r (jm step + k n/R)}.
__device__ __forceinline__ float2 direct(const float2* in, int j, int jm, int k, int n,
                                         const Stage& g, const Twiddle& tw, int s) {
  const int base = jm * g.step + k * g.nR;
  float2 acc = make_float2(0.f, 0.f);
  int e = 0;
  for (int r = 0; r < g.R; ++r) {
    acc = cadd(acc, cmul(in[j + r * g.nR], tw(s * e)));
    e += base;
    if (e >= n) e -= n;
  }
  return acc;
}

// A stage from `in` to `out` over frames [0, nf) of n points (ping-pong).
template <int R>
__device__ void stage_pp(const float2* in, float2* out, int nf, int n, const Stage& g,
                         const Twiddle& tw, int s) {
  for (int b = threadIdx.x; b < nf * g.nR; b += blockDim.x) {
    const int f = g.by_nr.div(b), j = b - f * g.nR;
    int jm;
    float2* o = out + f * n + dest(j, g, &jm);
    float2 v[R];
    butterfly<R>(v, in + f * n, j, g, jm, tw, s);
#pragma unroll
    for (int k = 0; k < R; ++k) o[k * g.Ns] = v[k];
  }
}

__device__ void stage_pp_direct(const float2* in, float2* out, int nf, int n, const Stage& g,
                                const FastDiv& by_n, const Twiddle& tw, int s) {
  for (int o = threadIdx.x; o < nf * n; o += blockDim.x) {
    const int f = by_n.div(o), jk = o - f * n, k = g.by_nr.div(jk), j = jk - k * g.nR;
    int jm;
    const int at = dest(j, g, &jm);
    out[f * n + at + k * g.Ns] = direct(in + f * n, j, jm, k, n, g, tw, s);
  }
}

// The same stages in place on one frame: every thread computes its
// outputs into registers, the block synchronises, then they are written.
template <int R>
__device__ void stage_held(float2* buf, const Stage& g, const Twiddle& tw, int s) {
  constexpr int kB = kHeld / R;
  float2 v[kB][R];
  int at[kB];
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int j = threadIdx.x + i * kThreadsH;
    if (j < g.nR) {
      int jm;
      at[i] = dest(j, g, &jm);
      butterfly<R>(v[i], buf, j, g, jm, tw, s);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int j = threadIdx.x + i * kThreadsH;
    if (j < g.nR) {
#pragma unroll
      for (int k = 0; k < R; ++k) buf[at[i] + k * g.Ns] = v[i][k];
    }
  }
}

__device__ void stage_held_direct(float2* buf, int n, const Stage& g, const Twiddle& tw, int s) {
  float2 v[kHeld];
  int at[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int o = threadIdx.x + i * kThreadsH;
    if (o < n) {
      const int k = g.by_nr.div(o), j = o - k * g.nR;
      int jm;
      at[i] = dest(j, g, &jm) + k * g.Ns;
      v[i] = direct(buf, j, jm, k, n, g, tw, s);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int o = threadIdx.x + i * kThreadsH;
    if (o < n) buf[at[i]] = v[i];
  }
}

// The block's buffers: b0 (the folded frames, then every other stage's
// output) and b1; for the held layout b1 is unused.
template <bool kHeldLayout>
__device__ float2* run_stages(float2* b0, float2* b1, int nf, const Plan& pl,
                              const Twiddle& tw) {
  const int n = pl.n, s = pl.s;
  float2 *in = b0, *out = b1;
  for (int i = 0; i < pl.nst; ++i) {
    const Stage& g = pl.st[i];
    if constexpr (kHeldLayout) {
      if (g.R == 4)
        stage_held<4>(in, g, tw, s);
      else if (g.R == 2)
        stage_held<2>(in, g, tw, s);
      else if (g.R == 3)
        stage_held<3>(in, g, tw, s);
      else
        stage_held_direct(in, n, g, tw, s);
    } else {
      if (g.R == 4)
        stage_pp<4>(in, out, nf, n, g, tw, s);
      else if (g.R == 2)
        stage_pp<2>(in, out, nf, n, g, tw, s);
      else if (g.R == 3)
        stage_pp<3>(in, out, nf, n, g, tw, s);
      else
        stage_pp_direct(in, out, nf, n, g, pl.by_n, tw, s);
      float2* t = in;
      in = out;
      out = t;
    }
    __syncthreads();
  }
  return in;
}

// dst[i] = src[start + i] for i < W, zero outside [0, S); asynchronous
// (cp.async), committed as one batch.
__device__ void stage_async(float* dst, const float* __restrict__ src, long long S,
                            long long start, int W) {
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long long g = start + i;
    const bool in = g >= 0 && g < S;
    __pipeline_memcpy_async(dst + i, in ? src + g : src, sizeof(float), in ? 0 : sizeof(float));
  }
  __pipeline_commit();
}

// grid-stride over tiles of F frames (tile = c * ntile + frame tile).
// Dynamic shared memory: the twiddle table (M entries) when `table`, the
// buffers when `gbuf` is null (else 2 F n points of device memory per block
// at gbuf), and when `stage` the prototype (L floats) and the tile's signal
// window ((F-1) D + L floats), copied in by cp.async.  out: (C, T, K)
// complex.
template <bool kHeldLayout>
__global__ void __launch_bounds__(kHeldLayout ? kThreadsH : kThreadsS)
analysis_fft_kernel(const float* __restrict__ x, const float* __restrict__ hf,
                    float2* __restrict__ out, int C, int S, int T, int M, int m, int D, int F,
                    int table, int stage, Plan pl, float2* __restrict__ gbuf) {
  extern __shared__ __align__(16) float2 smem[];
  const int n = pl.n, K = M / 2 + 1, L = m * M, P = L - D, ntile = (T + F - 1) / F;
  const bool vec = M % 4 == 0 && D % 4 == 0;   // the staged window's rows are 16-byte aligned
  float2* tab = table ? smem : nullptr;
  float2* b0 = gbuf ? gbuf + 2ll * F * n * blockIdx.x : smem + (table ? M : 0);
  float2* b1 = b0 + F * n;
  float* hf_s = reinterpret_cast<float*>(smem + (table ? M : 0) + 2 * F * n);
  float* sig = hf_s + L;
  const Twiddle tw{tab, M};
  // the prototype and the first tile's window are in flight while the
  // twiddle table is filled
  const auto window = [&](int tile) {
    const int c = tile / ntile, t0 = (tile - c * ntile) * F, nf = min(F, T - t0);
    stage_async(sig, x + static_cast<long long>(c) * S, S, static_cast<long long>(t0) * D - P,
                (nf - 1) * D + L);
  };
  if (stage) {
    stage_async(hf_s, hf, L, 0, L);
    if (blockIdx.x < C * ntile) window(blockIdx.x);
  }
  if (tab)
    for (int j = threadIdx.x; j < M; j += blockDim.x) tab[j] = twiddle(j, M);
  for (int tile = blockIdx.x; tile < C * ntile; tile += gridDim.x) {
    const int c = tile / ntile, t0 = (tile - c * ntile) * F, nf = min(F, T - t0);
    const float* xc = x + static_cast<long long>(c) * S;
    // fold: u[f][p], packed two reals a point for even M
    float* bf = reinterpret_cast<float*>(b0);
    if (stage) {
      if (tile != blockIdx.x) window(tile);
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    if (stage && vec) {   // four samples a thread, float4 from shared memory
      for (int e = 4 * threadIdx.x; e < nf * M; e += 4 * blockDim.x) {
        const int f = pl.by_m.div(e), p = e - f * M;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < m; ++q) {
          const float4 xv = *reinterpret_cast<const float4*>(sig + f * D + q * M + p);
          const float4 hv = *reinterpret_cast<const float4*>(hf_s + q * M + p);
          acc.x = fmaf(xv.x, hv.x, acc.x);
          acc.y = fmaf(xv.y, hv.y, acc.y);
          acc.z = fmaf(xv.z, hv.z, acc.z);
          acc.w = fmaf(xv.w, hv.w, acc.w);
        }
        if (pl.s == 2) {
          *reinterpret_cast<float4*>(bf + 2 * f * n + p) = acc;
        } else {
          float2* z = b0 + f * n + p;
          z[0] = make_float2(acc.x, 0.f);
          z[1] = make_float2(acc.y, 0.f);
          z[2] = make_float2(acc.z, 0.f);
          z[3] = make_float2(acc.w, 0.f);
        }
      }
    }
    for (int e = threadIdx.x; e < (stage && vec ? 0 : nf * M); e += blockDim.x) {
      const int f = pl.by_m.div(e), p = e - f * M;
      float acc = 0.f;
      if (stage) {
        const float* sp = sig + f * D + p;
#pragma unroll 4
        for (int q = 0; q < m; ++q) acc = fmaf(sp[q * M], hf_s[q * M + p], acc);
      } else {
        const long long g0 = static_cast<long long>(t0 + f) * D - P + p;
        for (int q = 0; q < m; ++q) {
          const long long g = g0 + static_cast<long long>(q) * M;
          if (g >= 0 && g < S) acc = fmaf(__ldg(xc + g), __ldg(hf + q * M + p), acc);
        }
      }
      if (pl.s == 2)
        bf[2 * f * n + p] = acc;
      else
        b0[f * n + p] = make_float2(acc, 0.f);
    }
    __syncthreads();
    const float2* Z = run_stages<kHeldLayout>(b0, b1, nf, pl, tw);
    // the K bins of each frame
    float2* o = out + (static_cast<long long>(c) * T + t0) * K;
    for (int e = threadIdx.x; e < nf * K; e += blockDim.x) {
      const int f = pl.by_k.div(e), k = e - f * K;
      const float2* z = Z + f * n;
      float2 a;
      if (pl.s == 1) {
        a = z[k];
      } else if (k == 0 || k == n) {
        a = make_float2(k == 0 ? z[0].x + z[0].y : z[0].x - z[0].y, 0.f);
      } else {
        const float2 zk = z[k], zc = make_float2(z[n - k].x, -z[n - k].y);
        const float2 ev = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
        const float2 od = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));  // -i (zk - zc) / 2
        a = cadd(ev, cmul(tw(k), od));
      }
      o[static_cast<long long>(f) * K + k] = a;
    }
    __syncthreads();   // the buffers are free for the next tile
  }
}

int smem_budget(int* bytes, int* sms) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *bytes = optin - kStaticSmem;
  return static_cast<int>(e);
}

// The FFT's length and stages: radix 4 while 4 divides, then 2, then 3s,
// then the other primes in increasing order.
void make_plan(int M, Plan* pl) {
  const int n = M % 2 == 0 ? M / 2 : M;
  pl->n = n;
  pl->s = M / n;
  pl->by_m = FastDiv(M);
  pl->by_k = FastDiv(M / 2 + 1);
  pl->by_n = FastDiv(n);
  pl->nst = 0;
  int r = n, ns = 1;
  auto add = [&](int R) {
    if (pl->nst < kMaxStages) {
      Stage& g = pl->st[pl->nst];
      g.R = R;
      g.Ns = ns;
      g.nR = n / R;
      g.step = n / (ns * R);
      g.by_ns = FastDiv(ns);
      g.by_nr = FastDiv(n / R);
    }
    ++pl->nst;
    ns *= R;
    r /= R;
  };
  while (r % 4 == 0) add(4);
  if (r % 2 == 0) add(2);
  for (int q = 3; r > 1; q += 2)
    while (r % q == 0) add(q);
}

// Whether the held layout takes this plan: every stage's outputs fit the
// threads' registers.
bool held_fits(const Plan& pl) {
  for (int i = 0; i < pl.nst; ++i) {
    const int R = pl.st[i].R;
    const long long per = (R == 2 || R == 3 || R == 4) ? (kHeld / R) * static_cast<long long>(R)
                                                       : kHeld;
    if (pl.n > per * kThreadsH) return false;
  }
  return true;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The launch: layout (0 ping-pong in shared memory, 1 held, 2 ping-pong in
// device memory), frames a tile, grid, shared bytes, twiddle table, and the
// device scratch in bytes.
struct Launch {
  int layout, F, grid, table, stage;
  size_t smem, scratch;
};

int plan_launch(int C, int T, int M, int m, int D, const Plan& pl, Launch* ln) {
  int budget, sms;
  const int rc = smem_budget(&budget, &sms);
  if (rc) return rc;
  const size_t n = pl.n, tab = 8ull * M;
  const long long frames = static_cast<long long>(C) * T;
  int F = static_cast<int>(kTilePoints / n > 1 ? kTilePoints / n : 1);
  const long long spread = (frames + 4ll * sms - 1) / (4ll * sms);   // tiles for 4 blocks an SM
  if (spread < F) F = static_cast<int>(spread > 1 ? spread : 1);
  if (F > T) F = T;
  ln->F = F;
  ln->scratch = 0;
  ln->stage = 0;
  ln->grid = static_cast<int>(C * static_cast<long long>((T + F - 1) / F));
  const size_t pp = 16ull * F * n;
  const size_t staged = 4ull * (2ll * m * M + static_cast<long long>(F - 1) * D);
  for (int table = 1; table >= 0; --table) {
    if (pp + (table ? tab : 0) <= static_cast<size_t>(budget)) {
      ln->layout = 0;
      ln->table = table;
      ln->smem = pp + (table ? tab : 0);
      ln->stage = ln->smem + staged <= static_cast<size_t>(budget);
      if (ln->stage) ln->smem += staged;
      return 0;
    }
  }
  ln->F = 1;
  ln->grid = static_cast<int>(frames);
  if (held_fits(pl))
    for (int table = 1; table >= 0; --table) {
      if (8ull * n + (table ? tab : 0) <= static_cast<size_t>(budget)) {
        ln->layout = 1;
        ln->table = table;
        ln->smem = 8ull * n + (table ? tab : 0);
        return 0;
      }
    }
  ln->layout = 2;
  ln->grid = static_cast<int>(frames < 2ll * sms ? frames : 2ll * sms);
  ln->table = tab <= static_cast<size_t>(budget);
  ln->smem = ln->table ? tab : 0;
  ln->scratch = 16ull * n * ln->grid;
  return 0;
}

}  // namespace

extern "C" {

// The device scratch, in bytes, that dsr_fb_analysis needs for these
// arguments (0 unless the FFT exceeds what a block holds in shared memory).
int dsr_fb_analysis_scratch(int C, int T, int M, int m, int D, long long* bytes) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl);
  if (pl.nst > kMaxStages) return kNoFit;
  Launch ln;
  const int rc = plan_launch(C, T, M, m, D, pl, &ln);
  *bytes = static_cast<long long>(ln.scratch);
  return rc;
}

// x: (C, S) float32, hf: (L,) float32, out: (C, T, K) complex64; scratch:
// the bytes dsr_fb_analysis_scratch asks for (null when it asks for none).
int dsr_fb_analysis(const float* x, const float* hf, float2* out, void* scratch, int C, int S,
                    int T, int M, int m, int D, void* stream) {
  if (C < 1 || T < 1 || M < 1) return kNoFit;
  Plan pl;
  make_plan(M, &pl);
  if (pl.nst > kMaxStages) return kNoFit;
  Launch ln;
  int rc = plan_launch(C, T, M, m, D, pl, &ln);
  if (rc) return rc;
  if (ln.scratch > 0 && scratch == nullptr) return kNoFit;
  float2* gbuf = ln.layout == 2 ? static_cast<float2*>(scratch) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln.layout == 1) {
    rc = set_smem(reinterpret_cast<const void*>(analysis_fft_kernel<true>), ln.smem);
    if (rc) return rc;
    analysis_fft_kernel<true><<<ln.grid, kThreadsH, ln.smem, st>>>(
        x, hf, out, C, S, T, M, m, D, ln.F, ln.table, 0, pl, nullptr);
  } else {
    rc = set_smem(reinterpret_cast<const void*>(analysis_fft_kernel<false>), ln.smem);
    if (rc) return rc;
    analysis_fft_kernel<false><<<ln.grid, kThreadsS, ln.smem, st>>>(
        x, hf, out, C, S, T, M, m, D, ln.F, ln.table, ln.stage, pl, gbuf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
