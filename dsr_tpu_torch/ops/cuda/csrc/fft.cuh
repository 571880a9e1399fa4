// The mixed-radix Stockham FFT in shared memory (or in device memory) that
// the filterbank's kernels share: the analysis and the fused analysis +
// beamform (analysis.cu) run it forwards on each folded frame, the
// synthesis (filterbank.cu) on the conjugate of each packed spectrum, which
// makes it the inverse transform.  The plan (make_plan), the stages
// (run_stages: ping-pong between two buffers, padded or not, or one buffer
// with each stage's outputs held in registers), the twiddle table of
// e^{-2 pi i j / M} and the launch helpers; analysis.cu's note describes
// the stages and the layouts.  Everything here is in an anonymous
// namespace: each source that includes it has its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

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
  FastDiv by_m, by_k, by_n, by_ki;   // by M, K, n, and the split's items a frame
  Stage st[kMaxStages];
};

// e^{-2 pi i j / M} by sincospif: exact zeros where cos or sin vanishes.
__device__ __forceinline__ float2 twiddle(int j, int M) {
  float sn, cs;
  sincospif(2.0f * j / M, &sn, &cs);
  return make_float2(cs, -sn);
}

// The table's entry (has: tab, in shared memory, holds the table), or the
// same value computed in place.  tab is always a shared-memory address, so
// its loads compile to shared-memory loads.
struct Twiddle {
  const float2* tab;
  int M;
  bool has;
  __device__ __forceinline__ float2 operator()(int j) const {
    if (has) return tab[j];
    return twiddle(j, M);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// x W_8^e for 0 <= e < 4 (e a constant once unrolled): x itself, x (1 - i)
// / sqrt 2, -i x (exact), x (-1 - i) / sqrt 2.
__device__ __forceinline__ float2 twiddle8(float2 x, int e) {
  constexpr float h = 0.707106781186547524f;
  if (e == 0) return x;
  if (e == 1) return make_float2(h * (x.x + x.y), h * (x.y - x.x));
  if (e == 2) return make_float2(x.y, -x.x);
  return make_float2(h * (x.y - x.x), -h * (x.x + x.y));
}

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
  } else if constexpr (R == 3) {   // W = e^{-2 pi i / 3} = c + i sn
    constexpr float c = -0.5f, sn = -0.866025403784438647f;
    const float2 t = cadd(v[1], v[2]), d = csub(v[1], v[2]);
    const float2 mid = make_float2(v[0].x + c * t.x, v[0].y + c * t.y);
    v[0] = cadd(v[0], t);
    v[1] = make_float2(mid.x - sn * d.y, mid.y + sn * d.x);   // mid + i sn d
    v[2] = make_float2(mid.x + sn * d.y, mid.y - sn * d.x);   // mid - i sn d
  } else {   // R == 8 as 2 x 4: with n = 4 n1 + n2 and k = k1 + 2 k2,
             // X[k] = sum_n2 W_4^{n2 k2} W_8^{n2 k1} sum_n1 v[4 n1 + n2] W_2^{n1 k1}
    static_assert(R == 8, "dft: radix 2, 3, 4 or 8");
    float2 a[4][2];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      float2 p[2] = {v[n2], v[n2 + 4]};
      dft<2>(p);
      a[n2][0] = p[0];
      a[n2][1] = twiddle8(p[1], n2);
    }
#pragma unroll
    for (int k1 = 0; k1 < 2; ++k1) {
      float2 q[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
      dft<4>(q);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 2 * k2] = q[k2];
    }
  }
}

// Where point i of a block's frame buffers lies: i + i / 16 when padded
// (one pad point every 16, so a stage's strided loads and stores fall on
// distinct banks), else i.
template <bool kPad>
__device__ __forceinline__ int at(int i) {
  return kPad ? i + (i >> 4) : i;
}

// Points a padded buffer of np points spans.
__host__ __device__ __forceinline__ int padded(int np) { return np + (np + 15) / 16; }

// Butterfly j (< n/R) of a radix-R stage over the frame at `base`: its
// inputs, twiddled, transformed.
template <int R, bool kPad>
__device__ __forceinline__ void butterfly(float2 (&v)[R], const float2* in, int base, int j,
                                          const Stage& g, int jm, const Twiddle& tw, int s) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = in[at<kPad>(base + j + r * g.nR)];
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

// Output k (< R) of butterfly j of a direct length-R stage (any R) over
// the frame at `base`: sum_r in[j + r n/R] W_n^{r (jm step + k n/R)}.
template <bool kPad>
__device__ __forceinline__ float2 direct(const float2* in, int base, int j, int jm, int k, int n,
                                         const Stage& g, const Twiddle& tw, int s) {
  const int e0 = jm * g.step + k * g.nR;
  float2 acc = make_float2(0.f, 0.f);
  int e = 0;
  for (int r = 0; r < g.R; ++r) {
    acc = cadd(acc, cmul(in[at<kPad>(base + j + r * g.nR)], tw(s * e)));
    e += e0;
    if (e >= n) e -= n;
  }
  return acc;
}

// A stage from `in` to `out` over frames [0, nf) of n points (ping-pong).
template <int R, bool kPad>
__device__ void stage_pp(const float2* in, float2* out, int nf, int n, const Stage& g,
                         const Twiddle& tw, int s) {
  for (int b = threadIdx.x; b < nf * g.nR; b += blockDim.x) {
    const int f = g.by_nr.div(b), j = b - f * g.nR;
    int jm;
    const int o = f * n + dest(j, g, &jm);
    float2 v[R];
    butterfly<R, kPad>(v, in, f * n, j, g, jm, tw, s);
#pragma unroll
    for (int k = 0; k < R; ++k) out[at<kPad>(o + k * g.Ns)] = v[k];
  }
}

template <bool kPad>
__device__ void stage_pp_direct(const float2* in, float2* out, int nf, int n, const Stage& g,
                                const FastDiv& by_n, const Twiddle& tw, int s) {
  for (int o = threadIdx.x; o < nf * n; o += blockDim.x) {
    const int f = by_n.div(o), jk = o - f * n, k = g.by_nr.div(jk), j = jk - k * g.nR;
    int jm;
    const int d = dest(j, g, &jm);
    out[at<kPad>(f * n + d + k * g.Ns)] = direct<kPad>(in, f * n, j, jm, k, n, g, tw, s);
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
      butterfly<R, false>(v[i], buf, 0, j, g, jm, tw, s);
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
      v[i] = direct<false>(buf, 0, j, jm, k, n, g, tw, s);
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
// output) and b1; for the held layout b1 is unused.  kMaxR: the largest
// radix of the plan (4, or 8 for make_plan's fused plans); kPad: the
// ping-pong buffers are padded (at<true>).
template <bool kHeldLayout, int kMaxR, bool kPad>
__device__ float2* run_stages(float2* b0, float2* b1, int nf, const Plan& pl,
                              const Twiddle& tw) {
  const int n = pl.n, s = pl.s;
  float2 *in = b0, *out = b1;
  for (int i = 0; i < pl.nst; ++i) {
    const Stage& g = pl.st[i];
    if constexpr (kHeldLayout) {
      if (kMaxR >= 8 && g.R == 8)
        stage_held<kMaxR >= 8 ? 8 : 4>(in, g, tw, s);
      else if (g.R == 4)
        stage_held<4>(in, g, tw, s);
      else if (g.R == 2)
        stage_held<2>(in, g, tw, s);
      else if (g.R == 3)
        stage_held<3>(in, g, tw, s);
      else
        stage_held_direct(in, n, g, tw, s);
    } else {
      if (kMaxR >= 8 && g.R == 8)
        stage_pp<kMaxR >= 8 ? 8 : 4, kPad>(in, out, nf, n, g, tw, s);
      else if (g.R == 4)
        stage_pp<4, kPad>(in, out, nf, n, g, tw, s);
      else if (g.R == 2)
        stage_pp<2, kPad>(in, out, nf, n, g, tw, s);
      else if (g.R == 3)
        stage_pp<3, kPad>(in, out, nf, n, g, tw, s);
      else
        stage_pp_direct<kPad>(in, out, nf, n, g, pl.by_n, tw, s);
      float2* t = in;
      in = out;
      out = t;
    }
    __syncthreads();
  }
  return in;
}

// The fused plan's stages for a power-of-two kN known at compile time
// (make_plan(M, pl, 8): radix 8 first where 8 divides, then 4s, then a 2),
// an even M (s = 2): stage_pp with every radix, stride and divisor a
// constant, so the index arithmetic folds to shifts and masks and the first
// stage's twiddles vanish; the same values as run_stages over that plan.
// Instantiated only at the size where its gain over run_stages was
// measured, the main path's n = 128 (M = 256: the fused kernel in
// analysis.cu, the synthesis's tiles in filterbank.cu).  Returns the buffer
// that holds the transform.
template <int kN, int kNs, bool kPad>
__device__ __forceinline__ float2* stages_pow2(float2* in, float2* out, int nf, const Twiddle& tw) {
  constexpr int left = kN / kNs;
  if constexpr (left == 1) {
    return in;
  } else {
    constexpr int R = kNs == 1 && left % 8 == 0 ? 8 : left % 4 == 0 ? 4 : 2;
    constexpr int nR = kN / R, step = kN / (kNs * R);
    for (int b = threadIdx.x; b < nf * nR; b += blockDim.x) {
      const int f = b / nR, j = b % nR, jm = j % kNs;
      const int o = f * kN + (j / kNs) * kNs * R + jm;
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = in[at<kPad>(f * kN + j + r * nR)];
        if (kNs > 1 && r > 0) v[r] = cmul(v[r], tw(2 * jm * r * step));
      }
      dft<R>(v);
#pragma unroll
      for (int k = 0; k < R; ++k) out[at<kPad>(o + k * kNs)] = v[k];
    }
    __syncthreads();
    return stages_pow2<kN, kNs * R, kPad>(out, in, nf, tw);
  }
}

// Items a frame of the fused kernel's split (analysis.cu split_item): M/4 + 1
// for even M (bins k and n - k an item), (M + 1) / 2 for odd M.
__host__ __device__ __forceinline__ int split_items(int M) {
  return M % 2 == 0 ? M / 4 + 1 : (M + 1) / 2;
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

// The FFT's length and stages: one radix-8 stage where 8 divides (when
// max_radix is 8: the fused kernel's plans; the analysis's is 4), radix 4
// while 4 divides, then 2, then 3s, then the other primes in increasing
// order.
void make_plan(int M, Plan* pl, int max_radix) {
  const int n = M % 2 == 0 ? M / 2 : M;
  pl->n = n;
  pl->s = M / n;
  pl->by_m = FastDiv(M);
  pl->by_k = FastDiv(M / 2 + 1);
  pl->by_n = FastDiv(n);
  pl->by_ki = FastDiv(split_items(M));
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
  if (max_radix >= 8 && r % 8 == 0) add(8);
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
    const long long per = (R == 2 || R == 3 || R == 4 || R == 8)
                              ? (kHeld / R) * static_cast<long long>(R)
                              : kHeld;
    if (pl.n > per * kThreadsH) return false;
  }
  return true;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
