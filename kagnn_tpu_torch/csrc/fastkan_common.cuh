// Shared device code of the RBF kernels (fastkan_layer.cu, gin_fastkan.cu,
// rbf_fused.cu): LayerNorm statistics, the RBF basis of one value, the
// [SiLU |] RBF basis chunk (f32, or as bf16 terms for the tensor cores), the
// chunked basis x weight product of a row tile (on the CUDA cores, or on the
// tensor cores), the whole layer's forward on a row tile, and the dtype
// dispatch at the number of centers a library is built for (FKAN_G, any
// count >= 2: one library per count, built at its first use,
// kernels/_build.py).
//
// The layer, as kagnn_tpu/pallas/fastkan_layer.py::_fwd_kernel computes it:
//   xhat = (x - mean) * rsqrt(var + eps)          (f32 statistics over D)
//   xs   = xhat * lng + lnb
//   B_g  = exp(-((xs - c_g) * inv_h)^2)           g = 0..G-1
//   out  = sum_g B_g @ W_g + SiLU(x) @ Wb + bb
// Basis and SiLU(x) stay in f32 before the products (the JAX kernel takes
// jnp.dot(f32 basis, W) with W in the compute dtype, a product in f32).
#pragma once

#include "kan_common.cuh"
#include "mma_common.cuh"

// The number of centers a library of a FastKAN source is built for (-D
// FKAN_G, kernels/_build.py); the default is the main path's.
#ifndef FKAN_G
#define FKAN_G 4
#endif

namespace fkan {

using kan::from_f;
using kan::kDC;
using kan::kFwdRows;
using kan::kOT;
using kan::kThreads;
using kan::sigmoid;
using kan::to_f;

constexpr float kLnEps = 1e-5f;

// The RBF centers c_0..c_{G-1}, computed on the host exactly as the JAX
// kernels build them (c_0 + g * step, in f32 or, for the RBF product of a
// bf16 x, in bf16), passed by value: the library's FKAN_G of them.
struct Centers {
  float c[FKAN_G];
};

// The G centers in host memory as kernel parameters.
inline Centers centers_of(const float* c, int G) {
  Centers cs{};
  for (int g = 0; g < G && g < FKAN_G; ++g) cs.c[g] = c[g];
  return cs;
}

// Columns of one feature chunk of the basis matrix A = [SiLU(x) |] B_0..B_G-1:
// column g*DC + j holds feature d0 + j of group g (with BASE, g = 0 is
// SiLU and group g + 1 is B_g; without, group g is B_g). The chunk is 32
// features wide up to 8 centers and narrower past them (16 up to 16, 8 up to
// 32), so that a chunk's basis and the staged weight tiles stay near the
// size they have at 8 centers (at most 264 columns).
template <int G, bool BASE = true> struct Shape {
  static constexpr int B0 = BASE ? 1 : 0;  // group of B_0
  static constexpr int NG = G + B0;        // groups: [SiLU +] centers
  static constexpr int DC = G <= 8 ? kDC : (G <= 16 ? 16 : 8);  // features a chunk
  static constexpr int AC = NG * DC;       // columns of a chunk
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Mean and 1/sqrt(var + eps) of one row of D values xv(c), two passes as
// the JAX kernel's _ln_stats, by one warp: every lane ends with the same
// values, in a fixed summation order (lane-strided sums, then a butterfly).
template <typename XV>
__device__ __forceinline__ void row_stats(XV xv, int D, float& mu, float& rstd) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += xv(c);
  mu = warp_sum(s) / (float)D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float xc = xv(c) - mu;
    q += xc * xc;
  }
  const float var = warp_sum(q) / (float)D;
  rstd = 1.f / sqrtf(var + kLnEps);
}

// row_stats of each of `rows` rows, xv(rr, c) the f32 value of column c of
// local row rr; one warp per row.
template <typename XV>
__device__ __forceinline__ void ln_stats(XV xv, int rows, int D, float* mu_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < rows; rr += kThreads / 32) {
    float mu, rstd;
    row_stats([&](int c) { return xv(rr, c); }, D, mu, rstd);
    if (lane == 0) {
      mu_s[rr] = mu;
      rstd_s[rr] = rstd;
    }
  }
}

// ln_stats with four threads a row, kThreads / 4 rows at once: each thread
// sums every fourth value of its row, then two shuffles join the four, for
// the mean and then the variance (two passes, in f32, in another summation
// order than row_stats'). Where a tile's rows are few and short (the
// tensor-core forward's 64), one warp a row walks them one after another.
template <typename XV>
__device__ __forceinline__ void ln_stats_quad(XV xv, int rows, int D, float* mu_s,
                                              float* rstd_s) {
  const int part = threadIdx.x % 4;
  for (int r0 = 0; r0 < rows; r0 += kThreads / 4) {  // every lane takes every pass
    const int rr = r0 + threadIdx.x / 4;
    const bool ok = rr < rows;
    float s = 0.f;
    if (ok)
      for (int c = part; c < D; c += 4) s += xv(rr, c);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / (float)D;
    float q = 0.f;
    if (ok)
      for (int c = part; c < D; c += 4) {
        const float xc = xv(rr, c) - mu;
        q += xc * xc;
      }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if (ok && part == 0) {
      mu_s[rr] = mu;
      rstd_s[rr] = 1.f / sqrtf(q / (float)D + kLnEps);
    }
  }
}

// The G basis values of one basis input xs and their scaled distances
// d_g = (xs - c_g) * inv_h (needed by the backward). TR is the type the
// distance is computed in: each of xs - c_g, the product with inv_h and
// d * d is rounded to it, as the JAX RBF kernel computes in x's dtype (no
// rounding for float). ROUND_EXP rounds the basis to TR as well.
template <int G, typename TR = float, bool ROUND_EXP = false>
__device__ __forceinline__ void rbf(float xs, const Centers& cs, float inv_h, float (&b)[G],
                                    float (&dist)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float d = kan::round_t<TR>(kan::round_t<TR>(xs - cs.c[g]) * inv_h);
    dist[g] = d;
    const float e = expf(-kan::round_t<TR>(d * d));
    b[g] = ROUND_EXP ? kan::round_t<TR>(e) : e;
  }
}

// Fill the basis chunk A_s (rows x Shape<G, BASE>::AC floats) for features
// d0..d0+DC-1. load(rr, row, d, x, xs) gives the layer input x (for SiLU)
// and the basis input xs (x after the layernorm, or x itself); rows at or
// past row_end and features past D give zeros. TR and ROUND_EXP as in rbf.
template <int G, bool BASE, typename TR = float, bool ROUND_EXP = false, typename Load>
__device__ __forceinline__ void basis_chunk(Load load, float* A_s, int rows, int row0,
                                            int row_end, int d0, int D, const Centers& cs,
                                            float inv_h) {
  using S = Shape<G, BASE>;
  const int dd = threadIdx.x % S::DC;
  const int d = d0 + dd;
  for (int rr = threadIdx.x / S::DC; rr < rows; rr += kThreads / S::DC) {
    const int row = row0 + rr;
    float* a = A_s + rr * S::AC + dd;
    if (d < D && row < row_end) {
      float xv, xs;
      load(rr, row, d, xv, xs);
      if constexpr (BASE) a[0] = xv * sigmoid(xv);
      float b[G], dist[G];
      rbf<G, TR, ROUND_EXP>(xs, cs, inv_h, b, dist);
#pragma unroll
      for (int g = 0; g < G; ++g) a[(g + S::B0) * S::DC] = b[g];
    } else {
#pragma unroll
      for (int g = 0; g < S::NG; ++g) a[g * S::DC] = 0.f;
    }
  }
}

// The layer's basis chunk [SiLU(x) | B(LN(x))]: load_x(rr, row, d) gives
// the layer input, stats(rr, row, &mu, &rstd) its row statistics, and
// xs = xhat * lng + lnb.
template <typename T, int G, typename LoadX, typename Stats>
__device__ __forceinline__ void build_chunk(LoadX load_x, Stats stats, float* A_s, int rows,
                                            int row0, int row_end, int d0, int D,
                                            const T* __restrict__ lng,
                                            const T* __restrict__ lnb, const Centers& cs,
                                            float inv_h) {
  const int d = d0 + threadIdx.x % Shape<G>::DC;
  const float gam = d < D ? to_f(lng[d]) : 0.f;
  const float bet = d < D ? to_f(lnb[d]) : 0.f;
  auto load = [&](int rr, int row, int dc, float& xv, float& xs) {
    xv = load_x(rr, row, dc);
    float mu, rstd;
    stats(rr, row, mu, rstd);
    xs = ((xv - mu) * rstd) * gam + bet;
  };
  basis_chunk<G, true>(load, A_s, rows, row0, row_end, d0, D, cs, inv_h);
}

// Row d of group g of the weight [Wb;] W: with BASE group 0 is the base
// weight (D, O) and group g >= 1 row (g-1)*D + d of the spline weight, laid
// out g-major as (G*D, O); without, group g is row g*D + d.
template <bool BASE = true, typename T>
__device__ __forceinline__ const T* weight_row(const T* wb, const T* w, int g, int d, int D,
                                               int O) {
  if constexpr (!BASE) return w + ((size_t)g * D + d) * O;
  return g == 0 ? wb + (size_t)d * O : w + ((size_t)(g - 1) * D + d) * O;
}

// The product of one tile of kFwdRows rows starting at row0 with the
// weight, one DC-feature chunk at a time: build(d0) fills A_s (kFwdRows x
// Shape<G, BASE>::AC floats) with the chunk's basis, then
//   out[row, o] = sum_{g, d} A[row, g*D + d] * [Wb;] W[g*D + d, o] (+ bb[o])
// in f32, written in TO; the bias only with BASE. Thread t owns output
// column blockIdx.y*kOT + t % kOT for 8 rows (row group t / kOT).
template <int G, bool BASE, typename TW, typename TO, typename Build>
__device__ __forceinline__ void chunked_forward(Build build, float* A_s, int row0, int n, int D,
                                                int O, const TW* __restrict__ wb,
                                                const TW* __restrict__ w,
                                                const TW* __restrict__ bb, TO* __restrict__ out) {
  using S = Shape<G, BASE>;
  const int o = blockIdx.y * kOT + threadIdx.x % kOT;
  const int rg = threadIdx.x / kOT;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += S::DC) {
    __syncthreads();  // what build reads is written; the previous chunk is consumed
    build(d0);
    __syncthreads();
    const int dn = min(S::DC, D - d0);
    if (o < O) {
      const float* a0 = A_s + rg * 8 * S::AC;
#pragma unroll
      for (int g = 0; g < S::NG; ++g) {
        const TW* wrow = weight_row<BASE>(wb, w, g, d0, D, O) + o;
        for (int j = 0; j < dn; ++j) {
          const float wv = to_f(wrow[(size_t)j * O]);
          const float* a = a0 + g * S::DC + j;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += a[i * S::AC] * wv;
        }
      }
    }
  }
  if (o < O) {
    float bias = 0.f;
    if constexpr (BASE) bias = to_f(bb[o]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + rg * 8 + i;
      if (row < n) out[(size_t)row * O + o] = from_f<TO>(BASE ? acc[i] + bias : acc[i]);
    }
  }
}

// ---- on the tensor cores --------------------------------------------------

// bf16 terms of each f32 basis value in the tensor-core forward at G
// centers: hi + lo (about 2^-17 of the value) up to 8 centers, hi + mid +
// lo (the value whole: the JAX kernel's exact f32 products) past 8. Either
// keeps a layer within an ulp of its plain version, but the next layer
// amplifies this one's rounding differences by its basis's slope, which
// grows with G (inv_h = (G-1) / (grid_max - grid_min)): a one-conv step at
// 32 centers read its logits 4 ulps off the plain model's with two terms,
// against a bar of 3.5, and 2.6 with three (my chip runs, PR 7, NVIDIA H100
// 80GB HBM3, 700.00 W). The third term's tile costs a block an SM at wide
// outputs, so the main path's 4 centers keep two.
template <int G>
constexpr int kFwdTerms = G > 8 ? 3 : 2;

// basis_chunk's columns as TERMS bf16 terms (kan::split_terms) for the
// tensor cores: term q of local row rr at A_s + q*tstride + rr*pa, column
// g*FC + j = group g of feature d0 + j (with BASE, g = 0 is SiLU(x)), for
// rows rr < rows, of which the first `valid` are data (the others, and
// features past D, zeros). load(rr, row, d, x, xs) as basis_chunk's; each
// value is computed in f32 as basis_chunk computes it (TR and ROUND_EXP as
// in rbf: the RBF product of a bf16 x rounds its distance and its basis to
// bf16, which one term then carries whole), then split. Thread t takes the
// features j and j + 1, j = 2 * (t % (FC / 2)).
template <int G, bool BASE, int FC, int TERMS, typename TR = float, bool ROUND_EXP = false,
          typename Load>
__device__ __forceinline__ void basis_terms(Load load, kan::bf16* A_s, int pa, size_t tstride,
                                            int rows, int row0, int valid, int d0, int D,
                                            const Centers& cs, float inv_h) {
  constexpr int B0 = BASE ? 1 : 0, HP = FC / 2;
  const int j = 2 * (threadIdx.x % HP), d = d0 + j;
  for (int rr = threadIdx.x / HP; rr < rows; rr += kThreads / HP) {
    const bool ok0 = rr < valid && d < D, ok1 = rr < valid && d + 1 < D;
    float xv0 = 0.f, xs0 = 0.f, xv1 = 0.f, xs1 = 0.f;
    if (ok0) load(rr, row0 + rr, d, xv0, xs0);
    if (ok1) load(rr, row0 + rr, d + 1, xv1, xs1);
    kan::bf16* a = A_s + (size_t)rr * pa + j;
    if constexpr (BASE)
      kan::split_terms<TERMS>(a, tstride, ok0 ? xv0 * sigmoid(xv0) : 0.f,
                              ok1 ? xv1 * sigmoid(xv1) : 0.f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e0 = kan::round_t<TR>(kan::round_t<TR>(xs0 - cs.c[g]) * inv_h);
      const float e1 = kan::round_t<TR>(kan::round_t<TR>(xs1 - cs.c[g]) * inv_h);
      float b0 = expf(-kan::round_t<TR>(e0 * e0)), b1 = expf(-kan::round_t<TR>(e1 * e1));
      if constexpr (ROUND_EXP) {
        b0 = kan::round_t<TR>(b0);
        b1 = kan::round_t<TR>(b1);
      }
      kan::split_terms<TERMS>(a + (g + B0) * FC, tstride, ok0 ? b0 : 0.f, ok1 ? b1 : 0.f);
    }
  }
}

// The FastKAN forwards' tiles on the tensor cores: 64 rows (kFwdMT m-tiles
// a warp) and chunks of about 128 basis columns (kan::FwdChunk: 16 features
// at 4 centers).
constexpr int kFwdMT = 2;
template <int G, bool BASE = true>
using FwdChunk = kan::FwdChunk<Shape<G, BASE>::NG, 128>;

// chunked_forward on the tensor cores, for one row tile of 32*MT rows: per
// chunk of FC features (FwdChunk), build(d0) fills the chunk's TERMS bf16
// terms in A_s (TERMS tiles of 32*MT x (KC + 8), basis_terms, which takes
// basis_chunk's Load), and the warps multiply them with the chunk's weight
// slab slab(c) (row g*FC + j = [Wb;] W row (g, c*FC + j), zeros past the
// groups and past D) into acc. prefetch as in kan::forward_tile_mma.
template <int G, bool BASE, int TERMS, int MT, int NPW, typename Build, typename Prefetch,
          typename Slab>
__device__ __forceinline__ void chunked_forward_mma(kan::FwdAcc<MT, NPW>& acc, Build build,
                                                    Prefetch prefetch, Slab slab,
                                                    const kan::bf16* A_s, int D, int wp, int np) {
  using C = FwdChunk<G, BASE>;
  constexpr int pa = C::KC + 8;
  kan::forward_tile_mma<TERMS, C::KC, MT, NPW>(
      acc, (D + C::FC - 1) / C::FC, prefetch, [&](int c) { build(c * C::FC); }, slab, A_s, pa,
      (size_t)32 * MT * pa, wp, np);
}

// The whole FastKANLayer forward of one tile of kFwdRows rows starting at
// row0, whose f32 input is xv(rr, d) for local row rr (from shared memory,
// or for wide rows from device memory): statistics into mu_s/rstd_s, then
// per feature chunk the basis matrix in A_s (kFwdRows x AC floats) and its
// products with [Wb; W] in f32.
template <typename T, int G, typename XV>
__device__ __forceinline__ void forward_tile(XV xv, float* A_s, float* mu_s, float* rstd_s,
                                             int row0, int n, int D, int O,
                                             const T* __restrict__ lng,
                                             const T* __restrict__ lnb, const Centers& cs,
                                             float inv_h, const T* __restrict__ w,
                                             const T* __restrict__ wb,
                                             const T* __restrict__ bb, T* __restrict__ out) {
  __syncthreads();  // what xv reads is complete
  ln_stats(xv, kFwdRows, D, mu_s, rstd_s);
  auto load_x = [&](int rr, int, int d) { return xv(rr, d); };
  auto stats = [&](int rr, int, float& mu, float& rstd) {
    mu = mu_s[rr];
    rstd = rstd_s[rr];
  };
  auto build = [&](int d0) {
    build_chunk<T, G>(load_x, stats, A_s, kFwdRows, row0, n, d0, D, lng, lnb, cs, inv_h);
  };
  chunked_forward<G, true>(build, A_s, row0, n, D, O, wb, w, bb, out);
}

// Shared memory of forward_tile's caller: [x_s (kFwdRows x D, when the
// rows are held),] A_s, mu_s, rstd_s.
template <int G> constexpr size_t forward_smem(int D, bool hold) {
  return sizeof(float) * ((hold ? (size_t)kFwdRows * D : 0) + (size_t)kFwdRows * Shape<G>::AC +
                          2 * kFwdRows);
}

}  // namespace fkan

// Calls FN<T, FKAN_G>(args...) for f32/bf16 and returns
// cudaErrorInvalidValue for another dtype or number of centers.
#define FASTKAN_DISPATCH(dtype, G_, FN, ...)                                   \
  do {                                                                         \
    if (G_ != FKAN_G) return (int)cudaErrorInvalidValue;                       \
    if (dtype == kan::kF32) return FN<float, FKAN_G>(__VA_ARGS__);             \
    if (dtype == kan::kBF16) return FN<__nv_bfloat16, FKAN_G>(__VA_ARGS__);    \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)

// FASTKAN_DISPATCH for a backward that also takes the parameters' dtype
// (their gradients' type): FN<T, TW, FKAN_G> for both f32, both bf16, or an
// f32 x with bf16 parameters (the JAX kernels' mixed pair).
#define FASTKAN_DISPATCH_W(dtype, wdtype, G_, FN, ...)                         \
  do {                                                                         \
    if (G_ != FKAN_G) return (int)cudaErrorInvalidValue;                       \
    if (dtype == kan::kF32 && wdtype == kan::kF32)                             \
      return FN<float, float, FKAN_G>(__VA_ARGS__);                            \
    if (dtype == kan::kBF16 && wdtype == kan::kBF16)                           \
      return FN<__nv_bfloat16, __nv_bfloat16, FKAN_G>(__VA_ARGS__);            \
    if (dtype == kan::kF32 && wdtype == kan::kBF16)                            \
      return FN<float, __nv_bfloat16, FKAN_G>(__VA_ARGS__);                    \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)
