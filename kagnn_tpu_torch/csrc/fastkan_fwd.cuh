// The FastKAN forwards as device bodies with their launches, shared by
// fastkan_layer.cu (the FastKANLayer on its x), gin_fastkan.cu (the layer on
// the GIN aggregate's unrounded f32 z) and rbf_fused.cu (the RBF product
// alone, kagnn_tpu/pallas/rbf_fused.py::_fwd_kernel, where w is bf16):
//   * layer_fwd_f32_body: the layer in f32 on the CUDA cores, a 32-row tile x
//     64 outputs a block (forward_tile; TF32 would miss the f32 bars);
//   * fwd_mma_body: on the tensor cores, either the whole layer (LAYER:
//     LayerNorm statistics and affine, [SiLU(x) | B(LN(x))], the bias) or
//     the RBF product (B(x) alone, its distance rounded to x's type as the
//     JAX RBF kernel computes it). Persistent blocks walk row tiles of R = 64
//     rows (kFwdMT) and own all of their outputs (or parts of 256); per chunk
//     of FC features (FwdChunk: 16 at 4-8 centers) the chunk's basis is
//     built once as bf16 terms (basis_terms, kMmaTerms: the layer's f32
//     basis as kFwdTerms<G> terms, two up to 8 centers and three past; the
//     RBF product's f32 basis as three, the value whole; the bf16-rounded
//     basis of a bf16 x as one, which carries it whole) and multiplied with the
//     chunk's weight slab for all of the block's outputs
//     (chunked_forward_mma); the output (bf16, or f32 for the RBF product
//     of an f32 x) is rounded once. Shared memory: the weight slabs (every
//     chunk's, staged once with cp.async, or two taking turns), the terms,
//     the tile's statistics (LAYER) and, where the plan holds them, two
//     buffers of the tiles' x rows in TX (f32 rows take twice the bytes of
//     bf16 ones), the next tile's copied while this one computes; the plan
//     is kan::plan_forward's, by occupancy, made at the first launch of each
//     (D, O). NPW: output pairs a warp holds (kan::fwd_pairs); one pair
//     leaves registers for three blocks an SM.
#pragma once

#include "fastkan_common.cuh"

#include <unordered_map>

namespace fkan {

using kan::bf16;

// ---- on the CUDA cores ------------------------------------------------------

// The layer in f32 of the 32-row tile blockIdx.x, outputs blockIdx.y * 64..:
// the tile's rows held in shared memory (HOLD, where they fit) or read from
// device memory (wide rows).
template <typename T, int G, bool HOLD>
__device__ __forceinline__ void layer_fwd_f32_body(const T* __restrict__ x,
                                                   const T* __restrict__ lng,
                                                   const T* __restrict__ lnb,
                                                   const T* __restrict__ w,
                                                   const T* __restrict__ wb,
                                                   const T* __restrict__ bb, T* __restrict__ out,
                                                   int n, int D, int O, const Centers& cs,
                                                   float inv_h) {
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;  // kFwdRows x AC
  float* mu_s = A_s + (size_t)kFwdRows * Shape<G>::AC;
  float* rstd_s = mu_s + kFwdRows;
  float* x_s = rstd_s + kFwdRows;  // kFwdRows x D, with HOLD
  const int row0 = blockIdx.x * kFwdRows;
  if constexpr (HOLD) {
    for (int i = threadIdx.x; i < kFwdRows * D; i += kThreads) {
      const int row = row0 + i / D;
      x_s[i] = row < n ? to_f(x[(size_t)row0 * D + i]) : 0.f;
    }
  }
  auto xv = [&](int rr, int d) -> float {
    if constexpr (HOLD) return x_s[(size_t)rr * D + d];
    return row0 + rr < n ? to_f(x[(size_t)(row0 + rr) * D + d]) : 0.f;
  };
  forward_tile<T, G>(xv, A_s, mu_s, rstd_s, row0, n, D, O, lng, lnb, cs, inv_h, w, wb, bb, out);
}

// The launch of a kernel whose body is layer_fwd_f32_body<float, G, HOLD>:
// kernel_of(std::bool_constant<HOLD>) gives it.
template <int G, typename KernelOf>
int launch_layer_fwd_f32(KernelOf kernel_of, const float* x, const float* lng, const float* lnb,
                         const float* w, const float* wb, const float* bb, float* out, int n,
                         int D, int O, const Centers& cs, float inv_h, cudaStream_t stream) {
  // the tile's rows held in shared memory where they fit (every main path)
  const bool hold = forward_smem<G>(D, true) <= kan::kSmemLimit;
  const size_t smem = forward_smem<G>(D, hold);
  if (smem > kan::kSmemLimit) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  auto go = [&](auto kernel) {
    if (int e = kan::set_smem(kernel, smem)) return e;
    if (grid.x > 0 && grid.y > 0)
      kernel<<<grid, kThreads, smem, stream>>>(x, lng, lnb, w, wb, bb, out, n, D, O, cs, inv_h);
    return (int)cudaGetLastError();
  };
  return hold ? go(kernel_of(std::bool_constant<true>{}))
              : go(kernel_of(std::bool_constant<false>{}));
}

// ---- on the tensor cores ----------------------------------------------------

// bf16 terms of each basis value: the layer's f32 basis (its output bf16)
// kFwdTerms<G>; the RBF product's f32 basis three, the value whole (its
// output is f32: two terms read about 1.1 of the f32 bar against the JAX
// kernel, tests/test_torch_rbf_terms.py); the RBF product of a bf16 x builds
// a bf16 basis, one term.
template <typename TX, int G, bool LAYER>
constexpr int kMmaTerms = LAYER ? kFwdTerms<G> : (std::is_same_v<TX, bf16> ? 1 : 3);

// fwd_mma_body's shared memory besides its weight slabs and held rows: the
// basis terms and, for the layer, the tile's statistics.
template <typename TX, int G, bool LAYER>
constexpr size_t fwd_mma_fixed() {
  constexpr int R = 32 * kFwdMT;
  return sizeof(bf16) * kMmaTerms<TX, G, LAYER> * R * (FwdChunk<G, LAYER>::KC + 8) +
         (LAYER ? sizeof(float) * 2 * R : 0);
}

// The body of a kernel launched with grid (persistent row blocks, output
// parts of plan.op): out (n, O) in TO from x (n, D) in TX and the bf16
// weights w (G*D, O) g-major and, with LAYER, lng, lnb (D,), wb (D, O) and bb
// (O,) (null without).
template <typename TX, typename TO, int G, bool LAYER, int NPW>
__device__ __forceinline__ void fwd_mma_body(const TX* __restrict__ x,
                                             const bf16* __restrict__ lng,
                                             const bf16* __restrict__ lnb,
                                             const bf16* __restrict__ w,
                                             const bf16* __restrict__ wb,
                                             const bf16* __restrict__ bb, TO* __restrict__ out,
                                             int n, int D, int O, const Centers& cs, float inv_h,
                                             const kan::FwdPlan& plan) {
  using C = FwdChunk<G, LAYER>;
  constexpr int NG = Shape<G, LAYER>::NG, R = 32 * kFwdMT, TERMS = kMmaTerms<TX, G, LAYER>;
  constexpr int FC = C::FC, KC = C::KC, pa = KC + 8;
  constexpr size_t tstride = (size_t)R * pa;
  // the RBF product rounds its distance and basis to x's type
  using TR = std::conditional_t<LAYER, float, TX>;
  constexpr bool kRoundExp = !LAYER && std::is_same_v<TX, bf16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (D + FC - 1) / FC, tiles = (n + R - 1) / R;
  const int wp = plan.wp, xp = plan.xp;
  const int o0 = blockIdx.y * plan.op, ow = min(plan.op, O - o0), np = (ow + 15) / 16;
  bf16* W_s = reinterpret_cast<bf16*>(smem_raw);                           // slabs, KC x wp
  bf16* A_s = W_s + (size_t)(plan.resident ? chunks : 2) * KC * wp;       // TERMS x R x pa
  float* mu_s = reinterpret_cast<float*>(A_s + TERMS * tstride);          // R, with LAYER
  float* rstd_s = mu_s + R;                                                // R, with LAYER
  TX* x_s = reinterpret_cast<TX*>(mu_s + (LAYER ? 2 * R : 0));             // 2 x R x xp
  if constexpr (KC > NG * FC) {  // the columns past the groups stay zero
    constexpr int padc = KC - NG * FC;
    for (int i = threadIdx.x; i < TERMS * R * padc; i += kThreads)
      A_s[(size_t)(i / padc) * pa + NG * FC + i % padc] = from_f<bf16>(0.f);
  }
  auto stage_w = [&](int c, int slot) {
    kan::stage_rows(W_s + (size_t)slot * KC * wp, wp, KC, ow, np * 16, O % 8 == 0,
                    [&](int k) -> const bf16* {
                      const int g = k / FC, d = c * FC + k % FC;
                      return g < NG && d < D ? weight_row<LAYER>(wb, w, g, d, D, O) + o0
                                             : nullptr;
                    });
  };
  auto stage_x = [&](int t, int b) {
    kan::stage_rows(x_s + (size_t)b * R * xp, xp, R, D, kan::round_up(D, 8),
                    D % (16 / (int)sizeof(TX)) == 0, [&](int r) -> const TX* {
                      const int row = t * R + r;
                      return row < n ? x + (size_t)row * D : nullptr;
                    });
  };
  int t = blockIdx.x;
  if (t >= tiles) return;
  if (plan.resident) {
    for (int c = 0; c < chunks; ++c) stage_w(c, c);
  } else {
    stage_w(0, 0);
  }
  if (plan.hold) stage_x(t, 0);
  kan::cp_async_commit();
  kan::FwdAcc<kFwdMT, NPW> acc;
  kan::fwd_zero(acc);
  for (int step = 0, xb = 0; t < tiles; t += gridDim.x, step += chunks, xb ^= 1) {
    const int row0 = t * R, next = t + gridDim.x, valid = min(R, n - row0);
    const TX* xt = x_s + (size_t)xb * R * xp;
    // the tile's rows from shared memory, or (rows not held) device memory
    auto xv = [&](int rr, int d) -> float {
      if (plan.hold) return to_f(xt[(size_t)rr * xp + d]);
      return row0 + rr < n ? to_f(x[(size_t)(row0 + rr) * D + d]) : 0.f;
    };
    auto build = [&](int d0) {
      if constexpr (LAYER) {
        if (d0 == 0) {  // the tile's statistics, before its first chunk
          ln_stats_quad(xv, R, D, mu_s, rstd_s);
          __syncthreads();
        }
        // this thread's two features (basis_terms) and their affine
        const int dj = d0 + 2 * (threadIdx.x % (FC / 2));
        const float g0 = dj < D ? to_f(lng[dj]) : 0.f, g1 = dj + 1 < D ? to_f(lng[dj + 1]) : 0.f;
        const float b0 = dj < D ? to_f(lnb[dj]) : 0.f, b1 = dj + 1 < D ? to_f(lnb[dj + 1]) : 0.f;
        auto load = [&](int rr, int, int d, float& v, float& xs) {
          v = xv(rr, d);
          const bool second = d != dj;
          xs = ((v - mu_s[rr]) * rstd_s[rr]) * (second ? g1 : g0) + (second ? b1 : b0);
        };
        basis_terms<G, true, FC, TERMS>(load, A_s, pa, tstride, R, row0, valid, d0, D, cs,
                                        inv_h);
      } else {
        auto load = [&](int rr, int, int d, float& v, float& xs) { v = xs = xv(rr, d); };
        basis_terms<G, false, FC, TERMS, TR, kRoundExp>(load, A_s, pa, tstride, R, row0, valid,
                                                        d0, D, cs, inv_h);
      }
    };
    auto prefetch = [&](int c) {
      const bool last = c + 1 == chunks;
      if (!plan.resident && (!last || next < tiles)) stage_w(last ? 0 : c + 1, (step + c + 1) & 1);
      if (plan.hold && last && next < tiles) stage_x(next, xb ^ 1);
    };
    auto slab = [&](int c) -> const bf16* {
      return W_s + (size_t)(plan.resident ? c : (step + c) & 1) * KC * wp;
    };
    chunked_forward_mma<G, LAYER, TERMS, kFwdMT, NPW>(acc, build, prefetch, slab, A_s, D, wp, np);
    kan::fwd_store<kFwdMT, NPW>(acc, out, row0, n, O, o0, np, [&](int o) {
      if constexpr (LAYER) return o < O ? to_f(bb[o]) : 0.f;
      return 0.f;
    });
  }
  kan::cp_async_wait<0>();  // the last, empty, commit group
}

// go(std::integral_constant<int, NPW>{}, op) at the widest output part op
// that fits a kernel whose body is fwd_mma_body<TX, ., G, LAYER, NPW> (its
// smallest layout), with the output pairs a warp holds there.
template <typename TX, int G, bool LAYER, typename Go>
int with_fwd_mma_part(int n, int O, Go go) {
  const int op = kan::fwd_part_width(O, FwdChunk<G, LAYER>::KC, fwd_mma_fixed<TX, G, LAYER>());
  if (op == 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || O == 0) return 0;
  const int npw = kan::fwd_pairs(op);
  return npw == 1 ? go(std::integral_constant<int, 1>{}, op)
                  : npw == 2 ? go(std::integral_constant<int, 2>{}, op)
                             : go(std::integral_constant<int, 4>{}, op);
}

// The plan of `kernel` (its body fwd_mma_body<TX, ., G, LAYER, .>) at part
// width op, made at its first launch of each (D, O) and kept, and its grid;
// null if no layout fits.
template <typename TX, int G, bool LAYER, typename K>
const kan::FwdPlan* fwd_mma_plan(K kernel, int n, int D, int O, int op, dim3& grid) {
  using C = FwdChunk<G, LAYER>;
  constexpr int R = 32 * kFwdMT;
  static std::unordered_map<const void*, std::unordered_map<uint64_t, kan::FwdPlan>> plans;
  kan::FwdPlan& plan = plans[(const void*)kernel][(uint64_t)D << 32 | (uint32_t)O];
  if (plan.smem == 0) {
    const size_t xrows = sizeof(TX) * 2 * R * (size_t)(kan::round_up(D, 8) + 8);
    plan = kan::plan_forward(kernel, op, D, C::KC, (D + C::FC - 1) / C::FC,
                             fwd_mma_fixed<TX, G, LAYER>(), xrows);
    if (plan.smem == 0) return nullptr;
  }
  static const int sms = kan::sm_count();
  grid = dim3(std::min((n + R - 1) / R, plan.per_sm * sms), (O + plan.op - 1) / plan.op);
  return &plan;
}

}  // namespace fkan
