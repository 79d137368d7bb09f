// Fused FastKANLayer forward and backward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/fastkan_layer.py::_fwd_kernel and ::_bwd_kernel
// (the latter also serves gin_fastkan.py::_gf_bwd):
//   out = sum_g B_g(LN(x)) @ W_g + SiLU(x) @ Wb + bb      (fastkan_common.cuh)
// and its VJP: dx, dlng, dlnb, dW, dWb, dbb, every intermediate rebuilt from
// x alone, as the JAX kernel does.
//
// Bound on the H100: at the main path's shapes (N = 169,344 rows, D = 64 or
// 128, O = 64 or 40, G = 4) each product is 2*N*(G+1)*D*O operations
// against N*(D+O) elements moved, about 80-160 operations per byte, below
// the bf16 tensor-core ridge of about 295: device-memory bytes bound it.
// The (N, G*D) basis never leaves the SM.
//
// The forward, under bf16, runs its products on the tensor cores
// (fastkan_fwd_mma_kernel, fastkan_fwd.cuh's body, which gin_fastkan.cu and
// rbf_fused.cu share; the design of the B-spline forward's,
// mma_common.cuh): the JAX kernel multiplies the f32 basis and SiLU(x) with
// the bf16 weights, exact products summed in f32, so each f32 value is
// split into bf16 terms (kan::split_terms, the dW kernel's split: hi + lo up
// to 8 centers, hi + mid + lo, the value whole, past 8: kFwdTerms), built
// once per block for all of its outputs; the products go to f32
// accumulators and the output is rounded once. In f32 it stays on the CUDA
// cores (fastkan_fwd_kernel).
//
// The backward, under bf16, runs its products on the tensor cores
// (mma.sync.m16n8k16, bf16 operands from ldmatrix, f32 accumulators), with
// row tiles staged by cp.async; in f32 the same kernels multiply on the CUDA
// cores. Launches (the wrapper puts 2-5 on a second stream beside 6-7 on
// the caller's, after 1; they share only their inputs and `stats`):
//   1. fastkan_stats_kernel: each row's LayerNorm mean and 1/sqrt(var +
//      eps), in ln_stats' summation order, into `stats` (N, 2);
//   2. fastkan_dx_kernel<1>, the sums: persistent blocks each own one feature
//      chunk (DC features: 32 up to 8 centers, 16 up to 16, 8 past) and one part
//      of the outputs (all of them unless the chunk's weights and two row
//      tiles do not fit: wide outputs), stage the chunk's weights [Wb; W]
//      once, ordered so that warp (mw, nw)'s n-tiles of 8 columns are the
//      groups of its 8 features, and walk row tiles of R = 32-128 rows, the
//      next tile's dout, x and row statistics copied with cp.async while
//      this one computes (one buffer a tile where two would keep a second
//      block off the SM: wide outputs).
//      Per tile dbasis = dout @ W^T; each thread, holding every group of its
//      (row, feature) pairs in its accumulators (in batches of 9 groups),
//      rebuilds xhat, xs and the RBF basis and sums the derivative into
//      dxs in registers. Out go the LayerNorm VJP's row sums over the
//      chunk's features, sum dxs*lng and sum dxs*lng*xhat (mbuf), and the
//      tile's column sums sum dxs*xhat and sum dxs (the dlng/dlnb partials,
//      ln_sub). No (N, D) intermediate is kept, so D is free;
//   3. fastkan_tile_sums_kernel adds the pieces of each row tile of the JAX
//      backward (`_tile_for(n, 512)` rows: 512, or 256 under 256 rows) into
//      the tile's f32 partial (kan::walk_tiles walks dlng/dlnb last), and
//      fastkan_row_sums_kernel adds the chunks' row sums;
//   4. fastkan_dx_kernel<2>, the output: the same products (with the SiLU
//      group) and epilogue, and with m1 = mean(dxhat), m2 = mean(dxhat *
//      xhat) of each row
//        dx = rstd (dxhat - m1 - xhat m2) + (dout @ Wb^T) silu'(x)
//      written in x's dtype; where the outputs come in several parts, each
//      part's share (linear in its dbasis) goes to an f32 scratch and
//   5. fastkan_dx_sum_kernel adds the parts in order;
//   6. dW partials, one per JAX row tile, rounded to the weights' dtype
//      (exact: the walk rounds each partial first). bf16:
//      fastkan_dw_mma_kernel, a block per (feature chunk, tile) builds the
//      chunk's [SiLU(x) | B | 1] columns for 64 rows at a time, each f32
//      value split into three
//      bf16 terms hi + mid + lo (the JAX kernel multiplies the f32 basis and
//      SiLU(x) with the bf16 dout, exact products summed in f32; three
//      terms carry the f32 value whole, where a hi + lo pair, about 2^-17,
//      failed the walk bar at (256, 256) on the H100), and runs the three
//      products against the staged dout on the tensor cores,
//      the accumulators over all of the block's outputs held across the
//      tile's rows (the basis is built once per block for every output,
//      unless very wide outputs at many centers split them into passes);
//      the column of ones gives dbb. f32: fastkan_dw_partial_kernel on the
//      CUDA cores, one block per (feature chunk, row tile, 64 outputs);
//   7. kan::walk_tiles adds the partials in tile order, rounding the
//      running sum to the weights' dtype after each tile, as the JAX
//      kernel's `dw_ref += partial.astype(dw.dtype)` over its sequential
//      grid, in windows of tiles (at most 128 MiB of scratch) that carry
//      the running sum. No atomics: the result is deterministic.
// Nothing syncs with the host. A row of zeros (pad rows after
// MaskedBatchNorm) has variance 0 and rstd = 1/sqrt(1e-5): finite, as in
// the JAX kernel. Shapes: any number of centers 2-32 (one library each,
// FKAN_G), any D, O up to the staged tiles' shared memory (thousands).

#include "fastkan_fwd.cuh"

namespace {

using namespace fkan;
using kan::bf16;
using kan::cp_async_commit;
using kan::cp_async_wait;
using kan::kSmemLimit;
using kan::round_up;
using kan::set_smem;
using kan::stage_rows;

constexpr int kDwRows = 32;  // rows per step of the f32 dW partial kernel
constexpr int kSub = 64;     // rows per step of the bf16 dW kernel
constexpr int kTasks = 2;    // 16 x 64 output blocks a warp of the bf16 dW kernel holds
constexpr int kTerms = 3;    // bf16 terms of each f32 basis value in the bf16 dW kernel

// The forward in f32, on the CUDA cores (fastkan_fwd.cuh).
template <int G, bool HOLD>
__global__ void __launch_bounds__(kThreads)
fastkan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ lng,
                   const float* __restrict__ lnb, const float* __restrict__ w,
                   const float* __restrict__ wb, const float* __restrict__ bb,
                   float* __restrict__ out, int n, int D, int O, Centers cs, float inv_h) {
  layer_fwd_f32_body<float, G, HOLD>(x, lng, lnb, w, wb, bb, out, n, D, O, cs, inv_h);
}

// The forward under bf16, on the tensor cores: fastkan_fwd.cuh's body on x
// (the layer: statistics, [SiLU(x) | B(LN(x))] split into kFwdTerms<G> bf16
// terms, the bias). grid (persistent row blocks, output parts of plan.op).
template <int G, int NPW>
__global__ void __launch_bounds__(kThreads, NPW == 1 ? 3 : 2)
fastkan_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lng,
                       const bf16* __restrict__ lnb, const bf16* __restrict__ w,
                       const bf16* __restrict__ wb, const bf16* __restrict__ bb,
                       bf16* __restrict__ out, int n, int D, int O, Centers cs, float inv_h,
                       kan::FwdPlan plan) {
  fwd_mma_body<bf16, bf16, G, true, NPW>(x, lng, lnb, w, wb, bb, out, n, D, O, cs, inv_h, plan);
}

// stats (n, 2) = each row's mean and 1/sqrt(var + eps), in row_stats'
// summation order. A warp takes kStatRows rows at once: up to 32 * kKeep
// features their values are loaded together and kept in registers for the
// second pass (the loads of several rows in flight); wider rows go through
// row_stats one at a time.
constexpr int kStatRows = 4, kKeep = 4;
template <typename T>
__global__ void __launch_bounds__(kThreads)
fastkan_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int n, int D) {
  const int row0 = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kStatRows;
  const int lane = threadIdx.x % 32;
  if (row0 >= n) return;
  float mu[kStatRows], rstd[kStatRows];
  if (D <= 32 * kKeep) {
    float v[kStatRows][kKeep];
#pragma unroll
    for (int i = 0; i < kStatRows; ++i)
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        const int c = lane + 32 * k;
        v[i][k] = row0 + i < n && c < D ? to_f(x[(size_t)(row0 + i) * D + c]) : 0.f;
      }
    float s[kStatRows], q[kStatRows];
#pragma unroll
    for (int i = 0; i < kStatRows; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kKeep; ++k) s[i] += v[i][k];  // zeros past D add nothing
    }
#pragma unroll
    for (int i = 0; i < kStatRows; ++i) mu[i] = warp_sum(s[i]) / (float)D;
#pragma unroll
    for (int i = 0; i < kStatRows; ++i) {
      q[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        if (lane + 32 * k >= D) continue;
        const float xc = v[i][k] - mu[i];
        q[i] += xc * xc;
      }
    }
#pragma unroll
    for (int i = 0; i < kStatRows; ++i) rstd[i] = 1.f / sqrtf(warp_sum(q[i]) / (float)D + kLnEps);
  } else {
#pragma unroll
    for (int i = 0; i < kStatRows; ++i) {
      const T* xr = x + (size_t)min(row0 + i, n - 1) * D;
      row_stats([&](int c) { return to_f(xr[c]); }, D, mu[i], rstd[i]);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kStatRows; ++i)
      if (row0 + i < n) {
        stats[2 * (size_t)(row0 + i)] = mu[i];
        stats[2 * (size_t)(row0 + i) + 1] = rstd[i];
      }
}

// The row statistics (mu, rstd: two floats a row) of rows r0..r0+rows-1
// into dst, zeros past row n; 16-byte cp.async where two whole rows are
// in range (r0 even, src 16-byte aligned).
__device__ __forceinline__ void stage_stats(float* dst, const float* __restrict__ src, int r0,
                                            int rows, int n) {
  for (int c = threadIdx.x; c < rows / 2; c += kThreads) {
    const int row = r0 + 2 * c;
    if (row + 1 < n) {
      kan::cp_async16(dst + 4 * c, src + 2 * (size_t)row);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[4 * c + q] = row + q / 2 < n ? src[2 * (size_t)row + q] : 0.f;
    }
  }
}

// The dx kernel's tiling at G centers: DC features a chunk (Shape<G>), NW
// warps along them (8 features each) and MW along the rows (16 each), so a
// tile has R rows; the epilogue takes the groups GB at a time.
template <int G> struct DxTile {
  static constexpr int NG = G + 1;
  static constexpr int DC = Shape<G>::DC;
  static constexpr int NW = DC / 8;
  static constexpr int MW = 8 / NW;
  static constexpr int R = 16 * MW;
  static constexpr int GB = NG < 9 ? NG : 9;
  static constexpr int RED = (NW * R + MW * DC) * 2;  // reduction floats: row and column sums
};

// Shared memory of fastkan_dx_kernel with OW-wide output parts: the chunk's weights
// (NG*DC x (OW + PAD)), two dout tiles (R x (OW + PAD)), two x tiles (R x
// (DC + PAD)), PAD = 16 bytes of T a row, two tiles of the rows' statistics
// and of their sums m1, m2 (R x 2 f32 each), and f32 scratch of the
// reductions.
// With nb = 1 the tiles have one buffer each, staged after the tile before
// is done.
template <typename T, int G>
size_t dx_smem(int OW, int nb) {
  using X = DxTile<G>;
  constexpr int PAD = 16 / sizeof(T);
  const size_t pitch = OW + PAD;
  return sizeof(T) * (X::NG * X::DC * pitch + nb * X::R * pitch + nb * X::R * (X::DC + PAD)) +
         sizeof(float) * (4 * nb * X::R + X::RED);
}

// The widest output part (a multiple of 16) whose fastkan_dx_kernel fits in a block
// (0 if none does), and its buffers a tile: 2, unless 1 lets two blocks
// share an SM where 2 does not (wide outputs).
template <typename T, int G>
int dx_part_width(int O, int& nb) {
  int OW = round_up(O, 16);
  while (OW > 16 && dx_smem<T, G>(OW, 1) > kSmemLimit) OW -= 16;
  if (dx_smem<T, G>(OW, 1) > kSmemLimit) return 0;
  const size_t half = kSmemLimit / 2 - 1024;  // two blocks an SM, with the runtime's share
  nb = dx_smem<T, G>(OW, 2) <= kSmemLimit &&
               (dx_smem<T, G>(OW, 2) <= half || dx_smem<T, G>(OW, 1) > half)
           ? 2
           : 1;
  return OW;
}

// fastkan_dx_kernel: grid (persistent row blocks, D chunks, output parts). PASS 1
// writes the row sums (mbuf, one (n, 2) slab per (part, chunk)) and the
// tiles' dlng/dlnb pieces (ln_sub, one 2D row per (piece, part)); PASS 2
// writes dx (one part) or the part's share into vbuf (several), reading
// m1, m2 of each row from mrow (fastkan_row_sums_kernel). Two blocks an SM. See the
// file's header.
template <typename T, int G, int PASS>
__global__ void __launch_bounds__(kThreads, 2)
fastkan_dx_kernel(const T* __restrict__ x, const T* __restrict__ lng, const T* __restrict__ lnb,
                  const T* __restrict__ w, const T* __restrict__ wb, const T* __restrict__ dout,
                  const float* __restrict__ stats, const float* __restrict__ mrow,
                  float* __restrict__ mbuf, float* __restrict__ ln_sub, T* __restrict__ dx,
                  float* __restrict__ vbuf, int n, int D, int O, Centers cs, float inv_h, int OW,
                  int nb) {
  using X = DxTile<G>;
  constexpr int NG = X::NG, DC = X::DC, NW = X::NW, R = X::R, GB = X::GB;
  constexpr int PAD = 16 / sizeof(T);
  constexpr int XP = DC + PAD;
  constexpr bool kMma = std::is_same_v<T, bf16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = gridDim.y, parts = gridDim.z;
  const int part = blockIdx.z, o0 = part * OW;
  const int kw = min(OW, O - o0);      // outputs of this part
  const int k16 = round_up(kw, 16);
  const int pitch = OW + PAD;
  T* W_s = reinterpret_cast<T*>(smem_raw);     // NG*DC x pitch
  T* d_s = W_s + (size_t)NG * DC * pitch;      // nb x R x pitch
  T* x_s = d_s + (size_t)nb * R * pitch;       // nb x R x XP
  float* st_s = reinterpret_cast<float*>(x_s + (size_t)nb * R * XP);  // nb x R x 2: mu, rstd
  float* m_s = st_s + 2 * nb * R;              // nb x R x 2: m1, m2
  float* red = m_s + 2 * nb * R;
  const int d0 = blockIdx.y * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / NW, nw = warp % NW;
  const int gid = lane / 4, tig = lane % 4;
  const int stride = gridDim.x * R;
  const bool wide_d = O % PAD == 0, wide_x = D % PAD == 0;
  // the tile at rows r0.. into buffer b
  auto stage = [&](int r0, int b) {
    stage_rows(d_s + (size_t)b * R * pitch, pitch, R, kw, k16, wide_d, [&](int r) -> const T* {
      return r0 + r < n ? dout + (size_t)(r0 + r) * O + o0 : nullptr;
    });
    stage_rows(x_s + (size_t)b * R * XP, XP, R, min(DC, D - d0), DC, wide_x,
               [&](int r) -> const T* {
                 return r0 + r < n ? x + (size_t)(r0 + r) * D + d0 : nullptr;
               });
    stage_stats(st_s + (size_t)b * 2 * R, stats, r0, R, n);
    if constexpr (PASS == 2) stage_stats(m_s + (size_t)b * 2 * R, mrow, r0, R, n);
  };
  // the chunk's weights, once: row q*NG*8 + g*8 + l is group g of feature
  // d0 + q*8 + l
  stage_rows(W_s, pitch, NG * DC, kw, k16, wide_d, [&](int r) -> const T* {
    const int q = r / (NG * 8), g = (r % (NG * 8)) / 8, l = r % 8;
    const int d = d0 + q * 8 + l;
    return d < D ? fkan::weight_row(wb, w, g, d, D, O) + o0 : nullptr;
  });
  stage(blockIdx.x * R, 0);
  cp_async_commit();
  // this thread's two features
  float gam[2], bet[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int d = d0 + nw * 8 + tig * 2 + p;
    gam[p] = d < D ? to_f(lng[d]) : 0.f;
    bet[p] = d < D ? to_f(lnb[d]) : 0.f;
  }
  const float k2 = -2.f * inv_h;
  int buf = 0;
  for (int r0 = blockIdx.x * R; r0 < n; r0 += stride, buf ^= nb - 1) {
    __syncthreads();  // the tile before this one is done with the buffers reused next
    if (nb == 2) {  // the next tile flies while this one computes
      if (r0 + stride < n) stage(r0 + stride, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (r0 != blockIdx.x * R) stage(r0, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and W_s) landed for every thread
    const T* dt = d_s + (size_t)buf * R * pitch;
    const T* xt = x_s + (size_t)buf * R * XP;
    const float* sts = st_s + (size_t)buf * 2 * R;  // the tile's mu, rstd
    const float* mts = m_s + (size_t)buf * 2 * R;   // and m1, m2
    // pair q = 2*h + p: row mw*16 + gid + 8*h, feature d0 + nw*8 + tig*2 + p
    float xv[4], xh[4], xs[4], rs[4];
    bool ok[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = mw * 16 + gid + 8 * h, row = r0 + rt;
      const float mu = sts[2 * rt], rstd = sts[2 * rt + 1];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = 2 * h + p, j = nw * 8 + tig * 2 + p;
        ok[q] = row < n && d0 + j < D;
        xv[q] = to_f(xt[rt * XP + j]);
        xh[q] = (xv[q] - mu) * rstd;
        xs[q] = xh[q] * gam[p] + bet[p];
        rs[q] = rstd;
      }
    }
    float dxs[4] = {0.f, 0.f, 0.f, 0.f}, st[4] = {0.f, 0.f, 0.f, 0.f};
    // the groups GB at a time (the SiLU group 0 only for the output)
#pragma unroll
    for (int g0 = PASS == 1 ? 1 : 0; g0 < NG; g0 += GB) {
      float acc[GB][4];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
      if constexpr (kMma) {
#pragma unroll 2
        for (int k0 = 0; k0 < k16; k0 += 16) {
          unsigned a[4];
          kan::ldmatrix_x4<false>(
              a, dt + (size_t)(mw * 16 + (lane / 8 % 2) * 8 + lane % 8) * pitch + k0 +
                     (lane / 16) * 8);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g0 + g >= NG) continue;
            unsigned b[2];
            kan::ldmatrix_x2(b, W_s + (size_t)(nw * NG * 8 + (g0 + g) * 8 + lane % 8) * pitch +
                                    k0 + (lane / 8 % 2) * 8);
            kan::mma_bf16(acc[g], a, b[0], b[1]);
          }
        }
      } else {
        // on the CUDA cores; each 16 outputs' products go to a fresh sum,
        // added to the running one (a sequential f32 chain over hundreds of
        // outputs, cancelling across many centers, read past the f32 bar)
        const T* d0r = dt + (size_t)(mw * 16 + gid) * pitch;
        for (int k0 = 0; k0 < kw; k0 += 16) {
          float step[GB][4];
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int q = 0; q < 4; ++q) step[g][q] = 0.f;
          for (int k = k0; k < min(kw, k0 + 16); ++k) {
            const float dv0 = d0r[k], dv1 = d0r[8 * pitch + k];
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              if (g0 + g >= NG) continue;
              const T* wr = W_s + (size_t)(nw * NG * 8 + (g0 + g) * 8 + tig * 2) * pitch + k;
              const float w0 = wr[0], w1 = wr[pitch];
              step[g][0] += dv0 * w0;
              step[g][1] += dv0 * w1;
              step[g][2] += dv1 * w0;
              step[g][3] += dv1 * w1;
            }
          }
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[g][q] += step[g][q];
        }
      }
      // acc[g][q]: dbasis of pair q, group g0 + g (0: the SiLU term's ds)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const int gg = g0 + g;
        if (gg >= NG) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (gg == 0) {
            st[q] += acc[g][q] * kan::dsilu(xv[q], sigmoid(xv[q]));
          } else {
            const float dist = (xs[q] - cs.c[gg - 1]) * inv_h;
            const float b = expf(-(dist * dist));
            dxs[q] += ((acc[g][q] * b) * k2) * dist;
          }
        }
      }
    }
    if constexpr (PASS == 1) {
      // per row (h): sum over this thread's features of dxhat, dxhat * xhat;
      // per feature (p): sum over its rows of dxs * xhat, dxs
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f}, l2[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int q = 2 * h + p;
          if (!ok[q]) continue;
          const float dxh = dxs[q] * gam[p];
          s1[h] += dxh;
          s2[h] += dxh * xh[q];
          l1[p] += dxs[q] * xh[q];
          l2[p] += dxs[q];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
        for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes of a feature
          l1[i] += __shfl_xor_sync(0xffffffffu, l1[i], off);
          l2[i] += __shfl_xor_sync(0xffffffffu, l2[i], off);
        }
      }
      float* red_m = red;                       // NW x R x 2
      float* red_l = red + (size_t)NW * R * 2;  // MW x DC x 2
      if (tig == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rt = mw * 16 + gid + 8 * h;
          red_m[(nw * R + rt) * 2] = s1[h];
          red_m[(nw * R + rt) * 2 + 1] = s2[h];
        }
      if (gid == 0)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int j = nw * 8 + tig * 2 + p;
          red_l[(mw * DC + j) * 2] = l1[p];
          red_l[(mw * DC + j) * 2 + 1] = l2[p];
        }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * R; i += kThreads) {
        const int row = r0 + i / 2;
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < NW; ++v) s += red_m[(v * R + i / 2) * 2 + i % 2];
        if (row < n) mbuf[(((size_t)part * chunks + blockIdx.y) * n + row) * 2 + i % 2] = s;
      }
      float* sub = ln_sub + ((size_t)(r0 / R) * parts + part) * 2 * D;
      for (int i = threadIdx.x; i < 2 * DC; i += kThreads) {
        const int d = d0 + i / 2;
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < X::MW; ++v) s += red_l[(v * DC + i / 2) * 2 + i % 2];
        if (d < D) sub[(i % 2) * D + d] = s;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = mw * 16 + gid + 8 * h, row = r0 + rt;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int q = 2 * h + p, d = d0 + nw * 8 + tig * 2 + p;
          if (!ok[q]) continue;
          float v = rs[q] * (dxs[q] * gam[p]) + st[q];
          if (part == 0) v -= rs[q] * (mts[2 * rt] + xh[q] * mts[2 * rt + 1]);
          if (vbuf != nullptr)
            vbuf[((size_t)part * n + row) * D + d] = v;
          else
            dx[(size_t)row * D + d] = from_f<T>(v);
        }
      }
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
}

// out[t*m + i] = sum over j < group, in order, of sub[(t*group + j)*m + i]
// (pieces past `parts` left out): the R-row pieces (and output parts) of
// dlng/dlnb added into the JAX tile's f32 partial.
__global__ void fastkan_tile_sums_kernel(const float* __restrict__ sub, float* __restrict__ out,
                                 int parts, int group, int tiles, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tiles * m) return;
  const int t = i / m, c = i % m;
  float s = 0.f;
  for (int j = t * group; j < min(parts, (t + 1) * group); ++j) s += sub[(size_t)j * m + c];
  out[i] = s;
}

// mrow (n, 2) = m1, m2 of each row: the sums over the (part, chunk) slabs of
// mbuf, in order, over D
__global__ void fastkan_row_sums_kernel(const float* __restrict__ mbuf,
                                        float* __restrict__ mrow, int n,
                                int D, int slabs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  float s = 0.f;
  for (int q = 0; q < slabs; ++q) s += mbuf[(size_t)q * 2 * n + i];
  mrow[i] = s / (float)D;
}

// dx[i] = the sum over the output parts, in order, of their shares
template <typename T>
__global__ void fastkan_dx_sum_kernel(const float* __restrict__ vbuf, T* __restrict__ dx, size_t m,
                                      int parts) {
  kan::sum_parts<T>(vbuf, dx, m, parts);
}

// dW partials under bf16. grid (chunks of dcw features, row tiles t0.. of
// one window, output passes of opw x M-splits). Shared memory: the hi, mid
// and lo bf16 terms of A (3 x kSub x (M + 8)), column g*dcw + j = group g
// of feature d0 + j (0: SiLU(x), g >= 1: B_{g-1}), column NG*dcw = 1 in
// the blocks of the first chunk (dbb), zeros up to M = NG*dcw + 1 rounded
// to 16; and two buffers of each step's dout (kSub x (opw + 8)), x chunk
// (kSub x (dcw + 8)) and row statistics, the next step's copied with
// cp.async while this one builds A from shared memory and multiplies (a
// block owns one tile: the blocks of a tile's chunks run together and share
// its dout in L2; blocks that walk several tiles measured slower on the
// H100). The block's 16 x 64 output blocks (its M-split's m-tiles x opw / 64) are the
// warps' tasks, kTasks a warp at most: per 16-row step a warp loads each
// task's three A fragments once and multiplies them with four dout
// fragments; each step's products go to a fresh accumulator, added to the
// tile's in f32 (the tensor cores' own accumulation, chained over the 512
// rows, failed the walk bar at (256, 256) on the H100). The blocks are
// written rounded to bf16.
template <int G>
__global__ void __launch_bounds__(kThreads, 2)
fastkan_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lng,
                      const bf16* __restrict__ lnb, const float* __restrict__ stats,
                      const bf16* __restrict__ dout, bf16* __restrict__ partial, int n,
                      int D, int O, Centers cs, float inv_h, int tile, int t0, int dcw,
                      int opw, int msplit) {
  constexpr int NG = G + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ac = NG * dcw;                // basis columns
  const int M = round_up(ac + 1, 16);     // and the ones column, padded
  const int MT = M / 16, NP = opw / 16, NQ = (NP + 3) / 4;
  const int mtb = (MT + msplit - 1) / msplit;           // m-tiles a split
  const int mt0 = (blockIdx.z % msplit) * mtb, mt1 = min(MT, mt0 + mtb);
  const int tasks = (mt1 - mt0) * NQ;
  const int pa = M + 8, po = opw + 8, xp = dcw + 8;
  bf16* A3 = reinterpret_cast<bf16*>(smem_raw);     // the terms: kTerms x kSub x pa
  bf16* d_s = A3 + (size_t)kTerms * kSub * pa;      // 2 x kSub x po
  bf16* x_s = d_s + (size_t)2 * kSub * po;          // 2 x kSub x xp
  float* st_s = reinterpret_cast<float*>(x_s + (size_t)2 * kSub * xp);  // 2 x 2 kSub
  const int d0 = blockIdx.x * dcw;
  const int op0 = (blockIdx.z / msplit) * opw, ow = min(opw, O - op0);
  const bool ones = blockIdx.x == 0;  // the first chunk's blocks sum dout into dbb
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int rbeg = (t0 + blockIdx.y) * tile, rend = min(n, rbeg + tile);
  // the step at rows r0.. into buffer b
  auto stage = [&](int r0, int b) {
    stage_rows(d_s + (size_t)b * kSub * po, po, kSub, ow, opw, O % 8 == 0,
               [&](int r) -> const bf16* {
                 return r0 + r < rend ? dout + (size_t)(r0 + r) * O + op0 : nullptr;
               });
    stage_rows(x_s + (size_t)b * kSub * xp, xp, kSub, min(dcw, D - d0), dcw, D % 8 == 0,
               [&](int r) -> const bf16* {
                 return r0 + r < rend ? x + (size_t)(r0 + r) * D + d0 : nullptr;
               });
    stage_stats(st_s + (size_t)b * 2 * kSub, stats, r0, kSub, rend);
  };
  stage(rbeg, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < kTerms * kSub * (M - ac); i += kThreads) {
    const int r = i / (M - ac), c = ac + i % (M - ac);
    A3[(size_t)r * pa + c] = zero;
  }
  // this thread's two features (j, j + 1) and rows of A
  const int hw = dcw / 2, j = 2 * (threadIdx.x % hw), d = d0 + j;
  float gam[2], bet[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    gam[p] = d + p < D ? to_f(lng[d + p]) : 0.f;
    bet[p] = d + p < D ? to_f(lnb[d + p]) : 0.f;
  }
  // acc[t][np][nt][q]: task warp + 8*t, its n-pair np, n-tile nt
  float acc[kTasks][4][2][4];
#pragma unroll
  for (int t = 0; t < kTasks; ++t)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][np][nt][q] = 0.f;

  int buf = 0;
  for (int r0 = rbeg; r0 < rend; r0 += kSub, buf ^= 1) {
    __syncthreads();  // the previous step is done with A and the buffers staged next
    if (r0 + kSub < rend) stage(r0 + kSub, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this step's dout, x and statistics landed for every thread
    const bf16* xt = x_s + (size_t)buf * kSub * xp;
    const float* st = st_s + (size_t)buf * 2 * kSub;
    for (int r = threadIdx.x / hw; r < kSub; r += kThreads / hw) {
      bf16* a = A3 + (size_t)r * pa + j;
      // the values of features j, j + 1 (zeros past D or rend) as their
      // kTerms bf16 terms (exactly, with 3), stored in pairs
      auto put = [&](int g, float v0, float v1) {
        kan::split_terms<kTerms>(a + g * dcw, (size_t)kSub * pa, v0, v1);
      };
      const bool row_ok = r0 + r < rend;
      const bool ok0 = row_ok && d < D, ok1 = row_ok && d + 1 < D;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xt + r * xp + j));
      const float mu = st[2 * r], rs = st[2 * r + 1];
      const float xs0 = ((xv.x - mu) * rs) * gam[0] + bet[0];
      const float xs1 = ((xv.y - mu) * rs) * gam[1] + bet[1];
      put(0, ok0 ? xv.x * sigmoid(xv.x) : 0.f, ok1 ? xv.y * sigmoid(xv.y) : 0.f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float e0 = (xs0 - cs.c[g]) * inv_h, e1 = (xs1 - cs.c[g]) * inv_h;
        put(g + 1, ok0 ? expf(-(e0 * e0)) : 0.f, ok1 ? expf(-(e1 * e1)) : 0.f);
      }
    }
    for (int r = threadIdx.x; r < kSub; r += kThreads)
      A3[(size_t)r * pa + ac] = __float2bfloat16_rn(ones && r0 + r < rend ? 1.f : 0.f);
    __syncthreads();  // A is complete
    const bf16* dt = d_s + (size_t)buf * kSub * po;
#pragma unroll
    for (int k0 = 0; k0 < kSub; k0 += 16) {
#pragma unroll
      for (int t = 0; t < kTasks; ++t) {
        const int task = warp + 8 * t;
        if (task >= tasks) continue;
        const int mt = mt0 + task / NQ, nq = task % NQ;
        unsigned a[kTerms][4];
#pragma unroll
        for (int q = 0; q < kTerms; ++q)  // hi, (mid,) lo
          kan::ldmatrix_x4<true>(a[q], A3 + (size_t)q * kSub * pa +
                                           (size_t)(k0 + (lane / 16) * 8 + lane % 8) * pa +
                                           mt * 16 + (lane / 8 % 2) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (nq * 4 + np >= NP) continue;
          unsigned b[4];
          kan::ldmatrix_x4<true>(b, dt + (size_t)(k0 + (lane / 8 % 2) * 8 + lane % 8) * po +
                                        (nq * 4 + np) * 16 + (lane / 16) * 8);
          float step[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int q = 0; q < kTerms; ++q) {
            kan::mma_bf16(step[0], a[q], b[0], b[1]);
            kan::mma_bf16(step[1], a[q], b[2], b[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[t][np][nt][q] += step[nt][q];
        }
      }
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
  const size_t m_w = (size_t)NG * D * O + O;
  bf16* part = partial + blockIdx.y * m_w;
  const bool pairs = O % 2 == 0;
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    const int task = warp + 8 * t;
    if (task >= tasks) continue;
    const int mt = mt0 + task / NQ, nq = task % NQ;
    // acc[t][np][nt][2*h + p]: A column mt*16 + gid + 8*h, output
    // op0 + (nq*4 + np)*16 + nt*8 + tig*2 + p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = mt * 16 + gid + 8 * h;
      bf16* prow;
      if (c < ac) {
        const int dc = d0 + c % dcw;
        if (dc >= D) continue;
        prow = part + ((size_t)(c / dcw) * D + dc) * O;
      } else if (c == ac && ones) {
        prow = part + (size_t)NG * D * O;
      } else {
        continue;
      }
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int o = op0 + (nq * 4 + np) * 16 + nt * 8 + tig * 2;
          if (pairs && o + 1 < O) {
            *reinterpret_cast<__nv_bfloat162*>(prow + o) =
                __floats2bfloat162_rn(acc[t][np][nt][2 * h], acc[t][np][nt][2 * h + 1]);
          } else {
            if (o < O) prow[o] = from_f<bf16>(acc[t][np][nt][2 * h]);
            if (o + 1 < O) prow[o + 1] = from_f<bf16>(acc[t][np][nt][2 * h + 1]);
          }
        }
    }
  }
}

// The bf16 dW kernel's plan: the feature chunk dcw, the output pass opw (a
// multiple of 64, or every output) and the M-splits msplit of each block,
// so that a block has at most 8 * kTasks tasks and fits in shared memory,
// least passes + 32 / dcw: each pass rebuilds the basis, each narrower
// chunk restages dout. false if none fits.
template <int G>
bool plan_dw(int O, int& dcw, int& opw, int& msplit, size_t& smem) {
  constexpr int NG = G + 1;
  const int O16 = round_up(O, 16);
  float best = 1e30f;
  for (int c = 32; c >= 8; c /= 2) {
    const int MT = round_up(NG * c + 1, 16) / 16;
    const int ms = (MT + 8 * kTasks - 1) / (8 * kTasks);  // M-splits
    const int per = (MT + ms - 1) / ms;                    // m-tiles a split
    int ow = std::min(O16, std::max(1, 8 * kTasks / per) * 64);
    const size_t need = sizeof(bf16) * ((size_t)kTerms * kSub * (MT * 16 + 8) +
                                        (size_t)2 * kSub * (ow + 8) + (size_t)2 * kSub * (c + 8)) +
                        sizeof(float) * 4 * kSub;
    if (need > kSmemLimit) continue;
    const float cost = (float)((O + ow - 1) / ow * ms) + 32.f / c;
    if (cost < best) {
      best = cost;
      dcw = c, opw = ow, msplit = ms, smem = need;
    }
  }
  return best < 1e30f;
}

// f32: grid (D chunks, row tiles t0.. of one window, O tiles): the partial
// of rows [t*tile, (t+1)*tile). Thread t owns 4 output columns (t % 16) x
// KPT basis columns (t / 16) of the chunk's (AC, kOT) block. The blocks of
// the first D chunk also sum dout into dbb.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fastkan_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ lng,
                          const T* __restrict__ lnb, const float* __restrict__ stats,
                          const T* __restrict__ dout, T* __restrict__ partial, int n, int D, int O,
                          Centers cs, float inv_h, int tile, int t0) {
  using S = Shape<G>;
  constexpr int KPT = (S::AC + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                       // kDwRows x AC
  float* dout_s = smem + kDwRows * S::AC;  // kDwRows x kOT
  const int d0 = blockIdx.x * S::DC;
  const int o0 = blockIdx.z * kOT;
  const int og = threadIdx.x % 16, kg = threadIdx.x / 16;
  const bool sums_bias = blockIdx.x == 0 && kg == 0;
  const int rbeg = (t0 + blockIdx.y) * tile;
  const int rend = min(n, rbeg + tile);
  float acc[KPT][4];
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  auto load_x = [&](int, int row, int d) { return to_f(x[(size_t)row * D + d]); };
  auto row_stats = [&](int, int row, float& mu, float& rstd) {
    mu = stats[2 * (size_t)row];
    rstd = stats[2 * (size_t)row + 1];
  };

  for (int r0 = rbeg; r0 < rend; r0 += kDwRows) {
    __syncthreads();
    build_chunk<T, G>(load_x, row_stats, A_s, kDwRows, r0, rend, d0, D, lng, lnb, cs, inv_h);
    for (int i = threadIdx.x; i < kDwRows * kOT; i += kThreads) {
      const int row = r0 + i / kOT, o = o0 + i % kOT;
      dout_s[i] = (row < rend && o < O) ? to_f(dout[(size_t)row * O + o]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kDwRows; ++r) {
      const float4 dv = *reinterpret_cast<const float4*>(dout_s + r * kOT + og * 4);
      const float* a = A_s + r * S::AC + kg * KPT;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // columns past AC only where AC is not a multiple of 16
        const float av = S::AC % 16 == 0 || kg * KPT + j < S::AC ? a[j] : 0.f;
        acc[j][0] += av * dv.x;
        acc[j][1] += av * dv.y;
        acc[j][2] += av * dv.z;
        acc[j][3] += av * dv.w;
      }
      if (sums_bias) {
        bacc[0] += dv.x;
        bacc[1] += dv.y;
        bacc[2] += dv.z;
        bacc[3] += dv.w;
      }
    }
  }
  const size_t m = (size_t)S::NG * D * O + O;
  T* part = partial + blockIdx.y * m;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int c = kg * KPT + j;
    const int d = d0 + c % S::DC;
    if (c >= S::AC || d >= D) continue;
    const size_t gc = (size_t)(c / S::DC) * D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) part[gc * O + o] = from_f<T>(acc[j][q]);
    }
  }
  if (sums_bias) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) part[(size_t)S::NG * D * O + o] = from_f<T>(bacc[q]);
    }
  }
}

// The forward's launch: bf16 on the tensor cores (fastkan_fwd_mma_kernel,
// persistent blocks, the widest output part that fits), f32 on the CUDA
// cores (fastkan_fwd_kernel: TF32 would miss the f32 bars).
template <typename T, int G>
int launch_fwd(const void* x, const void* lng, const void* lnb, const void* w, const void* wb,
               const void* bb, void* out, int n, int D, int O, Centers cs, float inv_h,
               cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    return with_fwd_mma_part<bf16, G, true>(n, O, [&](auto npw, int op) {
      auto kernel = fastkan_fwd_mma_kernel<G, decltype(npw)::value>;
      dim3 grid;
      const kan::FwdPlan* plan = fwd_mma_plan<bf16, G, true>(kernel, n, D, O, op, grid);
      if (plan == nullptr) return (int)cudaErrorInvalidValue;
      kernel<<<grid, kThreads, plan->smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(lng),
          static_cast<const bf16*>(lnb), static_cast<const bf16*>(w),
          static_cast<const bf16*>(wb), static_cast<const bf16*>(bb), static_cast<bf16*>(out), n,
          D, O, cs, inv_h, *plan);
      return (int)cudaGetLastError();
    });
  } else {
    return launch_layer_fwd_f32<G>(
        [](auto hold) { return fastkan_fwd_kernel<G, decltype(hold)::value>; },
        static_cast<const float*>(x), static_cast<const float*>(lng),
        static_cast<const float*>(lnb), static_cast<const float*>(w),
        static_cast<const float*>(wb), static_cast<const float*>(bb), static_cast<float*>(out),
        n, D, O, cs, inv_h, stream);
  }
}

// The dx kernels' plan: out = {R, chunks, parts, OW}; false if no output
// part fits in a block.
template <typename T, int G>
int plan_dx(int n, int D, int O, int* out) {
  using X = DxTile<G>;
  int nb = 2;
  const int OW = dx_part_width<T, G>(O, nb);
  if (OW == 0) return (int)cudaErrorInvalidValue;
  out[0] = X::R;
  out[1] = (D + X::DC - 1) / X::DC;
  out[2] = (round_up(O, 16) + OW - 1) / OW;
  out[3] = OW;
  return 0;
}

template <typename T, int G>
int launch_stats(const void* x, float* stats, int n, int D, cudaStream_t stream) {
  const int per = kThreads / 32 * kStatRows;  // rows a block
  if (n > 0)
    fastkan_stats_kernel<T><<<(n + per - 1) / per, kThreads, 0, stream>>>(
        static_cast<const T*>(x), stats, n, D);
  return (int)cudaGetLastError();
}

// launches 2-5 of the header (dx skipped when null): the sums, dlng/dlnb
// into grads_ln = [dlng (D) | dlnb (D)], then dx.
template <typename T, int G>
int launch_dx(const void* x, const void* lng, const void* lnb, const void* w, const void* wb,
              const void* dout, const float* stats, float* mbuf, float* ln_partial,
              float* vbuf, void* dx, void* grads_ln, int n, int D, int O, Centers cs,
              float inv_h, int tile, cudaStream_t stream) {
  int pl[4];
  if (int e = plan_dx<T, G>(n, D, O, pl)) return e;
  const int R = pl[0], chunks = pl[1], parts = pl[2], OW = pl[3];
  const int tiles = (n + tile - 1) / tile;
  const int pieces = (n + R - 1) / R;
  float* ln_tiles = ln_partial + (size_t)pieces * parts * 2 * D;
  // m1, m2 after the slabs, 16-byte aligned for the tiles' cp.async
  float* mrow = mbuf + (((size_t)parts * chunks * 2 * n + 3) & ~(size_t)3);
  const T* xt = static_cast<const T*>(x);
  if (n > 0) {
    int nb = 2;
    dx_part_width<T, G>(O, nb);
    const size_t smem = dx_smem<T, G>(OW, nb);
    for (int pass = 1; pass <= 2; ++pass) {
      if (pass == 2 && dx == nullptr) break;
      auto kernel = pass == 1 ? fastkan_dx_kernel<T, G, 1> : fastkan_dx_kernel<T, G, 2>;
      if (int e = set_smem(kernel, smem)) return e;
      int per_sm, sms;
      kan::occupancy(kernel, smem, per_sm, sms);
      const int rows = std::max(1, std::min(pieces, (per_sm * sms + chunks * parts - 1) /
                                                        (chunks * parts)));
      kernel<<<dim3(rows, chunks, parts), kThreads, smem, stream>>>(
          xt, static_cast<const T*>(lng), static_cast<const T*>(lnb), static_cast<const T*>(w),
          static_cast<const T*>(wb), static_cast<const T*>(dout), stats, mrow, mbuf, ln_partial,
          static_cast<T*>(dx), parts > 1 ? vbuf : nullptr, n, D, O, cs, inv_h, OW, nb);
      if (int e = (int)cudaGetLastError()) return e;
      if (pass == 1) {
        const int m = 2 * D;
        fastkan_tile_sums_kernel<<<(tiles * m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            ln_partial, ln_tiles, pieces * parts, tile / R * parts, tiles, m);
        if (int e = (int)cudaGetLastError()) return e;
        if (dx != nullptr) {
          fastkan_row_sums_kernel<<<(2 * n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
              mbuf, mrow, n, D, parts * chunks);
          if (int e = (int)cudaGetLastError()) return e;
        }
      }
    }
    if (dx != nullptr && parts > 1) {
      const size_t m = (size_t)n * D;
      fastkan_dx_sum_kernel<T><<<kan::sum_parts_blocks(m), kThreads, 0, stream>>>(
          vbuf, static_cast<T*>(dx), m, parts);
      if (int e = (int)cudaGetLastError()) return e;
    }
  }
  return kan::walk_tiles<float, T>(ln_tiles, static_cast<T*>(grads_ln), tiles, 2 * (size_t)D,
                                   false, stream);
}

// launches 6-7: the dW partials of `window` tiles at a time, each window
// walked into grads = [dWb | dW | dbb] (carrying the running sum).
template <typename T, int G>
int launch_dw(const void* x, const void* lng, const void* lnb, const float* stats,
              const void* dout, void* w_partial, void* grads, int n, int D, int O, Centers cs,
              float inv_h, int tile, int window, cudaStream_t stream) {
  using S = Shape<G>;
  constexpr bool kMma = std::is_same_v<T, bf16>;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dout);
  const T* lg = static_cast<const T*>(lng);
  const T* lb = static_cast<const T*>(lnb);
  T* out = static_cast<T*>(grads);
  T* wp = static_cast<T*>(w_partial);
  const size_t m_w = (size_t)S::NG * D * O + O;  // [dWb; dW] then dbb
  const int tiles = (n + tile - 1) / tile;
  size_t smem;
  dim3 grid(1, 1, 1);
  int dcw = 0, opw = 0, mspl = 1;
  if constexpr (kMma) {
    int msplit = 1;
    if (!plan_dw<G>(O, dcw, opw, msplit, smem)) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(fastkan_dw_mma_kernel<G>, smem)) return e;
    grid = dim3((D + dcw - 1) / dcw, 1, (O + opw - 1) / opw * msplit);
    mspl = msplit;
  } else {
    smem = sizeof(float) * ((size_t)kDwRows * S::AC + kDwRows * kOT);
    if (int e = set_smem(fastkan_dw_partial_kernel<T, G>, smem)) return e;
    grid = dim3((D + S::DC - 1) / S::DC, 1, (O + kOT - 1) / kOT);
  }
  for (int t0 = 0; t0 < tiles || t0 == 0; t0 += window) {
    const int wt = std::min(window, tiles - t0);
    if (wt > 0) {
      grid.y = wt;
      if constexpr (kMma) {
        fastkan_dw_mma_kernel<G><<<grid, kThreads, smem, stream>>>(
            xt, lg, lb, stats, gt, wp, n, D, O, cs, inv_h, tile, t0, dcw, opw, mspl);
      } else {
        fastkan_dw_partial_kernel<T, G><<<grid, kThreads, smem, stream>>>(
            xt, lg, lb, stats, gt, wp, n, D, O, cs, inv_h, tile, t0);
      }
      if (int e = (int)cudaGetLastError()) return e;
    }
    if (int e = kan::walk_tiles<T, T>(wp, out, std::max(wt, 0), m_w, t0 > 0, stream)) return e;
  }
  return 0;
}

Centers centers_of(const float* c, int G) {
  Centers cs{};
  for (int g = 0; g < G && g < kMaxG; ++g) cs.c[g] = c[g];
  return cs;
}

}  // namespace

// out (n, O) = FastKANLayer(x). x (n, D); lng, lnb (D,); w (G*D, O) g-major;
// wb (D, O); bb (O,); all of one dtype, device memory, contiguous.
// centers: G floats in host memory.
extern "C" int fastkan_fwd(const void* x, const void* lng, const void* lnb, const void* w,
                           const void* wb, const void* bb, void* out, int n, int d, int o,
                           int G, const float* centers, float inv_h, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  FASTKAN_DISPATCH(dtype, G, launch_fwd, x, lng, lnb, w, wb, bb, out, n, d, o, cs, inv_h, s);
}

// The backward's scratch plan: plan = {R, chunks, parts, OW}: the dx
// kernels' rows a piece, feature chunks, output parts and part width. The
// caller allocates mbuf ((parts * chunks + 1) * n * 2 + 4 f32), ln_partial
// ((ceil(n / R) * parts + ceil(n / tile)) * 2D f32) and, when dx is wanted
// and parts > 1, vbuf (parts * n * D f32).
extern "C" int fastkan_bwd_plan(int n, int d, int o, int G, int dtype, int* plan) {
  FASTKAN_DISPATCH(dtype, G, plan_dx, n, d, o, plan);
}

// stats (n, 2) f32: each row's mean and 1/sqrt(var + eps).
extern "C" int fastkan_bwd_stats(const void* x, float* stats, int n, int d, int G, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FASTKAN_DISPATCH(dtype, G, launch_stats, x, stats, n, d, s);
}

// dx (n, D) (skipped when dx is null) and grads_ln = [dlng (D) | dlnb (D)]
// in the inputs' dtype from dout (n, O) and stats; dlng/dlnb summed over
// row tiles of `tile` rows (a multiple of 128). Scratch as fastkan_bwd_plan.
extern "C" int fastkan_bwd_dx(const void* x, const void* lng, const void* lnb, const void* w,
                              const void* wb, const void* dout, const float* stats, float* mbuf,
                              float* ln_partial, float* vbuf, void* dx, void* grads_ln, int n,
                              int d, int o, int G, const float* centers, float inv_h,
                              int dtype, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  FASTKAN_DISPATCH(dtype, G, launch_dx, x, lng, lnb, w, wb, dout, stats, mbuf, ln_partial, vbuf,
                   dx, grads_ln, n, d, o, cs, inv_h, tile, s);
}

// grads = [dWb (D*O) | dW (G*D*O) | dbb (O)] in the inputs' dtype from dout
// (n, O) and stats, summed over row tiles of `tile` rows. w_partial: scratch
// of window * ((G+1)*D*O + O) in the inputs' dtype (`window` tiles at a
// time).
extern "C" int fastkan_bwd_dw(const void* x, const void* lng, const void* lnb,
                              const float* stats, const void* dout, void* w_partial, void* grads,
                              int n, int d, int o, int G, const float* centers, float inv_h,
                              int dtype, int tile, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  FASTKAN_DISPATCH(dtype, G, launch_dw, x, lng, lnb, stats, dout, w_partial, grads, n, d, o, cs,
                   inv_h, tile, window, s);
}
