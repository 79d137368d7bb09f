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
// This first version computes the products on the CUDA cores in f32, so its
// time is set by the rate the SMs execute instructions, not by bytes; the
// (N, G*D) basis never leaves the SM. Moving the products to wgmma is later
// work.
//
// The backward runs as up to five launches on the caller's stream:
//   1. dx_kernel: about two blocks per SM each walk a contiguous range of
//      32-row pieces. Per piece: LayerNorm statistics (written to a scratch
//      (N, 2) buffer for launch 3), then per 32-feature chunk
//      dout @ [Wb; W]^T with the chunk's weights staged in shared memory
//      one 64-wide tile of outputs at a time (175 KB at D = O = 256), the
//      RBF derivative into dxs and the SiLU' term, and last the LayerNorm VJP
//      per row. The piece's sums of dxs * xhat and dxs (rows in order) leave
//      as its f32 partial of dlng/dlnb;
//   2. tile_sums_kernel adds the pieces of each row tile of the JAX
//      backward (`_tile_for(n, 512)` rows: 512, or 256 under 256 rows) into
//      the tile's f32 partial;
//   3. dw_partial_kernel: one block per (feature chunk, row tile, output
//      tile) writes the tile's partial of dW, dWb and dbb, rounded to the
//      weights' dtype (exact: the walk rounds each partial first);
//   4./5. kan::walk_tiles adds the partials in tile order, rounding the
//      running sum to the weights' dtype after each tile, as the JAX
//      kernel's `dw_ref += partial.astype(dw.dtype)` over its sequential
//      grid; the dW partials in windows of tiles (at most 128 MiB of
//      scratch) that carry the running sum, dlng/dlnb in one pass. No
//      atomics: the result is deterministic.
// A row of zeros (pad rows after MaskedBatchNorm) has variance 0 and
// rstd = 1/sqrt(1e-5): finite, as in the JAX kernel.

#include "fastkan_common.cuh"

namespace {

using namespace fkan;

constexpr int kDxRows = 32;  // rows per dx tile: 8 row groups of 4
constexpr int kDwRows = 32;  // rows per dW partial step

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ lng, const T* __restrict__ lnb,
           const T* __restrict__ w, const T* __restrict__ wb, const T* __restrict__ bb,
           T* __restrict__ out, int n, int D, int O, Centers cs, float inv_h) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                              // kFwdRows x D
  float* A_s = x_s + (size_t)kFwdRows * D;        // kFwdRows x AC
  float* mu_s = A_s + (size_t)kFwdRows * Shape<G>::AC;
  float* rstd_s = mu_s + kFwdRows;
  const int row0 = blockIdx.x * kFwdRows;
  for (int i = threadIdx.x; i < kFwdRows * D; i += kThreads) {
    const int row = row0 + i / D;
    x_s[i] = row < n ? to_f(x[(size_t)row0 * D + i]) : 0.f;
  }
  forward_tile<T, G>(x_s, A_s, mu_s, rstd_s, row0, n, D, O, lng, lnb, cs, inv_h, w, wb, bb,
                     out);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const T* __restrict__ lng, const T* __restrict__ lnb,
          const T* __restrict__ w, const T* __restrict__ wb, const T* __restrict__ dout,
          T* __restrict__ dx, float* __restrict__ stats, float* __restrict__ ln_sub, int n,
          int D, int O, Centers cs, float inv_h, int rows_per_split) {
  using S = Shape<G>;
  constexpr int R = kDxRows;
  constexpr int pitch = S::AC + 1;  // odd pitch: conflict-free staging stores
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                           // R x D
  float* dxs_s = x_s + (size_t)R * D;          // R x D: dL/dxs
  float* st_s = dxs_s + (size_t)R * D;         // R x D: SiLU' term of dx
  float* dout_s = st_s + (size_t)R * D;        // R x O
  float* w_s = dout_s + (size_t)R * O;         // kOT x pitch, [o - o0][g*kDC + j]
  float* mu_s = w_s + (size_t)kOT * pitch;     // R
  float* rstd_s = mu_s + R;                    // R
  const int dd = threadIdx.x % kDC;
  const int rg = threadIdx.x / kDC;  // 8 row groups of 4 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rbeg = blockIdx.x * rows_per_split;
  const int rend = min(n, rbeg + rows_per_split);
  const float two_inv_h = -2.f * inv_h;

  for (int r0 = rbeg; r0 < rend; r0 += R) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int row = r0 + i / D;
      x_s[i] = row < rend ? to_f(x[(size_t)r0 * D + i]) : 0.f;
    }
    for (int i = threadIdx.x; i < R * O; i += kThreads) {
      const int row = r0 + i / O;
      dout_s[i] = row < rend ? to_f(dout[(size_t)r0 * O + i]) : 0.f;
    }
    __syncthreads();
    ln_stats(x_s, R, D, mu_s, rstd_s);
    __syncthreads();
    if (threadIdx.x < R && r0 + threadIdx.x < rend) {
      stats[2 * (size_t)(r0 + threadIdx.x)] = mu_s[threadIdx.x];
      stats[2 * (size_t)(r0 + threadIdx.x) + 1] = rstd_s[threadIdx.x];
    }
    for (int d0 = 0; d0 < D; d0 += kDC) {
      float acc[4][S::NG];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < S::NG; ++g) acc[i][g] = 0.f;
      // the chunk's weights one kOT-wide tile of outputs at a time, so that
      // shared memory does not grow with O; acc sums over o in order
      for (int o0 = 0; o0 < O; o0 += kOT) {
        const int on = min(kOT, O - o0);
        __syncthreads();  // the previous tile's products are done with w_s
        for (int i = threadIdx.x; i < on * S::AC; i += kThreads) {
          const int o = i % on, rest = i / on;
          const int j = rest % kDC, g = rest / kDC;
          const int d = d0 + j;
          w_s[o * pitch + g * kDC + j] =
              d < D ? to_f(weight_row(wb, w, g, d, D, O)[o0 + o]) : 0.f;
        }
        __syncthreads();
        for (int o = 0; o < on; ++o) {
          float wv[S::NG];
#pragma unroll
          for (int g = 0; g < S::NG; ++g) wv[g] = w_s[o * pitch + g * kDC + dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dv = dout_s[(rg * 4 + i) * O + o0 + o];
#pragma unroll
            for (int g = 0; g < S::NG; ++g) acc[i][g] += dv * wv[g];
          }
        }
      }
      const int d = d0 + dd;
      if (d < D) {
        const float gam = to_f(lng[d]), bet = to_f(lnb[d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = rg * 4 + i;
          float dxs = 0.f, st = 0.f;
          if (r0 + rr < rend) {
            const float xv = x_s[rr * D + d];
            const float xs = ((xv - mu_s[rr]) * rstd_s[rr]) * gam + bet;
            float b[G], dist[G];
            rbf<G>(xs, cs, inv_h, b, dist);
#pragma unroll
            for (int g = 0; g < G; ++g) dxs += acc[i][g + 1] * b[g] * two_inv_h * dist[g];
            st = acc[i][0] * kan::dsilu(xv, sigmoid(xv));
          }
          dxs_s[rr * D + d] = dxs;
          st_s[rr * D + d] = st;
        }
      }
    }
    __syncthreads();
    // this R-row piece's sums of dxs * xhat and dxs (rows in order)
    float* sub = ln_sub + (size_t)(r0 / R) * 2 * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int rr = 0; rr < R; ++rr) {
        const float v = dxs_s[rr * D + d];
        sg += v * ((x_s[rr * D + d] - mu_s[rr]) * rstd_s[rr]);
        sb += v;
      }
      sub[d] = sg;
      sub[D + d] = sb;
    }
    if (dx == nullptr) continue;
    // the LayerNorm VJP per row: dx = rstd (dxhat - mean dxhat - xhat mean(dxhat xhat))
    for (int rr = warp; rr < R; rr += kThreads / 32) {
      const int row = r0 + rr;
      if (row >= rend) continue;
      const float mu = mu_s[rr], rstd = rstd_s[rr];
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dxhat = dxs_s[rr * D + c] * to_f(lng[c]);
        s1 += dxhat;
        s2 += dxhat * ((x_s[rr * D + c] - mu) * rstd);
      }
      const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
      for (int c = lane; c < D; c += 32) {
        const float xhat = (x_s[rr * D + c] - mu) * rstd;
        const float dxhat = dxs_s[rr * D + c] * to_f(lng[c]);
        dx[(size_t)row * D + c] = from_f<T>(rstd * (dxhat - m1 - xhat * m2) + st_s[rr * D + c]);
      }
    }
  }
}

// out[t*m + i] = sum over j < group, in order, of sub[(t*group + j)*m + i]
// (pieces past `parts` left out): the R-row pieces of dlng/dlnb added into
// the JAX tile's f32 partial.
__global__ void tile_sums_kernel(const float* __restrict__ sub, float* __restrict__ out,
                                 int parts, int group, int tiles, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tiles * m) return;
  const int t = i / m, c = i % m;
  float s = 0.f;
  for (int j = t * group; j < min(parts, (t + 1) * group); ++j) s += sub[(size_t)j * m + c];
  out[i] = s;
}

// grid (D chunks, row tiles t0.. of one window, O tiles): the partial of
// rows [t*tile, (t+1)*tile), rounded to T. Thread t owns 4 output columns
// (t % 16) x KPT basis columns (t / 16) of the chunk's (AC, kOT) block. The
// blocks of the first D chunk also sum dout into dbb.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ lng,
                  const T* __restrict__ lnb, const float* __restrict__ stats,
                  const T* __restrict__ dout, T* __restrict__ partial, int n, int D, int O,
                  Centers cs, float inv_h, int tile, int t0) {
  using S = Shape<G>;
  constexpr int KPT = S::AC / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                       // kDwRows x AC
  float* dout_s = smem + kDwRows * S::AC;  // kDwRows x kOT
  const int d0 = blockIdx.x * kDC;
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
        const float av = a[j];
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
    const int d = d0 + c % kDC;
    if (d >= D) continue;
    const size_t gc = (size_t)(c / kDC) * D + d;
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

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int G>
int launch_fwd(const void* x, const void* lng, const void* lnb, const void* w, const void* wb,
               const void* bb, void* out, int n, int D, int O, Centers cs, float inv_h,
               cudaStream_t stream) {
  const size_t smem = forward_smem<G>(D);
  if (int e = set_smem(fwd_kernel<T, G>, smem)) return e;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  if (grid.x > 0)
    fwd_kernel<T, G><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(lng), static_cast<const T*>(lnb),
        static_cast<const T*>(w), static_cast<const T*>(wb), static_cast<const T*>(bb),
        static_cast<T*>(out), n, D, O, cs, inv_h);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_bwd(const void* x, const void* lng, const void* lnb, const void* w, const void* wb,
               const void* dout, void* dx, float* stats, float* ln_partial, void* w_partial,
               void* grads, int n, int D, int O, Centers cs, float inv_h, int tile, int window,
               cudaStream_t stream) {
  using S = Shape<G>;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dout);
  const T* lg = static_cast<const T*>(lng);
  const T* lb = static_cast<const T*>(lnb);
  T* out = static_cast<T*>(grads);
  T* wp = static_cast<T*>(w_partial);
  const size_t m_w = (size_t)S::NG * D * O + O;  // [dWb; dW] then dbb
  const int tiles = (n + tile - 1) / tile;
  const int pieces = (n + kDxRows - 1) / kDxRows;
  float* ln_tiles = ln_partial + (size_t)pieces * 2 * D;
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int per = (pieces + 2 * sms - 1) / (2 * sms);  // pieces a block: about two blocks an SM
    const size_t smem = sizeof(float) * (3 * (size_t)kDxRows * D + (size_t)kDxRows * O +
                                         (size_t)kOT * (S::AC + 1) + 2 * kDxRows);
    if (int e = set_smem(dx_kernel<T, G>, smem)) return e;
    dx_kernel<T, G><<<(pieces + per - 1) / per, kThreads, smem, stream>>>(
        xt, lg, lb, static_cast<const T*>(w), static_cast<const T*>(wb), gt,
        static_cast<T*>(dx), stats, ln_partial, n, D, O, cs, inv_h, per * kDxRows);
    if (int e = (int)cudaGetLastError()) return e;
    const int m = 2 * D;
    tile_sums_kernel<<<(tiles * m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        ln_partial, ln_tiles, pieces, tile / kDxRows, tiles, m);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const size_t smem_w = sizeof(float) * ((size_t)kDwRows * S::AC + kDwRows * kOT);
  if (int e = set_smem(dw_partial_kernel<T, G>, smem_w)) return e;
  for (int t0 = 0; t0 < tiles || t0 == 0; t0 += window) {
    const int wt = std::min(window, tiles - t0);
    if (wt > 0) {
      dim3 grid((D + kDC - 1) / kDC, wt, (O + kOT - 1) / kOT);
      dw_partial_kernel<T, G><<<grid, kThreads, smem_w, stream>>>(xt, lg, lb, stats, gt, wp, n,
                                                                 D, O, cs, inv_h, tile, t0);
      if (int e = (int)cudaGetLastError()) return e;
    }
    if (int e = kan::walk_tiles<T, T>(wp, out, std::max(wt, 0), m_w, t0 > 0, stream)) return e;
  }
  return kan::walk_tiles<float, T>(ln_tiles, out + m_w, tiles, 2 * (size_t)D, false, stream);
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

// dx (n, D) (skipped when dx is null) and grads = [dWb (D*O) | dW (G*D*O) |
// dbb (O) | dlng (D) | dlnb (D)] in the inputs' dtype, from dout (n, O),
// summed over row tiles of `tile` rows (a multiple of 32). Scratch: stats 2n
// f32, ln_partial (ceil(n / 32) + ceil(n / tile)) * 2D f32, w_partial
// window * ((G+1)*D*O + O) in the inputs' dtype (`window` tiles at a time).
extern "C" int fastkan_bwd(const void* x, const void* lng, const void* lnb, const void* w,
                           const void* wb, const void* dout, void* dx, float* stats,
                           float* ln_partial, void* w_partial, void* grads, int n, int d,
                           int o, int G, const float* centers, float inv_h, int dtype,
                           int tile, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  FASTKAN_DISPATCH(dtype, G, launch_bwd, x, lng, lnb, w, wb, dout, dx, stats, ln_partial,
                   w_partial, grads, n, d, o, cs, inv_h, tile, window, s);
}
