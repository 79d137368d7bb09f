// Shared device code of the port's kernels: element conversions, SiLU, the
// warp-per-row CSR gather (spmm.cu, gin_fused.cu, gin_fastkan.cu), the
// piece gather with wide loads (gcn_agg.cu), the piece schedule of the
// kernels that split heavy CSR rows (gcn_agg.cu, gat_fused.cu, gat_bwd.cu),
// the tile-ordered walk of weight-gradient partials (bspline_fused.cu,
// fastkan_layer.cu, rbf_fused.cu), and for the KANLinear kernels the
// Cox-de Boor ladder, the basis tiles (f32 for the CUDA-core kernels, bf16
// for the tensor-core ones) and the dtype dispatch at the (spline order,
// grid size) a library is built for.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace kan {

// dtype codes passed from Python
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and back: where the JAX kernel casts an operand
// to the compute dtype before a matrix product
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Cox-de Boor recursion for one (row, feature) value in f32, the same
// arithmetic as kagnn_tpu/pallas/bspline_fused.py::_basis_ladder: order-0
// indicators of the half-open knot spans, then ORDER levels of
//   b_j <- (x - t_j) / (t_{j+kk} - t_j) * b_j
//          - (x - t_{j+kk+1}) / (t_{j+kk+1} - t_{j+1}) * b_{j+1}
// with the divisions as multiplications by reciprocals. Writes the NB =
// NK-1-ORDER final bases and, when pen != nullptr, the NB+1 bases of order
// ORDER-1 that the analytic derivative needs. Every index is a compile-time
// constant after unrolling, so the arrays live in registers. rcp(kk, j)
// gives 1 / (t_{j+kk} - t_j) (ladder computes it; a caller that builds many
// rows of one feature reads it from a table, rcp_table).
template <int ORDER, int NK, typename Rcp>
__device__ __forceinline__ void ladder_r(float x, const float (&t)[NK], Rcp rcp,
                                         float (&b)[NK - 1], float* pen) {
  float xt[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) xt[j] = x - t[j];
#pragma unroll
  for (int j = 0; j < NK - 1; ++j) b[j] = (xt[j] >= 0.f && xt[j + 1] < 0.f) ? 1.f : 0.f;
#pragma unroll
  for (int kk = 1; kk <= ORDER; ++kk) {
    if (kk == ORDER && pen != nullptr) {
#pragma unroll
      for (int j = 0; j < NK - ORDER; ++j) pen[j] = b[j];
    }
#pragma unroll
    for (int j = 0; j < NK - 1 - kk; ++j)
      b[j] = xt[j] * rcp(kk, j) * b[j] - xt[j + kk + 1] * rcp(kk, j + 1) * b[j + 1];
  }
}

template <int ORDER, int NK>
__device__ __forceinline__ void ladder(float x, const float (&t)[NK], float (&b)[NK - 1],
                                       float* pen) {
  ladder_r<ORDER, NK>(x, t, [&](int kk, int j) { return 1.f / (t[j + kk] - t[j]); }, b, pen);
}

// The reciprocals of the ladder's knot spans, 1 / (t_{j+kk} - t_j) for kk =
// 1..ORDER and j = 0..NK-1-kk, indexed level by level: rcp_off(kk) + j;
// kRcps<ORDER, NK> of them a feature.
template <int NK>
__host__ __device__ constexpr int rcp_off(int kk) {
  return (kk - 1) * NK - (kk - 1) * kk / 2;
}
template <int ORDER, int NK>
constexpr int kRcps = rcp_off<NK>(ORDER + 1);

// d silu / dx with s = sigmoid(x)
__device__ __forceinline__ float dsilu(float x, float s) { return s * (1.f + x * (1.f - s)); }

constexpr int kCpl = 4;  // columns per lane per pass of a CSR gather: 128 a pass

// The CSR gather of one output row by one warp: acc[j] = the f32 sum, in edge
// order, of column c0 + lane + 32*j of row (idx ? idx[e] : e) of src (rows of
// d values) over e in [e0, e1); columns at or past d stay 0. Edges are
// unrolled by four so that four rows are in flight per warp. The fixed order
// makes the sum deterministic without atomics.
template <typename T>
__device__ __forceinline__ void csr_row_sum(const T* __restrict__ src,
                                            const int* __restrict__ idx, int e0, int e1,
                                            int c0, int lane, int d, float (&acc)[kCpl]) {
#pragma unroll
  for (int j = 0; j < kCpl; ++j) acc[j] = 0.f;
  int e = e0;
  for (; e + 4 <= e1; e += 4) {
    int row[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) row[u] = idx ? __ldg(idx + e + u) : e + u;
    float v[4][kCpl];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T* rowp = src + (size_t)row[u] * d;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = c0 + lane + 32 * j;
        v[u][j] = c < d ? to_f(rowp[c]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < kCpl; ++j) acc[j] += v[u][j];
  }
  for (; e < e1; ++e) {
    const T* rowp = src + (size_t)(idx ? __ldg(idx + e) : e) * d;
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) acc[j] += to_f(rowp[c]);
    }
  }
}

// V values of T that one lane loads at once: 16 bytes (V = 16 / sizeof(T)),
// or one value when V == 1.
template <typename T, int V>
using Pack = std::conditional_t<V == 1, T, uint4>;

template <typename T, int V>
__device__ __forceinline__ void add_pack(const Pack<T, V>& r, float (&acc)[V]) {
  if constexpr (V == 1) {
    acc[0] += to_f(r);
  } else if constexpr (std::is_same_v<T, float>) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += f[j];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else {
    Pack<T, V> r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = from_f<T>(v[j]);
    *reinterpret_cast<Pack<T, V>*>(p) = r;
  }
}

// The CSR gather of a lane group with wide loads, for rows split into
// pieces: acc[j] = the f32 sum, in edge order, of column c + j of row idx[e]
// of src (rows of d values) over e = e0, e0 + step, ... < e1. Each lane
// loads V columns at once (16 bytes, or one value when V == 1; the caller
// keeps c + V <= d and the rows 16-byte aligned) and keeps U edges in
// flight; edges past e1 are masked, not left to a serial tail. The fixed
// order makes the sum deterministic without atomics. (csr_row_sum above is
// the warp-per-row walk of the kernels not yet moved to this one.)
template <typename T, int V, int U>
__device__ __forceinline__ void csr_piece_sum(const T* __restrict__ src,
                                              const int* __restrict__ idx, int e0, int e1,
                                              int step, int c, int d, float (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int e = e0; e < e1; e += U * step) {
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) row[u] = e + u * step < e1 ? __ldg(idx + e + u * step) : -1;
    Pack<T, V> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) r[u] = __ldg(reinterpret_cast<const Pack<T, V>*>(src + (size_t)row[u] * d + c));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) add_pack<T, V>(r[u], acc);
  }
}

// The piece schedule of the CSR kernels that split heavy rows (gcn_agg.cu,
// gat_fused.cu, gat_bwd.cu). The edges [0, end) are cut into chunks of
// PIECE; a row's range is clipped at `end` (gcn_agg passes every edge, the
// GAT kernels the valid ones, whose padding is the tail of the edges), and
// a row is heavy when more than PIECE of its edges remain. One warp a chunk
// sums the heavy rows' pieces inside its chunk into partials, two slots a
// chunk: slot 0 the heavy row holding the chunk's first edge, slot 1 a
// heavy row that starts inside the chunk (such a row runs past the chunk's
// end, so there is at most one). A combine then walks each heavy row's
// pieces in chunk order, from the chunk holding its last edge. The rows
// of a chunk's first and last edge are the caller's (from `receivers`, or
// a search of row_ptr), so no schedule is built on the host.
struct Piece {
  int row;
  int lo, hi;  // the piece: the row's edges inside the chunk
};

// [cs, ce): chunk ch's edges below `end`; false when the chunk has none
template <int PIECE>
__device__ __forceinline__ bool chunk_edges(int ch, int end, int& cs, int& ce) {
  cs = ch * PIECE;
  ce = min(cs + PIECE, end);
  return cs < end;
}

// [e0, e1): row `row`'s edges below `end`
__device__ __forceinline__ void clipped_row(const int* __restrict__ row_ptr, int row, int end,
                                            int& e0, int& e1) {
  e0 = min(row_ptr[row], end);
  e1 = min(row_ptr[row + 1], end);
}

// Slot `slot` of the chunk [cs, ce), whose first edge is in row `first`
// and last edge in row `last`: true, with the piece, when a heavy row holds
// it (a light row is summed whole elsewhere).
template <int PIECE>
__device__ __forceinline__ bool chunk_piece(int slot, int cs, int ce, int first, int last,
                                            int end, const int* __restrict__ row_ptr,
                                            Piece& p) {
  if (slot == 1 && last == first) return false;
  const int row = slot == 0 ? first : last;
  int e0, e1;
  clipped_row(row_ptr, row, end, e0, e1);
  if (e1 - e0 <= PIECE) return false;
  p = {row, max(e0, cs), min(e1, ce)};
  return true;
}

// Whether the combine of chunk cs / PIECE owns row `row` (the row of the
// chunk's first edge): a heavy row whose last edge lies in the chunk. Its
// clipped range is [e0, e1) and its pieces are those of the chunks
// e0 / PIECE .. cs / PIECE.
template <int PIECE>
__device__ __forceinline__ bool ends_heavy(int cs, int row, int end,
                                           const int* __restrict__ row_ptr, int& e0, int& e1) {
  clipped_row(row_ptr, row, end, e0, e1);
  return e1 - e0 > PIECE && e1 <= cs + PIECE;
}

// The partial slots of a heavy row's pieces: slots(k) is chunk k's; the
// row's first chunk e0 / PIECE and whether it starts inside it are found
// once, out of the combines' loops over the chunks.
struct PieceSlots {
  int first;  // the chunk of the row's first edge
  int head;   // 1 when the row starts inside it (slot 1 there), else 0
  __device__ __forceinline__ size_t operator()(int k) const {
    return 2 * (size_t)k + (k == first ? head : 0);
  }
};

template <int PIECE>
__device__ __forceinline__ PieceSlots piece_slots(int e0) {
  return {e0 / PIECE, e0 % PIECE ? 1 : 0};
}

// The weight-gradient walk of the layer backwards (bspline_fused.cu,
// fastkan_layer.cu, rbf_fused.cu): partial holds `tiles` per-tile partials of
// m elements each (in TP: f32, or already rounded to TW), and
//   dw[i] = s,  s = round_TW(s + round_TW(partial[t*m + i])), t in order,
// the JAX backward's `dw_ref += partial.astype(dw.dtype)` over its
// sequential grid. With carry, s starts from dw[i] (a value in TW, so the
// carry is exact): windows of tiles walked one after another give the walk
// of all of them. No atomics: the result is deterministic.
template <typename TP, typename TW>
__global__ void walk_tiles_kernel(const TP* __restrict__ partial, TW* __restrict__ dw, int tiles,
                                  size_t m, bool carry) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < m;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = carry ? to_f(dw[i]) : 0.f;
    // the loads are independent of the running sum: 32 a thread in flight
#pragma unroll 32
    for (int t = 0; t < tiles; ++t) s = round_t<TW>(s + round_t<TW>(to_f(partial[t * m + i])));
    dw[i] = from_f<TW>(s);
  }
}

template <typename TP, typename TW>
int walk_tiles(const TP* partial, TW* dw, int tiles, size_t m, bool carry, cudaStream_t stream) {
  const size_t need = (m + 255) / 256;
  const int blocks = need < 4096 ? (int)need : 4096;
  if (blocks > 0) walk_tiles_kernel<TP, TW><<<blocks, 256, 0, stream>>>(partial, dw, tiles, m, carry);
  return (int)cudaGetLastError();
}

constexpr int kThreads = 256;  // threads per block of every KAN kernel
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use on the H100
constexpr int kFwdRows = 32;   // rows per forward tile: 4 row groups of 8
constexpr int kDC = 32;        // features per chunk of the basis matrix
constexpr int kOT = 64;        // output columns per block (blockIdx.y tiles O)

// Columns of one feature chunk of the basis matrix A = [SiLU(x) | B_0 .. B_NB-1]:
// column g*kDC + j holds feature d0 + j of group g (g = 0 is SiLU).
template <int ORDER, int GRID> struct Shape {
  static constexpr int NK = GRID + 2 * ORDER + 1;  // knots per feature
  static constexpr int NB = GRID + ORDER;          // bases per feature
  static constexpr int NG = NB + 1;                // groups: SiLU + bases
  static constexpr int AC = NG * kDC;              // columns of a chunk
};

// Row g*D + d of the stacked weight [Wb; Ws] (D*NG, O): group 0 is the base
// weight (D, O), group g >= 1 the spline weight laid out as (NB*D, O).
template <typename T>
__device__ __forceinline__ const T* weight_row(const T* wb, const T* ws, int g, int d, int D,
                                               int O) {
  return g == 0 ? wb + (size_t)d * O : ws + ((size_t)(g - 1) * D + d) * O;
}

// Fill the basis chunk A_s (rows x AC floats) for features d0..d0+kDC-1 of
// `rows` rows. load(rr, row, d) returns the f32 input of local row rr; rows
// at or past `row_end` and features past D give zeros. Each value is rounded
// to T, as the JAX kernel casts SiLU(x) and the bases before its products.
template <typename T, int ORDER, int GRID, typename Load>
__device__ __forceinline__ void build_basis_chunk(Load load, float* A_s, int rows, int row0,
                                                  int row_end, int d0, int D, const T* knots) {
  using S = Shape<ORDER, GRID>;
  const int dd = threadIdx.x % kDC;
  const int d = d0 + dd;
  float t[S::NK];
#pragma unroll
  for (int j = 0; j < S::NK; ++j) t[j] = d < D ? to_f(knots[(size_t)j * D + d]) : 0.f;
  for (int rr = threadIdx.x / kDC; rr < rows; rr += kThreads / kDC) {
    const int row = row0 + rr;
    float* a = A_s + rr * S::AC + dd;
    if (d < D && row < row_end) {
      const float xv = load(rr, row, d);
      a[0] = round_t<T>(xv * sigmoid(xv));
      float b[S::NK - 1];
      ladder<ORDER, S::NK>(xv, t, b, nullptr);
#pragma unroll
      for (int g = 0; g < S::NB; ++g) a[(g + 1) * kDC] = round_t<T>(b[g]);
    } else {
#pragma unroll
      for (int g = 0; g < S::NG; ++g) a[g * kDC] = 0.f;
    }
  }
}

// The bf16 basis tile of the tensor-core B-spline kernels (bspline_fused.cu:
// the forward and the dW partials): row rr of A_s (pitch pa bf16), column
// g*FC + j, holds group g (0: SiLU(x), g >= 1: B_{g-1}) of feature d0 + j of
// row row0 + rr, for rows rr < rows, of which the first `valid` are data:
// the others, and features past D, are zeros. load(rr, row, d) gives the f32
// input, as kan_forward_tile's Load. Each value is rounded to bf16 once, as
// the JAX kernels cast SiLU(x) and the bases before their products. Thread t
// owns feature d0 + t % FC. r_s: the chunk's rcp_table, or null (each
// ladder computes its reciprocals).
// The span reciprocals of features d0 .. d0+FC-1 (the values ladder computes
// for itself), once for all of a block's rows of those features:
// r_s[(rcp_off(kk) + j) * FC + f]; features past D are left unwritten.
template <int ORDER, int GRID, int FC>
__device__ __forceinline__ void rcp_table(float* r_s, int d0, int D,
                                          const __nv_bfloat16* __restrict__ knots) {
  constexpr int NK = Shape<ORDER, GRID>::NK;
  for (int i = threadIdx.x; i < (NK - 1) * FC; i += kThreads) {
    const int j = i / FC, f = i % FC, d = d0 + f;
    if (d >= D) continue;
    const float tj = to_f(knots[(size_t)j * D + d]);
#pragma unroll
    for (int kk = 1; kk <= ORDER; ++kk)
      if (j + kk < NK)
        r_s[(rcp_off<NK>(kk) + j) * FC + f] =
            1.f / (to_f(knots[(size_t)(j + kk) * D + d]) - tj);
  }
}

template <int ORDER, int GRID, int FC, typename Load>
__device__ __forceinline__ void basis_tile_bf16(Load load, __nv_bfloat16* A_s, int pa, int rows,
                                                int row0, int valid, int d0, int D,
                                                const __nv_bfloat16* __restrict__ knots,
                                                const float* r_s = nullptr) {
  using S = Shape<ORDER, GRID>;
  const int j = threadIdx.x % FC, d = d0 + j;
  float t[S::NK];
#pragma unroll
  for (int q = 0; q < S::NK; ++q) t[q] = d < D ? to_f(knots[(size_t)q * D + d]) : 0.f;
  for (int rr = threadIdx.x / FC; rr < rows; rr += kThreads / FC) {
    __nv_bfloat16* a = A_s + (size_t)rr * pa + j;
    if (d < D && rr < valid) {
      const float xv = load(rr, row0 + rr, d);
      a[0] = from_f<__nv_bfloat16>(xv * sigmoid(xv));
      float b[S::NK - 1];
      if (r_s != nullptr)
        ladder_r<ORDER, S::NK>(
            xv, t, [&](int kk, int q) { return r_s[(rcp_off<S::NK>(kk) + q) * FC + j]; },
            b, nullptr);
      else
        ladder<ORDER, S::NK>(xv, t, b, nullptr);
#pragma unroll
      for (int g = 0; g < S::NB; ++g) a[(g + 1) * FC] = from_f<__nv_bfloat16>(b[g]);
    } else {
#pragma unroll
      for (int g = 0; g < S::NG; ++g) a[g * FC] = from_f<__nv_bfloat16>(0.f);
    }
  }
}

// The whole KANLinear forward of one tile of kFwdRows rows starting at row0:
//   out[row, o] = sum_{g, d} A[row, g*D + d] * W[g*D + d, o]
// accumulated in f32 over feature chunks and written in T. Thread t owns
// output column o = blockIdx.y*kOT + t % kOT for 8 rows (row group t / kOT).
// A_s needs kFwdRows * AC floats of shared memory.
template <typename T, int ORDER, int GRID, typename Load>
__device__ __forceinline__ void kan_forward_tile(Load load, float* A_s, int row0, int n, int D,
                                                 int O, const T* __restrict__ knots,
                                                 const T* __restrict__ wb,
                                                 const T* __restrict__ ws, T* __restrict__ out) {
  using S = Shape<ORDER, GRID>;
  const int o = blockIdx.y * kOT + threadIdx.x % kOT;
  const int rg = threadIdx.x / kOT;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    __syncthreads();  // the previous chunk's products are done with A_s
    build_basis_chunk<T, ORDER, GRID>(load, A_s, kFwdRows, row0, n, d0, D, knots);
    __syncthreads();
    const int dn = min(kDC, D - d0);
    if (o < O) {
      const float* a0 = A_s + rg * 8 * S::AC;
#pragma unroll
      for (int g = 0; g < S::NG; ++g) {
        const T* wrow = weight_row(wb, ws, g, d0, D, O) + o;
        for (int j = 0; j < dn; ++j) {
          const float w = to_f(wrow[(size_t)j * O]);
          const float* a = a0 + g * kDC + j;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += a[i * S::AC] * w;
        }
      }
    }
  }
  if (o < O) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + rg * 8 + i;
      if (row < n) out[(size_t)row * O + o] = from_f<T>(acc[i]);
    }
  }
}

}  // namespace kan

// The shape a library of a KANLinear source is built for: each (spline
// order, grid size) is its own library, compiled at its first use with the
// shape as -D defines (kernels/_build.py). The defaults are the main path's.
#ifndef KAN_ORDER
#define KAN_ORDER 3
#endif
#ifndef KAN_GRID
#define KAN_GRID 4
#endif

// Calls FN<T, KAN_ORDER, KAN_GRID>(args...) for f32 or bf16 and returns
// cudaErrorInvalidValue for another dtype or shape.
#define KAN_DISPATCH(dtype, order, grid, FN, ...)                              \
  do {                                                                         \
    if (order != KAN_ORDER || grid != KAN_GRID) return (int)cudaErrorInvalidValue; \
    if (dtype == kan::kF32) return FN<float, KAN_ORDER, KAN_GRID>(__VA_ARGS__);   \
    if (dtype == kan::kBF16)                                                   \
      return FN<__nv_bfloat16, KAN_ORDER, KAN_GRID>(__VA_ARGS__);              \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)
