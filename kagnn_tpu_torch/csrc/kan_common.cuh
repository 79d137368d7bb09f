// Shared device code of the port's kernels: element conversions, SiLU, the
// piece gather with wide loads (gcn_agg.cu, spmm.cu, gin_sum.cuh), the piece
// schedule of the kernels that split heavy CSR rows (gcn_agg.cu, spmm.cu,
// gin_sum.cuh, gat_fused.cu, gat_bwd.cu), the warp search of a CSR's row_ptr
// for the row of an edge, the split row sum of spmm.cu and gin_sum.cuh, the
// tile-ordered walk of weight-gradient partials and the sum of the dx
// kernels' output parts (bspline_fused.cu, fastkan_layer.cu, rbf_fused.cu),
// and for the KANLinear kernels the
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
// (row e when idx is null) of src (rows of d values) over e = e0, e0 +
// step, ... < e1. Each lane
// loads V columns at once (16 bytes, or one value when V == 1; the caller
// keeps c + V <= d and the rows 16-byte aligned) and keeps U edges in
// flight; edges past e1 are masked, not left to a serial tail. The fixed
// order makes the sum deterministic without atomics.
template <typename T, int V, int U>
__device__ __forceinline__ void csr_piece_sum(const T* __restrict__ src,
                                              const int* __restrict__ idx, int e0, int e1,
                                              int step, int c, int d, float (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int e = e0; e < e1; e += U * step) {
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + u * step;
      row[u] = eu < e1 ? (idx != nullptr ? __ldg(idx + eu) : eu) : -1;
    }
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
// spmm.cu, gin_sum.cuh, gat_fused.cu, gat_bwd.cu). The edges [0, end) are cut into chunks
// of PIECE; a row's range is clipped at `end` (gcn_agg and spmm pass every
// edge, the GAT kernels the valid ones, whose padding is the tail of the
// edges), and
// a row is heavy when more than PIECE of its edges remain. One warp a chunk
// sums the heavy rows' pieces inside its chunk into partials, two slots a
// chunk: slot 0 the heavy row holding the chunk's first edge, slot 1 a
// heavy row that starts inside the chunk (such a row runs past the chunk's
// end, so there is at most one). A combine then walks each heavy row's
// pieces in chunk order, from the chunk holding its last edge. The rows
// of a chunk's first and last edge are the caller's (from `receivers`, or
// a search of row_ptr, row_of_edge), so no schedule is built on the host.
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

// The row of edge e of a CSR of n rows (the last row r with row_ptr[r] <=
// e; 0 <= e < row_ptr[n], row_ptr[0] == 0), found by the whole warp: each
// round its 32 lanes probe 32 points of the range left, so 4 rounds cover a
// million rows. The kernels that split heavy rows without the edges'
// `receivers` (the GAT kernels, spmm) find their chunks' rows here. Every
// lane of the warp must call it with the same e.
__device__ __forceinline__ int row_of_edge(const int* __restrict__ row_ptr, int n, int e) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = n;  // the row is in [lo, hi) and row_ptr[lo] <= e
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned ok = __ballot_sync(0xffffffffu, q < hi && __ldg(row_ptr + q) <= e);
    lo += (31 - __clz(ok)) * step;  // lane 0 probes lo itself, so ok != 0
    hi = min(hi, lo + step);
  }
  return lo;
}

// ---- the split row sum of a CSR (spmm.cu, gin_sum.cuh) ---------------------
//
// sum_{e in row r} src[idx[e]] (src[e] without idx) for every row of a CSR, in
// f32, with 16-byte loads in 128-byte column slabs (grid.y) and the rows of
// more than PIECE edges split into pieces at the PIECE-edge chunks of the
// edge array (the schedule above): launch 1 (split_row_sum) sums the light
// rows whole, one lane group a row in edge order, and the heavy rows'
// pieces, one warp a chunk, into f32 partials; launch 2
// (split_row_combine) adds each heavy row's pieces in chunk order. A chunk
// warp finds the rows of its first and last edge by row_of_edge (no
// `receivers`), and slab 0 keeps the first one for launch 2. No atomics:
// deterministic. What each caller does with a row's sums is its store.

constexpr int kSplitWarps = 8;  // warps a block of both launches

// V columns a lane (16 / sizeof(T), or 1 where d does not fill whole
// 16-byte packs); L lanes a row cover its slab of L * V columns (128 bytes);
// R lane groups a warp; U edges in flight a lane group.
template <int V>
struct SlabCfg {
  static constexpr int L = V == 1 ? 32 : 8;
  static constexpr int SLAB = L * V;
  static constexpr int R = 32 / L;
  static constexpr int U = L / 2 > 4 ? L / 2 : 4;  // R * U >= 16 gathers a warp
};

// Launch 1, kSplitWarps warps a block. Blocks [0, chunk_blocks) of slab 0
// sum the heavy rows' pieces, one warp a chunk and every slab in turn (the
// chunk's rows are searched once), into partial (2 slots of d floats a
// chunk), and keep the row of each chunk's first edge in first_row (those
// blocks of the other slabs return at once); the rest take columns [c0, c0
// + SLAB) of slab blockIdx.y of the light rows whole, one lane group a row,
// and call light(row, c, acc) with the row's sums of columns c .. c+V-1.
template <typename T, int V, int PIECE, typename Light>
__device__ __forceinline__ void split_row_sum(const T* __restrict__ src,
                                              const int* __restrict__ row_ptr,
                                              const int* __restrict__ idx,
                                              float* __restrict__ partial,
                                              int* __restrict__ first_row, int n_rows, int d,
                                              int chunk_blocks, Light light) {
  using C = SlabCfg<V>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / C::L, gl = lane % C::L;
  if ((int)blockIdx.x < chunk_blocks) {
    if (blockIdx.y != 0) return;
    const int ch = blockIdx.x * kSplitWarps + warp;
    const int n_edges = __ldg(row_ptr + n_rows);
    int cs, ce;
    if (!chunk_edges<PIECE>(ch, n_edges, cs, ce)) return;
    const int first = row_of_edge(row_ptr, n_rows, cs);
    const int last = row_of_edge(row_ptr, n_rows, ce - 1);
    if (lane == 0) first_row[ch] = first;
#pragma unroll 1
    for (int slot = 0; slot < 2; ++slot) {
      Piece p;
      if (!chunk_piece<PIECE>(slot, cs, ce, first, last, n_edges, row_ptr, p)) continue;
      float* part = partial + ((size_t)ch * 2 + slot) * d;
      for (int c = gl * V; c < d + gl * V; c += C::SLAB) {  // slab by slab
        float acc[V];
        if (c < d) {
          csr_piece_sum<T, V, C::U>(src, idx, p.lo + group, p.hi, C::R, c, d, acc);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = 0.f;
        }
        // the groups' sums meet in a fixed butterfly (the same order every run)
#pragma unroll
        for (int off = C::L; off < 32; off <<= 1)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
        if (group == 0 && c < d) {
#pragma unroll
          for (int j = 0; j < V; ++j) part[c + j] = acc[j];
        }
      }
    }
    return;
  }
  const int c = blockIdx.y * C::SLAB + gl * V;  // this lane's columns
  const int row = ((blockIdx.x - chunk_blocks) * kSplitWarps + warp) * C::R + group;
  if (row >= n_rows || c >= d) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  if (e1 - e0 > PIECE) return;  // a heavy row: launch 2 writes it
  float acc[V];
  csr_piece_sum<T, V, C::U>(src, idx, e0, e1, 1, c, d, acc);
  light(row, c, acc);
}

// The column parts of a combine over d columns: blockIdx.y = part, a warp's
// lanes take columns part*32 + lane, + 32*parts, ..., so that a heavy row's
// columns are added by up to kCombineParts warps at once (one warp walked
// a 2,748-edge row's 43 pieces of 260 columns in 0.12 ms on the H100).
constexpr int kCombineParts = 8;
inline int combine_parts(int d) { return std::max(1, std::min(kCombineParts, (d + 31) / 32)); }

// Launch 2, one warp a chunk (kSplitWarps a block) and column part
// blockIdx.y of gridDim.y (combine_parts): the heavy row holding the
// chunk's first edge and ending inside the chunk has all its pieces
// written; add them in chunk order and call store(row, c, sum) for each of
// the part's columns c.
template <int PIECE, typename Store>
__device__ __forceinline__ void split_row_combine(const int* __restrict__ row_ptr,
                                                  const float* __restrict__ partial,
                                                  const int* __restrict__ first_row,
                                                  int n_rows, int d, Store store) {
  const int ch = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int n_edges = __ldg(row_ptr + n_rows);
  int cs, ce, e0, e1;
  if (!chunk_edges<PIECE>(ch, n_edges, cs, ce)) return;
  const int row = first_row[ch];
  if (!ends_heavy<PIECE>(cs, row, n_edges, row_ptr, e0, e1)) return;
  const PieceSlots slot = piece_slots<PIECE>(e0);
  for (int c = blockIdx.y * 32 + lane; c < d; c += 32 * gridDim.y) {
    float s = 0.f;
    // 8 loads in flight through the read-only path: the adds keep the order
#pragma unroll 8
    for (int k = slot.first; k <= ch; ++k) s += __ldg(partial + slot(k) * d + c);
    store(row, c, s);
  }
}

// The grid of launch 1 at V columns a lane: the chunk blocks, then the row
// blocks; grid.y the column slabs.
template <int V>
inline dim3 split_grid(int chunk_blocks, int n_rows, int d) {
  using C = SlabCfg<V>;
  constexpr int rows_per_block = kSplitWarps * C::R;
  return dim3(chunk_blocks + (n_rows + rows_per_block - 1) / rows_per_block,
              (d + C::SLAB - 1) / C::SLAB);
}

// Blocks of kSplitWarps chunk warps over the chunks of max_edges edges.
template <int PIECE>
inline int split_chunk_blocks(int max_edges) {
  const int chunks = (max_edges + PIECE - 1) / PIECE;
  return (chunks + kSplitWarps - 1) / kSplitWarps;
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

// The dx kernels of the layer backwards (bspline_fused.cu, fastkan_layer.cu,
// rbf_fused.cu) cut outputs whose staged rows do not fit in a block into
// parts; each part's f32 share of dx (linear in its dbasis) goes to vbuf,
// parts x m floats, and each library's sum kernel runs this body:
// dx[i] = the sum over the parts, in order, of their shares.
template <typename T>
__device__ __forceinline__ void sum_parts(const float* __restrict__ vbuf, T* __restrict__ dx,
                                          size_t m, int parts) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < m;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += vbuf[p * m + i];
    dx[i] = from_f<T>(s);
  }
}

// blocks of kThreads of a sum_parts kernel over m values
inline int sum_parts_blocks(size_t m) {
  return (int)std::min<size_t>((m + kThreads - 1) / kThreads, 4096);
}

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

// KAN_DISPATCH for a backward that also takes the weights' dtype (their
// gradients' type): FN<T, TW, KAN_ORDER, KAN_GRID> for x and weights both
// f32 or both bf16, or an f32 x with bf16 weights (the JAX kernels' mixed
// pair of a layer whose parameters are bf16 and whose input is f32).
#define KAN_DISPATCH_W(dtype, wdtype, order, grid, FN, ...)                    \
  do {                                                                         \
    if (order != KAN_ORDER || grid != KAN_GRID) return (int)cudaErrorInvalidValue; \
    if (dtype == kan::kF32 && wdtype == kan::kF32)                             \
      return FN<float, float, KAN_ORDER, KAN_GRID>(__VA_ARGS__);               \
    if (dtype == kan::kBF16 && wdtype == kan::kBF16)                           \
      return FN<__nv_bfloat16, __nv_bfloat16, KAN_ORDER, KAN_GRID>(__VA_ARGS__); \
    if (dtype == kan::kF32 && wdtype == kan::kBF16)                            \
      return FN<float, __nv_bfloat16, KAN_ORDER, KAN_GRID>(__VA_ARGS__);       \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)
