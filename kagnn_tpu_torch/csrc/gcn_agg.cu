// Fused GCN aggregate for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gcn_agg.py::_kernel:
//   out[r] = dinv[r] * (hs[r] + sum_{e in [row_ptr[r], row_ptr[r+1])} hs[senders[e]])
// with the sum in f32, dinv in f32, and the output cast once to hs's dtype.
// hs already carries the sender-side norm (hs = h * dinv), so this is the
// whole symmetric-normalised D^-1/2 (A + I) D^-1/2 h with the self-loop in
// closed form.
//
// Bound on the H100: device-memory bytes. Every edge reads one sender row
// of D values (and one index); each output row adds its own row and one
// scale. The TPU kernel's one-hot MXU products, message DMA ring and
// 128-lane padding were TPU workarounds and are gone. The gather stays in
// the kernel: no (E, D) message tensor reaches device memory.
//
// What held the first version back: one warp walked each receiver row in
// edge order, so the arxiv-sized graph's node 0 (2,748 in-edges) kept one
// warp busy for 687 dependent rounds of gathers after the rest of the card
// had finished; and at D = 64 half of each pass was masked, 2-byte loads.
// This design:
//   * 16-byte loads: a lane loads V = 16 / sizeof(T) columns at once, so
//     a group of L lanes covers a row (L = 8 for bf16 at D 64, 16 in f32);
//     a warp holds 32 / L groups, each with U edges in flight, 16 gathers
//     per warp in all (kan::csr_piece_sum);
//   * rows split into pieces: the edge array is cut into chunks of kPiece
//     edges. A row with at most kPiece in-edges is summed whole by one lane
//     group (launch 1, row part). A heavier row is summed chunk by chunk: in
//     launch 1 one warp per chunk sums the row's edges inside the chunk,
//     its lane groups splitting them and meeting in a fixed shuffle tree,
//     into an f32 partial (two slots per chunk: the heavy row holding the
//     chunk's first edge, and one that starts inside the chunk); launch 2
//     then adds a heavy row's pieces in chunk order, its self term, and
//     applies dinv once (kan_common.cuh's piece schedule, which the GAT
//     kernels share). The chunk of an edge is known from its index and
//     the row of an edge from `receivers`, so no schedule is stored and the
//     wrapper never waits on the host. No float atomics: deterministic.
// kPiece = 64: the longest walk of one lane group is then 64 edges (16
// rounds of 4), and the hub row becomes 43 pieces of 4 rounds each; a
// smaller piece would double the chunk warps (18,224 at 64) for rows that
// already finish within the light rows' time.
// Padded edges point at the masked last row and are not masked, as in the
// JAX kernel. The backward needs no kernel of its own: it is the segment
// sum of spmm.cu over the sender CSR (kernels/gcn_agg.py).

#include "kan_common.cuh"

namespace {

constexpr int kWarps = 8;    // warps per block
constexpr int kPiece = 64;   // edges per chunk: rows above it are split

using kan::csr_piece_sum;
using kan::to_f;

// L lanes a row, V columns a lane, U edges in flight per lane group.
template <typename T, int V, int L>
struct Cfg {
  static constexpr int R = 32 / L;                  // lane groups per warp
  static constexpr int U = L / 2 > 4 ? L / 2 : 4;   // R * U >= 16 gathers a warp
};

// Launch 1. Blocks [0, chunk_blocks) sum the heavy rows' pieces, one warp a
// chunk; the rest sum the light rows whole, one lane group a row.
template <typename T, int V, int L>
__global__ void __launch_bounds__(kWarps * 32)
gcn_rows_kernel(const T* __restrict__ hs, const float* __restrict__ dinv,
                const int* __restrict__ senders, const int* __restrict__ receivers,
                const int* __restrict__ row_ptr, T* __restrict__ out, float* __restrict__ partial,
                int n_rows, int d, int n_edges, int chunk_blocks) {
  using C = Cfg<T, V, L>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / L, gl = lane % L;
  if ((int)blockIdx.x < chunk_blocks) {
    const int ch = blockIdx.x * kWarps + warp;
    int cs, ce;
    if (!kan::chunk_edges<kPiece>(ch, n_edges, cs, ce)) return;
    const int first = receivers[cs], last = receivers[ce - 1];
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      kan::Piece p;
      if (!kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edges, row_ptr, p)) continue;
      const int lo = p.lo, hi = p.hi;
      float* part = partial + ((size_t)ch * 2 + slot) * d;
      for (int c0 = 0; c0 < d; c0 += L * V) {
        const int c = c0 + gl * V;
        float acc[V];
        if (c < d) {
          csr_piece_sum<T, V, C::U>(hs, senders, lo + group, hi, C::R, c, d, acc);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = 0.f;
        }
        // the groups' sums meet in a fixed butterfly (the same order every run)
#pragma unroll
        for (int off = L; off < 32; off <<= 1)
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
  const int row = ((blockIdx.x - chunk_blocks) * kWarps + warp) * C::R + group;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  if (e1 - e0 > kPiece) return;  // a heavy row: launch 2 writes it
  const float scale = dinv[row];
  for (int c = gl * V; c < d; c += L * V) {
    float acc[V];
    csr_piece_sum<T, V, C::U>(hs, senders, e0, e1, 1, c, d, acc);
    float self[V];
#pragma unroll
    for (int j = 0; j < V; ++j) self[j] = 0.f;
    kan::add_pack<T, V>(*reinterpret_cast<const kan::Pack<T, V>*>(hs + (size_t)row * d + c),
                        self);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = (acc[j] + self[j]) * scale;
    kan::store_pack<T, V>(out + (size_t)row * d + c, acc);
  }
}

// Launch 2: one warp a chunk. The heavy row holding the chunk's first edge
// and ending inside the chunk has all its pieces written: add them in chunk
// order, then the self term, scale by dinv once, cast.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gcn_combine_kernel(const T* __restrict__ hs, const float* __restrict__ dinv,
                   const int* __restrict__ receivers, const int* __restrict__ row_ptr,
                   const float* __restrict__ partial, T* __restrict__ out, int d, int n_edges) {
  const int ch = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, n_edges, cs, ce)) return;
  const int row = receivers[cs];
  if (!kan::ends_heavy<kPiece>(cs, row, n_edges, row_ptr, e0, e1)) return;
  const float scale = dinv[row];
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    // 8 loads in flight through the read-only path: the adds keep the order
#pragma unroll 8
    for (int k = slot.first; k <= ch; ++k) s += __ldg(partial + slot(k) * d + c);
    out[(size_t)row * d + c] = kan::from_f<T>((s + to_f(hs[(size_t)row * d + c])) * scale);
  }
}

template <typename T, int V, int L>
int launch(const T* hs, const float* dinv, const int* senders, const int* receivers,
           const int* row_ptr, T* out, float* partial, int n_rows, int d, int n_edges,
           cudaStream_t stream) {
  using C = Cfg<T, V, L>;
  const int chunks = (n_edges + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int rows_per_block = kWarps * C::R;
  const int blocks = chunk_blocks + (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0)
    gcn_rows_kernel<T, V, L><<<blocks, kWarps * 32, 0, stream>>>(
        hs, dinv, senders, receivers, row_ptr, out, partial, n_rows, d, n_edges, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0)
    gcn_combine_kernel<T><<<chunk_blocks, kWarps * 32, 0, stream>>>(hs, dinv, receivers, row_ptr,
                                                                    partial, out, d, n_edges);
  return (int)cudaGetLastError();
}

// V columns a lane: 16 bytes when every row is 16-byte aligned and d fills
// whole packs, else one value; L the lanes a row needs, 8 to 32.
template <typename T>
int dispatch(const void* hs, const float* dinv, const int* senders, const int* receivers,
             const int* row_ptr, void* out, float* partial, int n_rows, int d, int n_edges,
             cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* h = static_cast<const T*>(hs);
  T* o = static_cast<T*>(out);
  const bool wide = d % V == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!wide)
    return launch<T, 1, 32>(h, dinv, senders, receivers, row_ptr, o, partial, n_rows, d,
                            n_edges, stream);
  const int packs = d / V;
  if (packs <= 8)
    return launch<T, V, 8>(h, dinv, senders, receivers, row_ptr, o, partial, n_rows, d,
                           n_edges, stream);
  if (packs <= 16)
    return launch<T, V, 16>(h, dinv, senders, receivers, row_ptr, o, partial, n_rows, d,
                            n_edges, stream);
  return launch<T, V, 32>(h, dinv, senders, receivers, row_ptr, o, partial, n_rows, d, n_edges,
                          stream);
}

}  // namespace

// out (n, d) from hs (n, d) f32/bf16, dinv (n,) f32, senders (E,) int32 in
// receiver-sorted order, receivers (E,) int32 ascending (the row of each
// edge), and the receiver CSR row_ptr (n+1,) int32 with row_ptr[n] == E.
// partial: f32 scratch of 2 * ceil(E / 64) * d floats.
extern "C" int gcn_agg_fwd(const void* hs, const float* dinv, const int* senders,
                           const int* receivers, const int* row_ptr, void* out, float* partial,
                           int n_rows, int d, int n_edges, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return dispatch<float>(hs, dinv, senders, receivers, row_ptr, out, partial, n_rows, d,
                           n_edges, s);
  if (dtype == kan::kBF16)
    return dispatch<__nv_bfloat16>(hs, dinv, senders, receivers, row_ptr, out, partial, n_rows,
                                   d, n_edges, s);
  return (int)cudaErrorInvalidValue;
}
