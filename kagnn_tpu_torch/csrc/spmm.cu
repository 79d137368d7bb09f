// Row-sorted CSR segment sum for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/spmm.py::_kernel (sorted_segment_sum):
//   out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} msgs[idx[e] if idx else e]
// with an f32 sum and the output in the messages' dtype.
//
// Bound on the H100: device-memory bytes. Every edge reads one message row
// of D values (and one index); there is almost no arithmetic. The TPU
// kernel's one-hot MXU products, hi/lo bf16 splits and 128-lane padding
// were TPU workarounds and are gone. The optional gather index lets the GIN
// backward read dz[receivers_by_sender[e]] inside the kernel, so the (E, D)
// cotangent tensor never reaches device memory; the gin/fastkan step sums
// its z over the receiver CSR with idx = senders the same way.
//
// What held the first version back (one warp a row, 8-byte lane loads,
// four edges in flight): over the receiver CSR of the arxiv-sized graph
// node 0's 2,748 in-edges kept one warp busy for about 690 rounds of
// dependent gathers after the rest of the card had finished (0.71 ms a
// launch against a bound of about 0.02), and at D = 64 in bf16 half of each
// warp's lanes were idle. This design, gcn_agg.cu's without the self term
// and the scale, in column slabs:
//   * 16-byte loads: a lane loads V = 16 / sizeof(T) columns at once, and a
//     group of 8 lanes covers a slab of 128 bytes of a row (64 bf16 or 32
//     f32 columns); a warp holds 4 groups, each with 4 edges in flight
//     (kan::csr_piece_sum). Where d does not fill whole 16-byte packs a lane
//     loads one value and 32 lanes cover a slab of 32 columns;
//   * column slabs: grid.y walks the slabs, so the blocks of one slab run
//     together and their gathers reuse a table of N x 128 bytes (21.7 MB at
//     the arxiv-sized graph), which stays in L2 where the whole table (43 MB
//     at D 128 in bf16) does not: whole rows at D 128 gathered from device
//     memory took 0.12 ms of light rows against 0.05 at D 64 (H100);
//   * rows split into pieces: the edge array is cut into chunks of kPiece
//     edges. A row of at most kPiece edges is summed whole by one lane group
//     in edge order (launch 1, row part: the result of the first version,
//     bit for bit). A heavier row is summed chunk by chunk: in launch 1 one
//     warp a chunk sums the row's edges inside the chunk, its lane groups
//     splitting them and meeting in a fixed shuffle tree, into an f32
//     partial (two slots a chunk, kan_common.cuh's piece schedule); launch 2
//     adds a heavy row's pieces in chunk order. The wrapper takes no
//     `receivers` (its two CSRs have different row arrays), so a chunk warp
//     finds the rows of its first and last edge by a warp search of row_ptr
//     (kan::row_of_edge) and launch 1 keeps the first one for the combine.
//     No schedule is built on the host, no float atomics: deterministic.
// There is no edge mask: padded edges are summed into the pad row as the
// JAX kernel sums them, and a pad row made heavy by its padding is split
// like any other row.

#include "kan_common.cuh"

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kPiece = 64;  // edges per chunk: rows above it are split

using kan::csr_piece_sum;

// V columns a lane; L lanes a row cover its slab of L * V columns; U edges
// in flight per lane group.
template <int V>
struct Cfg {
  static constexpr int L = V == 1 ? 32 : 8;
  static constexpr int SLAB = L * V;
  static constexpr int R = 32 / L;                  // lane groups per warp
  static constexpr int U = L / 2 > 4 ? L / 2 : 4;   // R * U >= 16 gathers a warp
};

// Launch 1, columns [c0, c0 + SLAB) of slab blockIdx.y. Blocks [0,
// chunk_blocks) sum the heavy rows' pieces, one warp a chunk, and slab 0's
// keep the row of each chunk's first edge in `first_row`; the rest sum the
// light rows whole, one lane group a row.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(const T* __restrict__ msgs, const int* __restrict__ row_ptr,
                const int* __restrict__ idx, T* __restrict__ out, float* __restrict__ partial,
                int* __restrict__ first_row, int n_rows, int d, int chunk_blocks) {
  using C = Cfg<V>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / C::L, gl = lane % C::L;
  const int c = blockIdx.y * C::SLAB + gl * V;  // this lane's columns
  if ((int)blockIdx.x < chunk_blocks) {
    const int ch = blockIdx.x * kWarps + warp;
    const int n_edges = __ldg(row_ptr + n_rows);
    int cs, ce;
    if (!kan::chunk_edges<kPiece>(ch, n_edges, cs, ce)) return;
    const int first = kan::row_of_edge(row_ptr, n_rows, cs);
    const int last = kan::row_of_edge(row_ptr, n_rows, ce - 1);
    if (lane == 0 && blockIdx.y == 0) first_row[ch] = first;
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      kan::Piece p;
      if (!kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edges, row_ptr, p)) continue;
      float acc[V];
      if (c < d) {
        csr_piece_sum<T, V, C::U>(msgs, idx, p.lo + group, p.hi, C::R, c, d, acc);
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
        float* part = partial + ((size_t)ch * 2 + slot) * d;
#pragma unroll
        for (int j = 0; j < V; ++j) part[c + j] = acc[j];
      }
    }
    return;
  }
  const int row = ((blockIdx.x - chunk_blocks) * kWarps + warp) * C::R + group;
  if (row >= n_rows || c >= d) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  if (e1 - e0 > kPiece) return;  // a heavy row: launch 2 writes it
  float acc[V];
  csr_piece_sum<T, V, C::U>(msgs, idx, e0, e1, 1, c, d, acc);
  kan::store_pack<T, V>(out + (size_t)row * d + c, acc);
}

// Launch 2: one warp a chunk. The heavy row holding the chunk's first edge
// and ending inside the chunk has all its pieces written: add them in chunk
// order and cast.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_combine_kernel(const int* __restrict__ row_ptr, const float* __restrict__ partial,
                        const int* __restrict__ first_row, T* __restrict__ out, int n_rows,
                        int d) {
  const int ch = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int n_edges = __ldg(row_ptr + n_rows);
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, n_edges, cs, ce)) return;
  const int row = first_row[ch];
  if (!kan::ends_heavy<kPiece>(cs, row, n_edges, row_ptr, e0, e1)) return;
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    // 8 loads in flight through the read-only path: the adds keep the order
#pragma unroll 8
    for (int k = slot.first; k <= ch; ++k) s += __ldg(partial + slot(k) * d + c);
    out[(size_t)row * d + c] = kan::from_f<T>(s);
  }
}

template <typename T, int V>
int launch(const T* msgs, const int* row_ptr, const int* idx, T* out, float* partial,
           int* first_row, int n_rows, int d, int max_edges, cudaStream_t stream) {
  using C = Cfg<V>;
  const int chunks = (max_edges + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int rows_per_block = kWarps * C::R;
  const dim3 grid(chunk_blocks + (n_rows + rows_per_block - 1) / rows_per_block,
                  (d + C::SLAB - 1) / C::SLAB);
  if (grid.x > 0 && d > 0)
    spmm_csr_kernel<T, V><<<grid, kWarps * 32, 0, stream>>>(msgs, row_ptr, idx, out, partial,
                                                           first_row, n_rows, d, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0 && d > 0)
    spmm_csr_combine_kernel<T><<<chunk_blocks, kWarps * 32, 0, stream>>>(
        row_ptr, partial, first_row, out, n_rows, d);
  return (int)cudaGetLastError();
}

// V columns a lane: 16 bytes when every row is 16-byte aligned and d fills
// whole packs, else one value.
template <typename T>
int dispatch(const void* msgs, const int* row_ptr, const int* idx, void* out, float* partial,
             int* first_row, int n_rows, int d, int max_edges, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* m = static_cast<const T*>(msgs);
  T* o = static_cast<T*>(out);
  const bool wide = d % V == 0 && reinterpret_cast<uintptr_t>(msgs) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!wide)
    return launch<T, 1>(m, row_ptr, idx, o, partial, first_row, n_rows, d, max_edges, stream);
  return launch<T, V>(m, row_ptr, idx, o, partial, first_row, n_rows, d, max_edges, stream);
}

}  // namespace

// out (n_rows, d) from msgs (rows of d values, f32/bf16), the CSR row_ptr
// (n_rows+1,) int32 with row_ptr[0] == 0 and idx (row_ptr[n_rows],) int32
// or null. max_edges: at least row_ptr[n_rows] (the length of idx, or of
// msgs without it), read on the host so that nothing waits for the device;
// chunks past row_ptr[n_rows] do nothing. Scratch: partial, f32 of
// 2 * ceil(max_edges / 64) * d floats; first_row, int32 of ceil(max_edges /
// 64).
extern "C" int spmm_csr(const void* msgs, const int* row_ptr, const int* idx, void* out,
                        float* partial, int* first_row, int n_rows, int d, int max_edges,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return dispatch<float>(msgs, row_ptr, idx, out, partial, first_row, n_rows, d, max_edges,
                           s);
  if (dtype == kan::kBF16)
    return dispatch<__nv_bfloat16>(msgs, row_ptr, idx, out, partial, first_row, n_rows, d,
                                   max_edges, s);
  return (int)cudaErrorInvalidValue;
}
