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
//   * rows split into pieces (kan_common.cuh's split row sum, shared with
//     gin_fused.cu): the edge array is cut into chunks of kPiece edges. A
//     row of at most kPiece edges is summed whole by one lane group in edge
//     order (launch 1, row part: the result of the first version,
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

constexpr int kPiece = 64;  // edges per chunk: rows above it are split

// Launch 1 (kan_common.cuh split_row_sum): a light row's sums cast to T.
template <typename T, int V>
__global__ void __launch_bounds__(kan::kSplitWarps * 32)
spmm_csr_kernel(const T* __restrict__ msgs, const int* __restrict__ row_ptr,
                const int* __restrict__ idx, T* __restrict__ out, float* __restrict__ partial,
                int* __restrict__ first_row, int n_rows, int d, int chunk_blocks) {
  kan::split_row_sum<T, V, kPiece>(msgs, row_ptr, idx, partial, first_row, n_rows, d,
                                   chunk_blocks, [&](int row, int c, const float (&acc)[V]) {
                                     kan::store_pack<T, V>(out + (size_t)row * d + c, acc);
                                   });
}

// Launch 2 (kan_common.cuh split_row_combine): a heavy row's pieces added in
// chunk order, cast to T.
template <typename T>
__global__ void __launch_bounds__(kan::kSplitWarps * 32)
spmm_csr_combine_kernel(const int* __restrict__ row_ptr, const float* __restrict__ partial,
                        const int* __restrict__ first_row, T* __restrict__ out, int n_rows,
                        int d) {
  kan::split_row_combine<kPiece>(row_ptr, partial, first_row, n_rows, d,
                                 [&](int row, int c, float s) {
                                   out[(size_t)row * d + c] = kan::from_f<T>(s);
                                 });
}

template <typename T, int V>
int launch(const T* msgs, const int* row_ptr, const int* idx, T* out, float* partial,
           int* first_row, int n_rows, int d, int max_edges, cudaStream_t stream) {
  const int chunk_blocks = kan::split_chunk_blocks<kPiece>(max_edges);
  const dim3 grid = kan::split_grid<V>(chunk_blocks, n_rows, d);
  if (grid.x > 0 && d > 0)
    spmm_csr_kernel<T, V><<<grid, kan::kSplitWarps * 32, 0, stream>>>(
        msgs, row_ptr, idx, out, partial, first_row, n_rows, d, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0 && d > 0)
    spmm_csr_combine_kernel<T><<<dim3(chunk_blocks, kan::combine_parts(d)),
                                 kan::kSplitWarps * 32, 0, stream>>>(row_ptr, partial,
                                                                     first_row, out, n_rows, d);
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
