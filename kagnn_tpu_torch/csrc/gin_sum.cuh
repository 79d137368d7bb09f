// Pass 1 of the fused GIN forwards (gin_fused.cu, gin_fastkan.cu): the GIN
// aggregate over the receiver CSR,
//   z = (1 + eps) * x + sum_{e in [row_ptr[r], row_ptr[r+1])} tab[senders[e]],
// where the gathered table tab is x itself on one card, and under the halo
// partition the rank's extended table [x; halo] of B + D*H rows (senders
// index it; the self term still reads x). The halo plan's padded edges are
// the tail [n_edge, E) of the edge list and point at a valid local row on
// interior shards: the caller's row pointer ends at n_edge (row_ptr[n] is
// the valid edges' count), so the walk never reaches them.
// as kan_common.cuh's split row sum (spmm.cu's design): 16-byte loads in
// 128-byte column slabs, so each slab's gathered table stays in L2; a
// receiver row of more than kPiece edges (the arxiv-sized graph's node 0
// with 2,748 in-edges, the pad row heavy by its padding: there is no edge
// mask) is cut at the kPiece-edge chunks of the edge array into pieces that
// separate warps sum into f32 partials, added in chunk order by the combine.
// Each row's z is written in x's type and, under bf16, unrounded in f32 to
// z32: the JAX kernels run their layer on the f32 z. No atomics:
// deterministic. Each source defines its two kernels on these bodies (the
// kernel names carry the source's prefix, which the profile rows read).
#pragma once

#include "kan_common.cuh"

namespace gin {

using namespace kan;

constexpr int kPiece = 64;  // edges per chunk: rows above it are split

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

// Launch 1 (split_row_sum over the rows of x): a light row's z = sum +
// self * x, in T into z and, when z32 is not null, in f32 into z32.
template <typename T, int V>
__device__ __forceinline__ void sum_body(const T* __restrict__ x, const T* __restrict__ tab,
                                         const int* __restrict__ senders,
                                         const int* __restrict__ row_ptr, T* __restrict__ z,
                                         float* __restrict__ z32, float* __restrict__ partial,
                                         int* __restrict__ first_row, int n, int d, float self,
                                         int chunk_blocks) {
  split_row_sum<T, V, kPiece>(
      tab, row_ptr, senders, partial, first_row, n, d, chunk_blocks,
      [&](int row, int c, const float (&acc)[V]) {
        const size_t at = (size_t)row * d + c;
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
        add_pack<T, V>(__ldg(reinterpret_cast<const Pack<T, V>*>(x + at)), v);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = acc[j] + self * v[j];
        if (z32 != nullptr) store_f32<V>(z32 + at, v);
        store_pack<T, V>(z + at, v);
      });
}

// Launch 2 (split_row_combine): a heavy row's pieces added in chunk order,
// then self * x, stored as sum_body stores.
template <typename T>
__device__ __forceinline__ void combine_body(const T* __restrict__ x,
                                             const int* __restrict__ row_ptr,
                                             const float* __restrict__ partial,
                                             const int* __restrict__ first_row,
                                             T* __restrict__ z, float* __restrict__ z32, int n,
                                             int d, float self) {
  split_row_combine<kPiece>(row_ptr, partial, first_row, n, d, [&](int row, int c, float s) {
    const size_t at = (size_t)row * d + c;
    const float v = s + self * to_f(x[at]);
    if (z32 != nullptr) z32[at] = v;
    z[at] = from_f<T>(v);
  });
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Both launches (tab: the gathered table, x where there is no halo):
// sum_of(std::integral_constant<int, V>) gives the kernel of
// sum_body<T, V> (V columns a lane where every row is 16-byte aligned and D
// fills whole packs, else one value), combine the kernel of
// combine_body<T>. Scratch: partial, f32 of 2 * ceil(max_edges / kPiece) *
// D floats; first_row, int32 of ceil(max_edges / kPiece); max_edges at
// least row_ptr[n], read on the host so that nothing waits for the device.
template <typename T, typename SumOf, typename Combine>
int launch_sum(SumOf sum_of, Combine combine, const T* x, const T* tab, const int* senders,
               const int* row_ptr, T* z, float* z32, float* partial, int* first_row, int n,
               int D, float self, int max_edges, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool wide = D % VW == 0 && aligned16(x) && aligned16(tab) && aligned16(z) &&
                    (z32 == nullptr || aligned16(z32));
  const int chunk_blocks = split_chunk_blocks<kPiece>(max_edges);
  auto go = [&](auto v) {
    const dim3 grid = split_grid<decltype(v)::value>(chunk_blocks, n, D);
    if (grid.x > 0 && D > 0)
      sum_of(v)<<<grid, kSplitWarps * 32, 0, stream>>>(x, tab, senders, row_ptr, z, z32,
                                                        partial, first_row, n, D, self,
                                                        chunk_blocks);
    if (int e = (int)cudaGetLastError()) return e;
    if (chunk_blocks > 0 && D > 0)
      combine<<<dim3(chunk_blocks, combine_parts(D)), kSplitWarps * 32, 0, stream>>>(
          x, row_ptr, partial, first_row, z, z32, n, D, self);
    return (int)cudaGetLastError();
  };
  return wide ? go(std::integral_constant<int, VW>{}) : go(std::integral_constant<int, 1>{});
}

}  // namespace gin
