// Narrow receiver-sorted segment sum for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/spmm.py::_narrow_kernel
// (sorted_segment_sum_narrow):
//   out[r, j] = sum_{e : receivers[e] == r} vals[e, j],   r < n_rows, j < K <= 8
// over ascending receivers, with an f32 sum and the output in the values'
// type; receivers outside [0, n_rows) are dropped.
//
// Bound on the H100: device-memory bytes. Each edge brings K values (16 B at
// K = 4 in f32, 8 B in bf16) and its receiver, and is added once. The TPU
// kernel's transposed (8, E) layout, one-hot MXU products and hi/lo bf16
// split were TPU workarounds and are gone.
//
// What held the first version back (one warp a row, its lanes striding over
// the row's edges, the row pointer from torch.searchsorted): an arxiv-sized
// row averages 6.9 edges, so about 25 of a warp's 32 lanes had nothing to
// do and each lane had one 16-byte load in flight, while node 0's 2,748
// edges took 86 serial steps a lane; and the wrapper rebuilt the row
// pointer by a binary search of the 169,345 rows over 1,166,336 receivers
// at every call. This design, three launches, no atomics, deterministic:
//   1. narrow_row_ptr_kernel: the row pointer in one coalesced pass, one
//      thread an edge (and one past the last): thread t writes row_ptr[r] =
//      t for every r in (receivers[t-1], receivers[t]], receivers[-1] = -1
//      and receivers[E] = n_rows standing for the ends, so receivers past
//      n_rows fall past the last row (a long run of such rows is written by
//      the thread's whole block). It is torch.searchsorted(receivers,
//      arange(n_rows + 1)) exactly, empty rows included, in O(E + rows).
//   2. narrow_sum_kernel: a row of at most kPiece edges is summed by one
//      thread in edge order, with loads of up to 16 bytes (K values an
//      edge in one or two loads where the row's bytes allow) and 4 edges in
//      flight, so a warp has 32 rows going at once. A heavier row is cut at
//      the kPiece-edge chunks of the edge array (kan_common.cuh's piece
//      schedule, as spmm, gcn_agg and the GIN aggregates cut theirs): one
//      warp a chunk sums the heavy rows' edges inside it, its lanes meeting
//      in a fixed shuffle tree, into f32 partials (two slots a chunk). The
//      chunk's rows are its first and last edges' receivers: no search.
//   3. narrow_combine_kernel: one warp a chunk adds, for the heavy row
//      that ends in the chunk, its pieces (its lanes over the pieces, then
//      a fixed shuffle tree).
// spmm_narrow runs all three; spmm_narrow_row_ptr the first alone.

#include "kan_common.cuh"

namespace {

constexpr int kPiece = 64;     // edges per chunk: rows above it are split
constexpr int kThreads = 256;  // threads a block of every launch
constexpr int kWarps = kThreads / 32;

// Launch 1: row_ptr (n_rows + 1,) from the ascending receivers (E,). A
// thread writes the rows its edge opens itself up to kShortGap of them; a
// longer run (empty rows, or the rows past the last receiver: a single
// thread took 0.65 ms over the 166,600 rows left after a hub row's edges
// alone on the H100) is written by the whole block, one run after another.
constexpr int kShortGap = 8;

__global__ void __launch_bounds__(kThreads)
narrow_row_ptr_kernel(const int* __restrict__ receivers, int* __restrict__ row_ptr, int n_edges,
                      int n_rows) {
  __shared__ int run_lo[kThreads], run_len[kThreads];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int lo = 0, len = 0;  // this thread's rows: [lo, lo + len)
  if (t <= n_edges) {
    const int prev = t == 0 ? -1 : __ldg(receivers + t - 1);
    if (prev < n_rows) {  // else every row up to n_rows is an earlier edge's
      const int cur = t == n_edges ? n_rows : min(__ldg(receivers + t), n_rows);
      lo = max(prev + 1, 0);
      len = max(cur - lo + 1, 0);
    }
  }
  const bool long_run = len > kShortGap;
  if (!long_run)
    for (int r = lo; r < lo + len; ++r) row_ptr[r] = t;
  if (!__syncthreads_or(long_run)) return;
  run_lo[threadIdx.x] = lo;
  run_len[threadIdx.x] = long_run ? len : 0;
  __syncthreads();
  for (int j = 0; j < kThreads; ++j) {
    const int n = run_len[j], r0 = run_lo[j], tj = blockIdx.x * kThreads + j;
    for (int i = threadIdx.x; i < n; i += kThreads) row_ptr[r0 + i] = tj;
  }
}

// W bytes a load: the largest power of two up to 16 that divides an edge's
// K * sizeof(T) bytes (the wrapper drops to sizeof(T) where vals or out is
// not aligned to it).
template <int W> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

template <typename T, int K, int W>
struct Edge {
  static constexpr int kWords = K * (int)sizeof(T) / W;
  typename Word<W>::type w[kWords];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    const auto* src = reinterpret_cast<const typename Word<W>::type*>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(src + i);
  }
  __device__ __forceinline__ void add_to(float (&acc)[K]) const {
    const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += kan::to_f(v[j]);
  }
};

template <typename T, int K, int W>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&acc)[K]) {
  Edge<T, K, W> e;
  T* v = reinterpret_cast<T*>(e.w);
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = kan::from_f<T>(acc[j]);
  auto* dst = reinterpret_cast<typename Word<W>::type*>(p);
#pragma unroll
  for (int i = 0; i < Edge<T, K, W>::kWords; ++i) dst[i] = e.w[i];
}

// Launch 2. Blocks [0, chunk_blocks): one warp a chunk, the heavy rows'
// pieces into partial (2 slots of K floats a chunk) and each chunk's first
// receiver into first_row; the rest: one thread a light row.
template <typename T, int K, int W>
__global__ void __launch_bounds__(kThreads)
narrow_sum_kernel(const T* __restrict__ vals, const int* __restrict__ receivers,
                  const int* __restrict__ row_ptr, T* __restrict__ out,
                  float* __restrict__ partial, int* __restrict__ first_row, int n_rows,
                  int chunk_blocks) {
  const int end = __ldg(row_ptr + n_rows);  // the edges of rows below n_rows
  if ((int)blockIdx.x < chunk_blocks) {
    const int ch = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    int cs, ce;
    if (!kan::chunk_edges<kPiece>(ch, end, cs, ce)) return;
    // a negative receiver belongs to no row: such a chunk head is no slot-0
    // row (the first row then starts inside the chunk, in slot 1)
    const int first = __ldg(receivers + cs), last = __ldg(receivers + ce - 1);
    if (lane == 0) first_row[ch] = first;
#pragma unroll 1
    for (int slot = 0; slot < 2; ++slot) {
      kan::Piece p;
      if ((slot == 0 ? first : last) < 0 ||
          !kan::chunk_piece<kPiece>(slot, cs, ce, first, last, end, row_ptr, p))
        continue;
      float acc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] = 0.f;
      for (int e = p.lo + lane; e < p.hi; e += 32) {
        Edge<T, K, W> v;
        v.load(vals + (size_t)e * K);
        v.add_to(acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) partial[((size_t)ch * 2 + slot) * K + j] = acc[j];
      }
    }
    return;
  }
  const int row = (blockIdx.x - chunk_blocks) * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const int e0 = __ldg(row_ptr + row), e1 = __ldg(row_ptr + row + 1);
  if (e1 - e0 > kPiece) return;  // a heavy row: launch 3 writes it
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  int e = e0;
  for (; e + 4 <= e1; e += 4) {  // 4 edges in flight, added in edge order
    Edge<T, K, W> v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u].load(vals + (size_t)(e + u) * K);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u].add_to(acc);
  }
  for (; e < e1; ++e) {
    Edge<T, K, W> v;
    v.load(vals + (size_t)e * K);
    v.add_to(acc);
  }
  store_row<T, K, W>(out + (size_t)row * K, acc);
}

// Launch 3, one warp a chunk: the heavy row that holds the chunk's first
// edge and ends inside it has all its pieces written; its lanes take the
// pieces lane, lane + 32, ... in chunk order and meet in a fixed shuffle
// tree (one thread walking node 0's 43 pieces took 0.010 ms on the H100).
template <typename T, int K, int W>
__global__ void __launch_bounds__(kThreads)
narrow_combine_kernel(const int* __restrict__ row_ptr, const float* __restrict__ partial,
                      const int* __restrict__ first_row, T* __restrict__ out, int n_rows) {
  const int ch = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int end = __ldg(row_ptr + n_rows);
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, end, cs, ce)) return;
  const int row = first_row[ch];
  if (row < 0 || !kan::ends_heavy<kPiece>(cs, row, end, row_ptr, e0, e1)) return;
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  for (int k = slot.first + lane; k <= ch; k += 32) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += __ldg(partial + slot(k) * K + j);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lane == 0) store_row<T, K, W>(out + (size_t)row * K, acc);
}

int launch_row_ptr(const int* receivers, int* row_ptr, int n_edges, int n_rows,
                   cudaStream_t stream) {
  narrow_row_ptr_kernel<<<n_edges / kThreads + 1, kThreads, 0, stream>>>(receivers, row_ptr,
                                                                         n_edges, n_rows);
  return (int)cudaGetLastError();
}

template <typename T, int K, int W>
int launch(const void* vals, const int* receivers, const int* row_ptr, void* out,
           float* partial, int* first_row, int n_edges, int n_rows, cudaStream_t stream) {
  const int chunks = (n_edges + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int row_blocks = (n_rows + kThreads - 1) / kThreads;
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  if (row_blocks > 0)
    narrow_sum_kernel<T, K, W><<<chunk_blocks + row_blocks, kThreads, 0, stream>>>(
        v, receivers, row_ptr, o, partial, first_row, n_rows, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunks > 0 && n_rows > 0)
    narrow_combine_kernel<T, K, W><<<chunk_blocks, kThreads, 0, stream>>>(row_ptr, partial,
                                                                         first_row, o, n_rows);
  return (int)cudaGetLastError();
}

// The widest load that divides an edge's bytes, where vals and out allow it.
template <typename T, int K>
int dispatch_w(const void* vals, const int* receivers, const int* row_ptr, void* out,
               float* partial, int* first_row, int n_edges, int n_rows, cudaStream_t s) {
  constexpr int B = K * (int)sizeof(T);
  constexpr int W = B % 16 == 0 ? 16 : B % 8 == 0 ? 8 : B % 4 == 0 ? 4 : 2;
  const bool aligned = reinterpret_cast<uintptr_t>(vals) % W == 0 &&
                       reinterpret_cast<uintptr_t>(out) % W == 0;
  if (aligned)
    return launch<T, K, W>(vals, receivers, row_ptr, out, partial, first_row, n_edges, n_rows, s);
  return launch<T, K, (int)sizeof(T)>(vals, receivers, row_ptr, out, partial, first_row,
                                      n_edges, n_rows, s);
}

template <typename T>
int dispatch_k(const void* vals, const int* receivers, const int* row_ptr, void* out,
               float* partial, int* first_row, int n_edges, int n_rows, int k, cudaStream_t s) {
#define NARROW_K(KK)                                                                       \
  case KK:                                                                                 \
    return dispatch_w<T, KK>(vals, receivers, row_ptr, out, partial, first_row, n_edges, \
                             n_rows, s);
  switch (k) {
    NARROW_K(1) NARROW_K(2) NARROW_K(3) NARROW_K(4) NARROW_K(5) NARROW_K(6) NARROW_K(7)
    NARROW_K(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NARROW_K
}

}  // namespace

// row_ptr (n_rows + 1,) int32 of the ascending receivers (n_edges,) int32:
// row_ptr[r] = the first edge whose receiver is r or more (n_edges if none).
extern "C" int spmm_narrow_row_ptr(const int* receivers, int* row_ptr, int n_edges, int n_rows,
                                   void* stream) {
  return launch_row_ptr(receivers, row_ptr, n_edges, n_rows, static_cast<cudaStream_t>(stream));
}

// out (n_rows, k) = the segment sums of vals (n_edges, k) over the ascending
// receivers (n_edges,) int32, k in 1..8, all three launches; device memory,
// contiguous. Scratch: row_ptr, int32 of n_rows + 1 (written here);
// first_row, int32 of ceil(n_edges / 64); partial, f32 of 2 * ceil(n_edges /
// 64) * k floats.
extern "C" int spmm_narrow(const void* vals, const int* receivers, int* row_ptr, void* out,
                           float* partial, int* first_row, int n_edges, int n_rows, int k,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kan::kF32 && dtype != kan::kBF16) return (int)cudaErrorInvalidValue;
  if (int e = launch_row_ptr(receivers, row_ptr, n_edges, n_rows, s)) return e;
  if (dtype == kan::kF32)
    return dispatch_k<float>(vals, receivers, row_ptr, out, partial, first_row, n_edges, n_rows,
                             k, s);
  return dispatch_k<__nv_bfloat16>(vals, receivers, row_ptr, out, partial, first_row, n_edges,
                                   n_rows, k, s);
}
