// Narrow receiver-sorted segment sum for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/spmm.py::_narrow_kernel
// (sorted_segment_sum_narrow):
//   out[r, j] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[e, j],   j < K <= 8
// with an f32 sum and the output in the values' type.
//
// Bound on the H100: device-memory bytes. Each edge brings K values (16 B
// at K = 4 in f32) and is added once. The TPU kernel's transposed (8, E)
// layout, one-hot MXU products and hi/lo bf16 split were TPU workarounds
// and are gone. Design: K <= 8 columns would leave a warp-per-row kernel
// that splits columns over lanes (spmm.cu) mostly idle, and a long row
// would be walked by one lane. Here the 32 lanes of a warp split the row's
// edges instead: lane l sums edges e0 + l, e0 + l + 32, ... in order, so
// neighbouring lanes read neighbouring rows of vals and node 0's 2,748
// in-edges of the arxiv-sized graph take 86 steps a lane. The lanes' sums
// then combine in a fixed tree of shuffles (offsets 16, 8, 4, 2, 1), so the
// result is deterministic without atomics. Rows with no edge give 0.

#include "kan_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps (rows) per block

template <typename T, int K>
__global__ void __launch_bounds__(kWarps * 32)
narrow_kernel(const T* __restrict__ vals, const int* __restrict__ row_ptr, T* __restrict__ out,
              int n_rows) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp: one row per warp
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int e = e0 + lane; e < e1; e += 32) {
    const T* v = vals + (size_t)e * K;
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += kan::to_f(v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) out[(size_t)row * K + j] = kan::from_f<T>(acc[j]);
  }
}

template <typename T, int K>
int launch(const void* vals, const int* row_ptr, void* out, int n_rows, cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0)
    narrow_kernel<T, K><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(vals), row_ptr, static_cast<T*>(out), n_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(const void* vals, const int* row_ptr, void* out, int n_rows, int k,
               cudaStream_t s) {
  switch (k) {
    case 1: return launch<T, 1>(vals, row_ptr, out, n_rows, s);
    case 2: return launch<T, 2>(vals, row_ptr, out, n_rows, s);
    case 3: return launch<T, 3>(vals, row_ptr, out, n_rows, s);
    case 4: return launch<T, 4>(vals, row_ptr, out, n_rows, s);
    case 5: return launch<T, 5>(vals, row_ptr, out, n_rows, s);
    case 6: return launch<T, 6>(vals, row_ptr, out, n_rows, s);
    case 7: return launch<T, 7>(vals, row_ptr, out, n_rows, s);
    case 8: return launch<T, 8>(vals, row_ptr, out, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out (n_rows, k) = the segment sums of vals (E, k) over row_ptr (n_rows+1,)
// int32; k in 1..8; device memory, contiguous.
extern "C" int spmm_narrow(const void* vals, const int* row_ptr, void* out, int n_rows, int k,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32) return dispatch_k<float>(vals, row_ptr, out, n_rows, k, s);
  if (dtype == kan::kBF16) return dispatch_k<__nv_bfloat16>(vals, row_ptr, out, n_rows, k, s);
  return (int)cudaErrorInvalidValue;
}
