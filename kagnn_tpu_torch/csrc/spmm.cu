// Row-sorted CSR segment sum for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/spmm.py::_kernel (sorted_segment_sum):
//   out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} msgs[idx[e] if idx else e]
// with an f32 sum and the output in the messages' dtype.
//
// Bound on the H100: device-memory bytes. Every edge reads one message row
// of D values (and one index); there is almost no arithmetic. The TPU
// kernel's one-hot MXU products, hi/lo bf16 splits and 128-lane padding
// were TPU workarounds and are gone. Design: one warp per output row, the
// f32 sum in registers, edges walked in order, so the result is
// deterministic and needs no atomics. The optional gather index lets the
// GIN backward read dz[receivers_by_sender[e]] inside the kernel, so the
// (E, D) cotangent tensor never reaches device memory. The row walk is
// kan::csr_row_sum (kan_common.cuh), shared with the other CSR kernels.

#include "kan_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps (rows) per block
using kan::kCpl;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(const T* __restrict__ msgs, const int* __restrict__ row_ptr,
                const int* __restrict__ idx, T* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * kCpl) {
    float acc[kCpl];
    kan::csr_row_sum(msgs, idx, e0, e1, c0, lane, d, acc);
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) out[(size_t)row * d + c] = kan::from_f<T>(acc[j]);
    }
  }
}

template <typename T>
int launch(const void* msgs, const int* row_ptr, const int* idx, void* out,
           int n_rows, int d, cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0)
    spmm_csr_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(msgs), row_ptr, idx, static_cast<T*>(out), n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spmm_csr(const void* msgs, const int* row_ptr, const int* idx,
                        void* out, int n_rows, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32) return launch<float>(msgs, row_ptr, idx, out, n_rows, d, s);
  if (dtype == kan::kBF16) return launch<__nv_bfloat16>(msgs, row_ptr, idx, out, n_rows, d, s);
  return (int)cudaErrorInvalidValue;
}
