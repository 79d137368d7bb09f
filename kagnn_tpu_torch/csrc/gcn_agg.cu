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
// 128-lane padding were TPU workarounds and are gone. Design: spmm.cu's
// kernel with the self term and the scale added. One warp per output row
// walks the row's receiver-CSR edges in order (kan::csr_row_sum of
// kan_common.cuh) and gathers hs[senders[e]] straight into f32 registers, so
// no (E, D) message tensor reaches device memory and the result is
// deterministic without atomics. Padded edges point at the masked last row and are not masked, as in
// the JAX kernel. The backward needs no kernel of its own: it is the segment
// sum of spmm.cu over the sender CSR (kernels/gcn_agg.py).

#include "kan_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps (rows) per block
using kan::kCpl;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gcn_agg_kernel(const T* __restrict__ hs, const float* __restrict__ dinv,
               const int* __restrict__ senders, const int* __restrict__ row_ptr,
               T* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  const float scale = dinv[row];
  for (int c0 = 0; c0 < d; c0 += 32 * kCpl) {
    float acc[kCpl];
    kan::csr_row_sum(hs, senders, e0, e1, c0, lane, d, acc);
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) {
        const float self = kan::to_f(hs[(size_t)row * d + c]);
        out[(size_t)row * d + c] = kan::from_f<T>((acc[j] + self) * scale);
      }
    }
  }
}

template <typename T>
int launch(const void* hs, const float* dinv, const int* senders, const int* row_ptr, void* out,
           int n_rows, int d, cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0)
    gcn_agg_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(hs), dinv, senders, row_ptr, static_cast<T*>(out), n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, d) from hs (n, d) f32/bf16, dinv (n,) f32, senders (E,) int32 in
// receiver-sorted order and the receiver CSR row_ptr (n+1,) int32.
extern "C" int gcn_agg_fwd(const void* hs, const float* dinv, const int* senders,
                           const int* row_ptr, void* out, int n_rows, int d, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return launch<float>(hs, dinv, senders, row_ptr, out, n_rows, d, s);
  if (dtype == kan::kBF16)
    return launch<__nv_bfloat16>(hs, dinv, senders, row_ptr, out, n_rows, d, s);
  return (int)cudaErrorInvalidValue;
}
