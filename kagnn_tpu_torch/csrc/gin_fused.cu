// Fused GIN aggregate + B-spline KANLinear forward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gin_fused.py::_kernel:
//   z   = (1 + eps) * x + sum_{e in [row_ptr[r], row_ptr[r+1])} x[senders[e]]
//   out = KANLinear(z)
// emitting out and the residual z (in x's dtype) for the backward.
//
// Bound on the H100: device-memory bytes. The aggregate reads one sender
// row per edge (E*D values, about 7 edges per node at the main path's
// shapes) and the epilogue's products are below the tensor-core ridge (see
// bspline_fused.cu). Design: a block owns a tile of 32 receiver rows; its
// warps gather x[senders[e]] over the tile's CSR rows straight into an f32
// sum, so no (E, D) message tensor exists, add (1+eps)*x, write z, keep the
// f32 z in shared memory and run the KANLinear epilogue of bspline_fused on
// it. As in the JAX kernel, the ladder runs on the unrounded f32 z while the
// stored z is rounded to x's dtype (the backward rebuilds from the stored z),
// and there is no edge-mask multiply: padded edges point at the masked last
// row, whose output every consumer masks. Where the f32 z tile (32 x D) and
// the basis chunk do not fit in shared memory (wide inputs: D in the
// thousands), the tile's f32 z lives in a device scratch `zbuf` (n_pad x D,
// L2-resident while the block runs) instead; the blocks of a tile's output
// columns write the same values there.
//
// Shapes: one library per (spline order, grid size), as bspline_fused.cu.

#include "kan_common.cuh"

namespace {

using namespace kan;

using kan::kCpl;

template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
gin_fwd_kernel(const T* __restrict__ x, const int* __restrict__ senders,
               const int* __restrict__ row_ptr, const T* __restrict__ knots,
               const T* __restrict__ wb, const T* __restrict__ ws, T* __restrict__ out,
               T* __restrict__ z, float* __restrict__ zbuf, int n, int D, int O, float eps) {
  using S = Shape<ORDER, GRID>;
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  float* A_s = smem;  // kFwdRows x AC
  // kFwdRows x D, f32 z: in shared memory, or the tile's rows of zbuf
  float* z_s = zbuf != nullptr ? zbuf + (size_t)row0 * D : smem + kFwdRows * S::AC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float self = 1.f + eps;

  for (int rr = warp; rr < kFwdRows; rr += kThreads / 32) {
    const int row = row0 + rr;
    if (row >= n) {
      for (int c = lane; c < D; c += 32) z_s[rr * D + c] = 0.f;
      continue;
    }
    const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
    for (int c0 = 0; c0 < D; c0 += 32 * kCpl) {
      float acc[kCpl];
      kan::csr_row_sum(x, senders, e0, e1, c0, lane, D, acc);
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c >= D) continue;
        const float zf = acc[j] + self * to_f(x[(size_t)row * D + c]);
        z_s[rr * D + c] = zf;
        if (blockIdx.y == 0) z[(size_t)row * D + c] = from_f<T>(zf);
      }
    }
  }
  // kan_forward_tile synchronises before it reads z_s
  auto load = [&](int rr, int, int d) { return z_s[rr * D + d]; };
  kan_forward_tile<T, ORDER, GRID>(load, A_s, row0, n, D, O, knots, wb, ws, out);
}

template <typename T, int ORDER, int GRID>
int launch(const void* x, const int* senders, const int* row_ptr, const void* knots,
           const void* wb, const void* ws, void* out, void* z, float* zbuf, int n, int D, int O,
           float eps, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  const size_t smem = sizeof(float) * kFwdRows * ((size_t)S::AC + (zbuf ? 0 : D));
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (int e = (int)cudaFuncSetAttribute(gin_fwd_kernel<T, ORDER, GRID>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem))
    return e;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  if (grid.x > 0)
    gin_fwd_kernel<T, ORDER, GRID><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), senders, row_ptr, static_cast<const T*>(knots),
        static_cast<const T*>(wb), static_cast<const T*>(ws), static_cast<T*>(out),
        static_cast<T*>(z), zbuf, n, D, O, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, O) and z (n, D) from x (n, D) over the receiver CSR (row_ptr of
// n+1 entries, senders in receiver-sorted edge order). knots (K, D),
// wb (D, O), ws (NB*D, O), all of x's dtype. zbuf: null, or f32 scratch of
// ceil(n / 32) * 32 x D for wide inputs.
extern "C" int gin_fwd(const void* x, const int* senders, const int* row_ptr,
                       const void* knots, const void* wb, const void* ws, void* out, void* z,
                       float* zbuf, int n, int d, int o, float eps, int grid, int order,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch, x, senders, row_ptr, knots, wb, ws, out, z, zbuf, n,
               d, o, eps, s);
}
