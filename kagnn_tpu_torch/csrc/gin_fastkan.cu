// Fused GIN aggregate + FastKANLayer forward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gin_fastkan.py::_kernel:
//   z   = (1 + eps) * x + sum_{e in [row_ptr[r], row_ptr[r+1])} x[senders[e]]
//   out = FastKANLayer(z)   (LayerNorm, RBF basis, spline GEMM, SiLU GEMM, bias)
// emitting out and the residual z (in x's dtype) for the backward, which is
// the FastKANLayer backward kernel (fastkan_layer.cu) on z and the segment
// sum (spmm.cu) for A^T dz.
//
// Bound on the H100: device-memory bytes. The aggregate reads one sender
// row per edge (E*D values, about 7 edges per node at the main path's
// shapes) and the layer's products are below the tensor-core ridge (see
// fastkan_layer.cu). Design: a block owns a tile of 32 receiver rows; its
// warps gather x[senders[e]] over the tile's CSR rows straight into an f32
// sum, so no (E, D) message tensor exists, add (1+eps)*x, write z, keep the
// f32 z in shared memory and run the whole layer on it (forward_tile of
// fastkan_common.cuh, shared with fastkan_layer.cu). As in the JAX kernel
// the layer runs on the unrounded f32 z while the stored z is rounded to
// x's dtype (the backward rebuilds from the stored z), and there is no
// edge-mask multiply: padded edges point at the masked last row, whose
// output every consumer masks. Where the f32 z tile (32 x D) does not fit in
// shared memory beside the basis chunk (wide inputs: D in the thousands),
// it lives in a device scratch `zbuf` (n_pad x D) instead; the blocks of a
// tile's output columns write the same values there. Any number of centers
// 2-32 (one library each, FKAN_G).

#include "fastkan_common.cuh"

namespace {

using namespace fkan;

using kan::kCpl;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gin_fastkan_kernel(const T* __restrict__ x, const int* __restrict__ senders,
                   const int* __restrict__ row_ptr, const T* __restrict__ lng,
                   const T* __restrict__ lnb, const T* __restrict__ w,
                   const T* __restrict__ wb, const T* __restrict__ bb, T* __restrict__ out,
                   T* __restrict__ z, float* __restrict__ zbuf, int n, int D, int O, float eps,
                   Centers cs, float inv_h) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  float* A_s = smem;  // kFwdRows x AC
  float* mu_s = A_s + (size_t)kFwdRows * Shape<G>::AC;
  float* rstd_s = mu_s + kFwdRows;
  // kFwdRows x D, f32 z: in shared memory, or the tile's rows of zbuf
  float* z_s = zbuf != nullptr ? zbuf + (size_t)row0 * D : rstd_s + kFwdRows;
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
  // forward_tile synchronises before it reads z_s
  auto zv = [&](int rr, int d) { return z_s[(size_t)rr * D + d]; };
  forward_tile<T, G>(zv, A_s, mu_s, rstd_s, row0, n, D, O, lng, lnb, cs, inv_h, w, wb, bb, out);
}

template <typename T, int G>
int launch(const void* x, const int* senders, const int* row_ptr, const void* lng,
           const void* lnb, const void* w, const void* wb, const void* bb, void* out, void* z,
           float* zbuf, int n, int D, int O, float eps, Centers cs, float inv_h,
           cudaStream_t stream) {
  const size_t smem = forward_smem<G>(D, zbuf == nullptr);
  if (smem > kan::kSmemLimit) return (int)cudaErrorInvalidValue;
  if (int e = (int)cudaFuncSetAttribute(gin_fastkan_kernel<T, G>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem))
    return e;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  if (grid.x > 0)
    gin_fastkan_kernel<T, G><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), senders, row_ptr, static_cast<const T*>(lng),
        static_cast<const T*>(lnb), static_cast<const T*>(w), static_cast<const T*>(wb),
        static_cast<const T*>(bb), static_cast<T*>(out), static_cast<T*>(z), zbuf, n, D, O, eps,
        cs, inv_h);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, O) and z (n, D) from x (n, D) over the receiver CSR (row_ptr of
// n+1 entries, senders in receiver-sorted edge order). lng, lnb (D,),
// w (G*D, O) g-major, wb (D, O), bb (O,), all of x's dtype; centers: G
// floats in host memory. zbuf: null, or f32 scratch of ceil(n / 32) * 32 x D
// for wide inputs.
extern "C" int gin_fastkan_fwd(const void* x, const int* senders, const int* row_ptr,
                               const void* lng, const void* lnb, const void* w, const void* wb,
                               const void* bb, void* out, void* z, float* zbuf, int n, int d,
                               int o, float eps, int G, const float* centers, float inv_h,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Centers cs{};
  for (int g = 0; g < G && g < kMaxG; ++g) cs.c[g] = centers[g];
  FASTKAN_DISPATCH(dtype, G, launch, x, senders, row_ptr, lng, lnb, w, wb, bb, out, z, zbuf, n,
                   d, o, eps, cs, inv_h, s);
}
