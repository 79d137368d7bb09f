// Fused GIN aggregate + FastKANLayer forward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gin_fastkan.py::_kernel:
//   z   = (1 + eps) * x + sum_{e in [row_ptr[r], row_ptr[r+1])} x[senders[e]]
//   out = FastKANLayer(z)   (LayerNorm, RBF basis, spline GEMM, SiLU GEMM, bias)
// emitting out and the residual z (in x's dtype) for the backward, which is
// the FastKANLayer backward kernel (fastkan_layer.cu) on z and the segment
// sum (spmm.cu) for A^T dz. As in the JAX kernel the layer runs on the
// unrounded f32 z while the stored z is rounded to x's dtype (the backward
// rebuilds from the stored z), and there is no edge-mask multiply: padded
// edges point at the masked last row, whose output every consumer masks.
//
// Bound on the H100: device-memory bytes. The aggregate reads one sender
// row per edge (E*D values, about 7 edges per node at the main path's
// shapes) and the layer's products are below the tensor-core ridge (see
// fastkan_layer.cu). What held the first version back: one warp walked each
// receiver row, so the arxiv-sized graph's node 0 (2,748 in-edges) finished
// long after the rest of the card, and the layer multiplied on the CUDA
// cores (0.585 ms at (D 64, O 64) in bf16, 0.880 at (128, 64), against
// bounds of 0.021 and 0.034; PERF.md §6). This design is gin_fused.cu's, two
// passes:
//   1. the aggregate (gin_sum.cuh, shared with gin_fused.cu): the split row
//      sum, 16-byte loads in 128-byte column slabs, receiver rows of more
//      than 64 edges cut into pieces at the 64-edge chunks of the edge array
//      (gin_fastkan_sum_kernel), added in chunk order
//      (gin_fastkan_sum_combine_kernel); z in x's dtype and, under bf16, the
//      unrounded f32 z in the scratch z32;
//   2. the FastKANLayer on the f32 z (fastkan_fwd.cuh's bodies, the ones the
//      layer forward runs): under bf16 on the tensor cores
//      (gin_fastkan_fwd_mma_kernel: persistent blocks of 64-row tiles
//      holding all outputs, the LayerNorm statistics and SiLU of the f32 z,
//      the f32 basis split into bf16 terms built once for every output; the
//      plan counts the held f32 rows at their four bytes), in f32 on the
//      CUDA cores (gin_fastkan_fwd_kernel, z's rows held in shared memory
//      where they fit, else read from device memory).
// No atomics: deterministic. Any number of centers 2-32 (one library each,
// FKAN_G), any D and O.

#include "fastkan_fwd.cuh"
#include "gin_sum.cuh"

namespace {

using namespace fkan;

// Pass 1 (gin_sum.cuh): the light rows and the heavy rows' pieces ...
template <typename T, int V>
__global__ void __launch_bounds__(kan::kSplitWarps * 32)
gin_fastkan_sum_kernel(const T* __restrict__ x, const T* __restrict__ tab,
                       const int* __restrict__ senders,
                       const int* __restrict__ row_ptr, T* __restrict__ z,
                       float* __restrict__ z32, float* __restrict__ partial,
                       int* __restrict__ first_row, int n, int d, float self, int chunk_blocks) {
  gin::sum_body<T, V>(x, tab, senders, row_ptr, z, z32, partial, first_row, n, d, self,
                      chunk_blocks);
}

// ... and the heavy rows' combine.
template <typename T>
__global__ void __launch_bounds__(kan::kSplitWarps * 32)
gin_fastkan_sum_combine_kernel(const T* __restrict__ x, const int* __restrict__ row_ptr,
                               const float* __restrict__ partial,
                               const int* __restrict__ first_row, T* __restrict__ z,
                               float* __restrict__ z32, int n, int d, float self) {
  gin::combine_body<T>(x, row_ptr, partial, first_row, z, z32, n, d, self);
}

// Pass 2 under bf16: the layer on the tensor cores, on the f32 z.
template <int G, int NPW>
__global__ void __launch_bounds__(kThreads, NPW == 1 ? 3 : 2)
gin_fastkan_fwd_mma_kernel(const float* __restrict__ z32, const bf16* __restrict__ lng,
                           const bf16* __restrict__ lnb, const bf16* __restrict__ w,
                           const bf16* __restrict__ wb, const bf16* __restrict__ bb,
                           bf16* __restrict__ out, int n, int D, int O, Centers cs, float inv_h,
                           kan::FwdPlan plan) {
  fwd_mma_body<float, bf16, G, true, NPW>(z32, lng, lnb, w, wb, bb, out, n, D, O, cs, inv_h,
                                          plan);
}

// Pass 2 in f32: the layer on the CUDA cores, on z.
template <int G, bool HOLD>
__global__ void __launch_bounds__(kThreads)
gin_fastkan_fwd_kernel(const float* __restrict__ z, const float* __restrict__ lng,
                       const float* __restrict__ lnb, const float* __restrict__ w,
                       const float* __restrict__ wb, const float* __restrict__ bb,
                       float* __restrict__ out, int n, int D, int O, Centers cs, float inv_h) {
  layer_fwd_f32_body<float, G, HOLD>(z, lng, lnb, w, wb, bb, out, n, D, O, cs, inv_h);
}

template <typename T, int G>
int launch(const void* x, const void* tab, const int* senders, const int* row_ptr,
           const void* lng,
           const void* lnb, const void* w, const void* wb, const void* bb, void* out, void* z,
           float* z32, float* partial, int* first_row, int n, int D, int O, float eps,
           int max_edges, Centers cs, float inv_h, cudaStream_t stream) {
  constexpr bool kMma = std::is_same_v<T, bf16>;
  if (kMma != (z32 != nullptr)) return (int)cudaErrorInvalidValue;
  T* zt = static_cast<T*>(z);
  if (int e = gin::launch_sum<T>(
          [](auto v) { return gin_fastkan_sum_kernel<T, decltype(v)::value>; },
          gin_fastkan_sum_combine_kernel<T>, static_cast<const T*>(x),
          static_cast<const T*>(tab), senders, row_ptr, zt,
          z32, partial, first_row, n, D, 1.f + eps, max_edges, stream))
    return e;
  const T* lt = static_cast<const T*>(lng);
  const T* bt = static_cast<const T*>(lnb);
  const T* wt = static_cast<const T*>(w);
  const T* wbt = static_cast<const T*>(wb);
  const T* bbt = static_cast<const T*>(bb);
  if constexpr (kMma) {
    return with_fwd_mma_part<float, G, true>(n, O, [&](auto npw, int op) {
      auto kernel = gin_fastkan_fwd_mma_kernel<G, decltype(npw)::value>;
      dim3 grid;
      const kan::FwdPlan* plan = fwd_mma_plan<float, G, true>(kernel, n, D, O, op, grid);
      if (plan == nullptr) return (int)cudaErrorInvalidValue;
      kernel<<<grid, kThreads, plan->smem, stream>>>(z32, lt, bt, wt, wbt, bbt,
                                                     static_cast<bf16*>(out), n, D, O, cs, inv_h,
                                                     *plan);
      return (int)cudaGetLastError();
    });
  } else {
    return launch_layer_fwd_f32<G>(
        [](auto hold) { return gin_fastkan_fwd_kernel<G, decltype(hold)::value>; }, zt, lt, bt,
        wt, wbt, bbt, static_cast<float*>(out), n, D, O, cs, inv_h, stream);
  }
}

}  // namespace

// out (n, O) and z (n, D) from x (n, D) over the receiver CSR (row_ptr of
// n+1 entries, senders in receiver-sorted edge order) gathering from tab
// (x itself when null; under the halo partition the extended table [x;
// halo], which senders index). lng, lnb (D,),
// w (G*D, O) g-major, wb (D, O), bb (O,), all of x's dtype; centers: G
// floats in host memory. z32: under bf16 f32 scratch of n x D (the
// unrounded z the layer reads), null in f32. Scratch: partial, f32 of 2 *
// ceil(max_edges / 64) * D floats; first_row, int32 of ceil(max_edges / 64).
// max_edges: at least row_ptr[n] (the length of senders), read on the host
// so that nothing waits for the device.
extern "C" int gin_fastkan_fwd(const void* x, const void* tab, const int* senders,
                               const int* row_ptr,
                               const void* lng, const void* lnb, const void* w, const void* wb,
                               const void* bb, void* out, void* z, float* z32, float* partial,
                               int* first_row, int n, int d, int o, float eps, int max_edges,
                               int G, const float* centers, float inv_h, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Centers cs{};
  for (int g = 0; g < G && g < kMaxG; ++g) cs.c[g] = centers[g];
  const void* t = tab != nullptr ? tab : x;
  FASTKAN_DISPATCH(dtype, G, launch, x, t, senders, row_ptr, lng, lnb, w, wb, bb, out, z, z32,
                   partial, first_row, n, d, o, eps, max_edges, cs, inv_h, s);
}
