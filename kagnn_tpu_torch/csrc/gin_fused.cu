// Fused GIN aggregate + B-spline KANLinear forward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gin_fused.py::_kernel:
//   z   = (1 + eps) * x + sum_{e in [row_ptr[r], row_ptr[r+1])} x[senders[e]]
//   out = KANLinear(z)
// emitting out and the residual z (in x's dtype) for the backward. As in the
// JAX kernel the ladder runs on the unrounded f32 z while the stored z is
// rounded to x's dtype (the backward rebuilds from the stored z), SiLU(z)
// and the bases are rounded to the compute dtype once before their
// products, and there is no edge-mask multiply: padded edges point at the
// masked last row, whose output every consumer masks.
//
// Bound on the H100: device-memory bytes for the aggregate (one sender row
// of D values per edge, about 7 edges a node at the main path's shapes) and
// the basis build for the KANLinear (as bspline_fused.cu's forward). What
// held the first version back: one warp walked each receiver row, so
// the arxiv-sized graph's node 0 (2,748 in-edges, about 690 rounds of
// dependent gathers) finished long after the rest of the card, and the
// epilogue built its basis and multiplied on the CUDA cores, once for every
// 64 outputs (0.742 ms at (D 64, O 64) in bf16, 1.469 at (128, 64) against
// bounds of 0.021 and 0.034). This design is two passes:
//   1. the aggregate (gin_sum.cuh, shared with gin_fastkan.cu):
//      kan_common.cuh's split row sum (spmm.cu's design), 16-byte loads in
//      128-byte column slabs (grid.y), so each slab's gathered table stays
//      in L2; a receiver row of more than 64 edges (node 0, the pad row
//      heavy by its padding) is cut at the 64-edge chunks of the edge array
//      into pieces that separate warps sum into f32 partials
//      (gin_sum_kernel), added in chunk order by gin_sum_combine_kernel.
//      Each row's sum plus (1+eps)*x is written as z in x's dtype and,
//      under bf16, as f32 z in the scratch z32;
//   2. the KANLinear on the f32 z: under bf16 on the tensor cores
//      (gin_fwd_mma_kernel, kan_fwd.cuh's body, the one bspline_fwd_mma_kernel
//      runs: persistent blocks of 128-row tiles holding all outputs, up to
//      256, the bf16 basis of a feature chunk built once for all of them),
//      in f32 on the CUDA cores (gin_fwd_kernel, bspline_fwd_kernel's tile:
//      TF32 would miss the f32 bars).
// The f32 z round trip costs 8*N*D bytes (87 MB at D 128, about 0.03 ms)
// and lets each pass run at its own occupancy: the gather at full
// occupancy, the forward at its plan. One fused pass (the pieces launch,
// then each forward block gathering its tile's rows into an f32 z tile in
// shared memory) read 0.443 and 0.931 ms at (64, 64) and (128, 64) against
// 0.319 and 0.614 for the two passes on the H100: its 150 KB a block leave
// one block an SM, too few gathers in flight (PERF.md §6). No
// atomics: deterministic.
//
// Shapes: one library per (spline order, grid size), as bspline_fused.cu;
// any D and O (the forward stages its f32 z a feature chunk at a time).

#include "gin_sum.cuh"
#include "kan_fwd.cuh"

namespace {

using namespace kan;

// Pass 1 (gin_sum.cuh): the light rows and the heavy rows' pieces ...
template <typename T, int V>
__global__ void __launch_bounds__(kSplitWarps * 32)
gin_sum_kernel(const T* __restrict__ x, const T* __restrict__ tab,
               const int* __restrict__ senders,
               const int* __restrict__ row_ptr, T* __restrict__ z, float* __restrict__ z32,
               float* __restrict__ partial, int* __restrict__ first_row, int n, int d,
               float self, int chunk_blocks) {
  gin::sum_body<T, V>(x, tab, senders, row_ptr, z, z32, partial, first_row, n, d, self,
                      chunk_blocks);
}

// ... and the heavy rows' combine.
template <typename T>
__global__ void __launch_bounds__(kSplitWarps * 32)
gin_sum_combine_kernel(const T* __restrict__ x, const int* __restrict__ row_ptr,
                       const float* __restrict__ partial, const int* __restrict__ first_row,
                       T* __restrict__ z, float* __restrict__ z32, int n, int d, float self) {
  gin::combine_body<T>(x, row_ptr, partial, first_row, z, z32, n, d, self);
}

// Pass 2 under bf16: kan_fwd.cuh's tensor-core forward on the f32 z.
template <int ORDER, int GRID, int NPW>
__global__ void __launch_bounds__(kThreads, kKanFwdBlocks<ORDER, GRID, NPW>)
gin_fwd_mma_kernel(const float* __restrict__ z32, const bf16* __restrict__ knots,
                   const bf16* __restrict__ wb, const bf16* __restrict__ ws,
                   bf16* __restrict__ out, int n, int D, int O, FwdPlan plan) {
  kan_fwd_mma_body<float, ORDER, GRID, NPW>(z32, knots, wb, ws, out, n, D, O, plan);
}

// Pass 2 in f32: the CUDA-core KANLinear tile on z, 32 rows x 64 outputs a
// block.
template <int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
gin_fwd_kernel(const float* __restrict__ z, const float* __restrict__ knots,
               const float* __restrict__ wb, const float* __restrict__ ws,
               float* __restrict__ out, int n, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  auto load = [&](int, int row, int d) { return z[(size_t)row * D + d]; };
  kan_forward_tile<float, ORDER, GRID>(load, smem, blockIdx.x * kFwdRows, n, D, O, knots, wb,
                                       ws, out);
}

template <typename T, int ORDER, int GRID>
int launch(const void* x, const void* tab, const int* senders, const int* row_ptr,
           const void* knots,
           const void* wb, const void* ws, void* out, void* z, float* z32, float* partial,
           int* first_row, int n, int D, int O, float eps, int max_edges, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  constexpr bool kMma = std::is_same_v<T, bf16>;
  if (kMma != (z32 != nullptr)) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* zt = static_cast<T*>(z);
  if (int e = gin::launch_sum<T>([](auto v) { return gin_sum_kernel<T, decltype(v)::value>; },
                                 gin_sum_combine_kernel<T>, xt, static_cast<const T*>(tab),
                                 senders, row_ptr, zt, z32,
                                 partial, first_row, n, D, 1.f + eps, max_edges, stream))
    return e;
  if constexpr (kMma) {
    return launch_fwd_mma<float, ORDER, GRID>(
        [](auto npw) { return gin_fwd_mma_kernel<ORDER, GRID, decltype(npw)::value>; }, z32,
        static_cast<const bf16*>(knots), static_cast<const bf16*>(wb),
        static_cast<const bf16*>(ws), static_cast<bf16*>(out), n, D, O, stream);
  } else {
    const size_t smem = sizeof(float) * kFwdRows * S::AC;
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (int err = set_smem(gin_fwd_kernel<ORDER, GRID>, smem)) return err;
    dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
    if (grid.x > 0)
      gin_fwd_kernel<ORDER, GRID><<<grid, kThreads, smem, stream>>>(
          zt, static_cast<const float*>(knots), static_cast<const float*>(wb),
          static_cast<const float*>(ws), static_cast<float*>(out), n, D, O);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// out (n, O) and z (n, D) from x (n, D) over the receiver CSR (row_ptr of
// n+1 entries, senders in receiver-sorted edge order) gathering from tab
// (x itself when null; under the halo partition the extended table [x;
// halo], which senders index). knots (K, D),
// wb (D, O), ws (NB*D, O), all of x's dtype. z32: under bf16 f32 scratch
// of n x D (the unrounded z the forward reads), null in f32. Scratch:
// partial, f32 of 2 * ceil(max_edges / 64) * D floats; first_row, int32 of
// ceil(max_edges / 64). max_edges: at least row_ptr[n] (the length of
// senders), read on the host so that nothing waits for the device.
extern "C" int gin_fwd(const void* x, const void* tab, const int* senders,
                       const int* row_ptr, const void* knots, const void* wb, const void* ws,
                       void* out, void* z, float* z32, float* partial, int* first_row, int n,
                       int d, int o, float eps, int max_edges, int grid, int order, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* t = tab != nullptr ? tab : x;
  KAN_DISPATCH(dtype, order, grid, launch, x, t, senders, row_ptr, knots, wb, ws, out, z, z32,
               partial, first_row, n, d, o, eps, max_edges, s);
}
