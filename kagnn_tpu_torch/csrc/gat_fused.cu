// Fused GAT attention forward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/gat_fused.py::_kernel (via _fwd_impl). Per
// receiver r and head, over its valid edges e = (s -> r) and the implicit
// self-loop, l_self = leaky(asrc_r + adst_r), l_e = leaky(asrc_s + adst_r):
//   m     = bf16(max(l_self, max_e l_e))            (the JAX kernel's rounded shift)
//   den   = exp(l_self - m) + sum_e exp(l_e - m)    (f32)
//   out_r = (exp(l_self - m) h_r + sum_e T(exp(l_e - m)) h_s) / den   in T
//   alpha_r = m + log(den)                           (f32, for the backward)
// with T(w) the weight rounded to h's dtype, as the JAX kernel's weighted
// products take it. The JAX kernel's one-hot MXU products, bf16 hi/lo
// splits, 1024-edge chunks and in-kernel recomputation of asrc from the
// message stream were TPU workarounds and are gone: on Hopper the narrow
// gather of asrc[s] (16 bytes at H = 4) is cheap.
//
// Bound on the H100: device-memory bytes. Per edge the kernel reads one
// sender row of H*C values (512 bytes at H*C = 256 in bf16) and does
// 2*H*C operations, far below the ridge. Read once, the inputs and outputs
// are 2*N*H*C*sizeof(T) plus the narrow arrays; the kernel re-reads h at
// every edge (E rows), which the 50 MB L2 serves only in part at the main
// path's N = 169,344 (h is 87 MB in bf16).
//
// Design: one warp per receiver row (gat_common.cuh: J passes of 32
// slots, any C), two passes over the row's edges in CSR order: the first
// takes the max of the gathered asrc (leaky is increasing, so that gives the
// shift), the second the weights, the denominator and the weighted sum of
// the gathered rows, in registers, unroll<J>() rows in flight. No atomics,
// no (E, H*C) tensor, deterministic. One warp walks a hub row alone (node 0
// of the main graph has 2,748 edges), which bounds the launch's time from
// below; splitting long rows is later work.

#include "gat_common.cuh"

namespace {

using namespace gat;

template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
               const float* __restrict__ adst, const int* __restrict__ senders,
               const int* __restrict__ row_ptr, T* __restrict__ out, float* __restrict__ alpha,
               int n, int H, int C, int P, int n_edge, float slope) {
  constexpr int U = unroll<J>();
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const size_t HC = (size_t)H * C;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  Slot sl[J];
  float ad[J], self[J], m[J], den[J], acc[J][kCols];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sl[j] = slot_of(j, H, C, P);
    ad[j] = adst[(size_t)row * H + sl[j].head];
    self[j] = leaky(asrc[(size_t)row * H + sl[j].head] + ad[j], slope);
  }

  // pass 1: the shift
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float ma = -INFINITY;
#pragma unroll 4
    for (int e = e0; e < e1; ++e)
      ma = fmaxf(ma, __ldg(asrc + (size_t)__ldg(senders + e) * H + sl[j].head));
    m[j] = kan::round_t<__nv_bfloat16>(e1 > e0 ? fmaxf(self[j], leaky(ma + ad[j], slope))
                                               : self[j]);
  }

  // pass 2: the self-loop, then the edges in order
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float es = expf(self[j] - m[j]);
    den[j] = es;
    load_cols<VEC>(h + row * HC, sl[j], acc[j]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] *= es;
  }
  auto edge = [&](int j, float a, const float (&v)[kCols]) {
    const float w = expf(leaky(a + ad[j], slope) - m[j]);
    den[j] += w;
    const float wq = kan::round_t<T>(w);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] += wq * v[k];
  };
  int e = e0;
  for (; e + U <= e1; e += U) {
    int s[U];
    float a[U][J], v[U][J][kCols];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = __ldg(senders + e + u);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        a[u][j] = __ldg(asrc + (size_t)s[u] * H + sl[j].head);
        load_cols<VEC>(h + s[u] * HC, sl[j], v[u][j]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) edge(j, a[u][j], v[u][j]);
  }
  for (; e < e1; ++e) {
    const int s = __ldg(senders + e);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float v[kCols];
      load_cols<VEC>(h + s * HC, sl[j], v);
      edge(j, __ldg(asrc + (size_t)s * H + sl[j].head), v);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (sl[j].cnt > 0) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[j][k] /= den[j];
      store_cols<VEC>(out + row * HC, sl[j], acc[j]);
    }
    if (sl[j].leader) alpha[(size_t)row * H + sl[j].head] = m[j] + logf(den[j]);
  }
}

template <typename T, int J, bool VEC>
int launch(int P, const void* h, const float* asrc, const float* adst, const int* senders,
           const int* row_ptr, void* out, float* alpha, int n, int H, int C, int n_edge,
           float slope, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0)
    gat_fwd_kernel<T, J, VEC><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, senders, row_ptr, static_cast<T*>(out), alpha, n,
        H, C, P, n_edge, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, H*C) in h's dtype and alpha (n, H) f32 from h (n, H*C), asrc and
// adst (n, H) f32 over the receiver CSR (row_ptr of n+1 entries, senders in
// receiver-sorted order; edges at or past n_edge are padding). Any C >= 1
// with H * P <= 256 slots (gat_common.cuh); h 16-byte aligned when C is a
// multiple of 8.
extern "C" int gat_fwd(const void* h, const float* asrc, const float* adst, const int* senders,
                       const int* row_ptr, void* out, float* alpha, int n, int H, int C,
                       int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GAT_DISPATCH(dtype, H, C, launch, h, asrc, adst, senders, row_ptr, out, alpha, n, H, C,
               n_edge, slope, s);
}
