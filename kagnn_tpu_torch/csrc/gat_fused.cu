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
// Design: one warp per receiver row (gat_common.cuh), two passes over the
// row's edges in CSR order: the first takes the max of the gathered asrc
// (leaky is increasing, so that gives the shift), the second the weights,
// the denominator and the weighted sum of the gathered rows, in registers,
// four rows in flight. No atomics, no (E, H*C) tensor, deterministic. One
// warp walks a hub row alone (node 0 of the main graph has 2,748 edges),
// which bounds the launch's time from below; splitting long rows is later
// work.

#include "gat_common.cuh"

namespace {

using namespace gat;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
               const float* __restrict__ adst, const int* __restrict__ senders,
               const int* __restrict__ row_ptr, T* __restrict__ out, float* __restrict__ alpha,
               int n, int H, int C, int n_edge, float slope) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const Lane ln = lane_of(H, C);
  const size_t HC = (size_t)H * C;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  const float ad = adst[(size_t)row * H + ln.head];
  const float sl = leaky(asrc[(size_t)row * H + ln.head] + ad, slope);

  // pass 1: the shift
  float ma = -INFINITY;
#pragma unroll 4
  for (int e = e0; e < e1; ++e)
    ma = fmaxf(ma, __ldg(asrc + (size_t)__ldg(senders + e) * H + ln.head));
  const float m = kan::round_t<__nv_bfloat16>(e1 > e0 ? fmaxf(sl, leaky(ma + ad, slope)) : sl);

  // pass 2: the self-loop, then the edges in order
  const float es = expf(sl - m);
  float den = es;
  float acc[kCols];
  load8(h + row * HC + ln.col, acc);
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] *= es;
  int e = e0;
  for (; e + kUnroll <= e1; e += kUnroll) {
    int s[kUnroll];
    float a[kUnroll], v[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] = __ldg(senders + e + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(asrc + (size_t)s[u] * H + ln.head);
      load8(h + s[u] * HC + ln.col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float w = expf(leaky(a[u] + ad, slope) - m);
      den += w;
      const float wq = kan::round_t<T>(w);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] += wq * v[u][j];
    }
  }
  for (; e < e1; ++e) {
    const int s = __ldg(senders + e);
    float v[kCols];
    load8(h + s * HC + ln.col, v);
    const float w = expf(leaky(__ldg(asrc + (size_t)s * H + ln.head) + ad, slope) - m);
    den += w;
    const float wq = kan::round_t<T>(w);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += wq * v[j];
  }
  if (ln.active) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] /= den;
    store8(out + row * HC + ln.col, acc);
  }
  if (ln.leader) alpha[(size_t)row * H + ln.head] = m + logf(den);
}

template <typename T>
int launch(const void* h, const float* asrc, const float* adst, const int* senders,
           const int* row_ptr, void* out, float* alpha, int n, int H, int C, int n_edge,
           float slope, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0)
    gat_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, senders, row_ptr, static_cast<T*>(out), alpha, n,
        H, C, n_edge, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, H*C) in h's dtype and alpha (n, H) f32 from h (n, H*C), asrc and
// adst (n, H) f32 over the receiver CSR (row_ptr of n+1 entries, senders in
// receiver-sorted order; edges at or past n_edge are padding).
extern "C" int gat_fwd(const void* h, const float* asrc, const float* adst, const int* senders,
                       const int* row_ptr, void* out, float* alpha, int n, int H, int C,
                       int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return launch<float>(h, asrc, adst, senders, row_ptr, out, alpha, n, H, C, n_edge, slope, s);
  if (dtype == kan::kBF16)
    return launch<__nv_bfloat16>(h, asrc, adst, senders, row_ptr, out, alpha, n, H, C, n_edge,
                                 slope, s);
  return (int)cudaErrorInvalidValue;
}
