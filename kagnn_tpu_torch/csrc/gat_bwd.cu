// The two GAT attention backward kernels for Hopper (sm_90a).
//
// Replace kagnn_tpu/pallas/gat_bwd.py::_dadst_kernel (gat_bwd_dadst) and
// ::_sender_kernel (gat_bwd_sender). Per valid edge e = (s -> r) and head,
// with alpha and S_r = <dout_r, out_r> from the forward:
//   z_e  = asrc_s + adst_r,  w_e = exp(min(leaky(z_e) - alpha_r, 80))
//   dw_e = <dout_r, h_s>     (f32 products and sum over the head's C columns)
//   dz_e = w_e (dw_e - S_r) leaky'(z_e)
// gat_dadst:  dadst_r = sum_{e -> r} dz_e             over the receiver CSR
// gat_sender: dh_s = sum_{s -> e} w_e dout_r, dasrc_s = sum_{s -> e} dz_e
//                                                     over the sender CSR
// The self-loop terms are node-space work of the caller
// (kernels/gat_fused.py). The JAX kernels' one-hot selections, hi/lo splits,
// 128-lane dout parts and exact-hi/lo narrow tables were TPU workarounds and
// are gone; here each kernel gathers what it needs per edge.
//
// Bound on the H100: device-memory bytes, as the forward (gat_fused.cu):
// per edge one gathered row of H*C values (h_s for dadst, dout_r for the
// sender pass) and a few narrow values, 2*H*C to 4*H*C operations.
//
// Design: one warp per row (gat_common.cuh), edges in CSR order, four rows in
// flight, the per-head dot by a butterfly over the head's lanes, every sum in
// registers: no atomics, deterministic. gat_dadst reads dout_r, adst_r,
// alpha_r and S_r once per row and gathers h_s and asrc_s; gat_sender reads
// h_s and asrc_s once and gathers dout_r, adst_r, alpha_r and S_r. The
// hub row (in-degree 2,748 at node 0 of the main graph) is one warp's work in
// gat_dadst; the sender CSR's rows are short (out-degree <= 23 there).

#include "gat_common.cuh"

namespace {

using namespace gat;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gat_dadst_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                 const float* __restrict__ adst, const float* __restrict__ alpha,
                 const float* __restrict__ S, const T* __restrict__ dout,
                 const int* __restrict__ senders, const int* __restrict__ row_ptr,
                 float* __restrict__ dadst, int n, int H, int C, int n_edge, float slope) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const Lane ln = lane_of(H, C);
  const size_t HC = (size_t)H * C;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  const size_t rh = (size_t)row * H + ln.head;
  const float ad = adst[rh], al = alpha[rh], sr = S[rh];
  float dv[kCols];
  load8(dout + row * HC + ln.col, dv);
  float da = 0.f;

  auto edge = [&](float a, const float (&v)[kCols]) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) p += dv[j] * v[j];
    const float dw = head_sum(p, C);
    const float z = a + ad;
    const float w = expf(fminf(leaky(z, slope) - al, kClamp));
    da += w * (dw - sr) * dleaky(z, slope);
  };
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
    for (int u = 0; u < kUnroll; ++u) edge(a[u], v[u]);
  }
  for (; e < e1; ++e) {
    const int s = __ldg(senders + e);
    float v[kCols];
    load8(h + s * HC + ln.col, v);
    edge(__ldg(asrc + (size_t)s * H + ln.head), v);
  }
  if (ln.leader) dadst[rh] = da;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gat_sender_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                  const float* __restrict__ adst, const float* __restrict__ alpha,
                  const float* __restrict__ S, const T* __restrict__ dout,
                  const int* __restrict__ receivers, const int* __restrict__ row_ptr,
                  float* __restrict__ dh, float* __restrict__ dasrc, int n, int H, int C,
                  int n_edge, float slope) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const Lane ln = lane_of(H, C);
  const size_t HC = (size_t)H * C;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  const float as = asrc[(size_t)row * H + ln.head];
  float hv[kCols], acc[kCols];
  load8(h + row * HC + ln.col, hv);
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float da = 0.f;

  auto edge = [&](float ad, float al, float sr, const float (&dv)[kCols]) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) p += dv[j] * hv[j];
    const float dw = head_sum(p, C);
    const float z = as + ad;
    const float w = expf(fminf(leaky(z, slope) - al, kClamp));
    da += w * (dw - sr) * dleaky(z, slope);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += w * dv[j];
  };
  int e = e0;
  for (; e + kUnroll <= e1; e += kUnroll) {
    int r[kUnroll];
    float ad[kUnroll], al[kUnroll], sr[kUnroll], dv[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(receivers + e + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t rh = (size_t)r[u] * H + ln.head;
      ad[u] = __ldg(adst + rh);
      al[u] = __ldg(alpha + rh);
      sr[u] = __ldg(S + rh);
      load8(dout + r[u] * HC + ln.col, dv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) edge(ad[u], al[u], sr[u], dv[u]);
  }
  for (; e < e1; ++e) {
    const size_t r = __ldg(receivers + e);
    const size_t rh = r * H + ln.head;
    float dv[kCols];
    load8(dout + r * HC + ln.col, dv);
    edge(__ldg(adst + rh), __ldg(alpha + rh), __ldg(S + rh), dv);
  }
  if (ln.active) store8(dh + row * HC + ln.col, acc);
  if (ln.leader) dasrc[(size_t)row * H + ln.head] = da;
}

template <typename T>
int launch_dadst(const void* h, const float* asrc, const float* adst, const float* alpha,
                 const float* S, const void* dout, const int* senders, const int* row_ptr,
                 float* dadst, int n, int H, int C, int n_edge, float slope,
                 cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0)
    gat_dadst_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), senders,
        row_ptr, dadst, n, H, C, n_edge, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sender(const void* h, const float* asrc, const float* adst, const float* alpha,
                  const float* S, const void* dout, const int* receivers, const int* row_ptr,
                  float* dh, float* dasrc, int n, int H, int C, int n_edge, float slope,
                  cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0)
    gat_sender_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), receivers,
        row_ptr, dh, dasrc, n, H, C, n_edge, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dadst (n, H) f32 over the receiver CSR (senders in receiver-sorted order).
// h and dout (n, H*C) of one dtype; asrc, adst, alpha, S (n, H) f32.
extern "C" int gat_dadst(const void* h, const float* asrc, const float* adst, const float* alpha,
                         const float* S, const void* dout, const int* senders,
                         const int* row_ptr, float* dadst, int n, int H, int C, int n_edge,
                         float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return launch_dadst<float>(h, asrc, adst, alpha, S, dout, senders, row_ptr, dadst, n, H, C,
                               n_edge, slope, s);
  if (dtype == kan::kBF16)
    return launch_dadst<__nv_bfloat16>(h, asrc, adst, alpha, S, dout, senders, row_ptr, dadst,
                                       n, H, C, n_edge, slope, s);
  return (int)cudaErrorInvalidValue;
}

// dh (n, H*C) f32 and dasrc (n, H) f32 over the sender CSR (receivers in
// sender-sorted order, i.e. receivers_by_sender).
extern "C" int gat_sender(const void* h, const float* asrc, const float* adst, const float* alpha,
                          const float* S, const void* dout, const int* receivers,
                          const int* row_ptr, float* dh, float* dasrc, int n, int H, int C,
                          int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kan::kF32)
    return launch_sender<float>(h, asrc, adst, alpha, S, dout, receivers, row_ptr, dh, dasrc, n,
                                H, C, n_edge, slope, s);
  if (dtype == kan::kBF16)
    return launch_sender<__nv_bfloat16>(h, asrc, adst, alpha, S, dout, receivers, row_ptr, dh,
                                        dasrc, n, H, C, n_edge, slope, s);
  return (int)cudaErrorInvalidValue;
}
