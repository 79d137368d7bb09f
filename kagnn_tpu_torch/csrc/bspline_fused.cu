// Fused B-spline KANLinear forward and backward for Hopper (sm_90a).
//
// Replaces kagnn_tpu/pallas/bspline_fused.py::_fwd_kernel and ::_bwd_kernel
// (the latter also serves gin_fused.py::_kan_bwd_on_z):
//   out = SiLU(x) @ Wb + sum_g B_g(x) @ Ws_g
//   dx  = (dout @ Wb^T) * silu'(x) + sum_g (dout @ Ws_g^T) * B_g'(x)
//   dWb = SiLU(x)^T @ dout,  dWs_g = B_g(x)^T @ dout
// with the Cox-de Boor ladder (kan_common.cuh) built per tile in f32 from x
// and per-feature knots (K, D), never stored in device memory.
//
// Bound on the H100: at the main path's shapes (N = 169,344 rows, D = 64 or
// 128, O = 64 or 40, 8 groups) each product is 2*N*8D*O operations against
// N*(D+O) elements moved, about 50-100 operations per byte, below the bf16
// tensor-core ridge of about 295: device-memory bytes bound it. This first
// version computes the products on the CUDA cores in f32, so its time is set
// by issue rate, not by bytes; the basis matrix still never leaves the SM.
// Moving the products to wgmma is later work.
//
// The backward runs as three launches, all on the caller's stream:
//   1. dx: a tile of 64 rows computes dout @ [Wb; Ws]^T per 32-feature chunk
//      (the chunk's weights staged in shared memory one 64-wide tile of
//      outputs at a time, so any O fits: 131 KB at O = 256), rebuilds the
//      ladder from x and applies the analytic derivative;
//   2. dW partials: the TPU kernel accumulates dWb/dWs across its sequential
//      grid; Hopper blocks run in parallel, so a fixed number of blocks
//      (about two per SM) each sum a contiguous range of rows into an f32
//      partial buffer of its own;
//   3. a second small pass adds the partials in a fixed order and casts once
//      to the weights' dtype. The result is deterministic. (The JAX kernel
//      adds its per-tile partials in the output dtype, bf16 under mixed
//      precision; the port adds them in f32. At one or two row tiles the two
//      agree.)

#include "kan_common.cuh"

namespace {

using namespace kan;

constexpr int kDxRows = 64;  // rows per dx tile: 8 row groups of 8
constexpr int kDwRows = 32;  // rows per dW partial step

template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ knots, const T* __restrict__ wb,
           const T* __restrict__ ws, T* __restrict__ out, int n, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  auto load = [&](int, int row, int d) { return to_f(x[(size_t)row * D + d]); };
  kan_forward_tile<T, ORDER, GRID>(load, smem, row0, n, D, O, knots, wb, ws, out);
}

template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const T* __restrict__ knots, const T* __restrict__ wb,
          const T* __restrict__ ws, const T* __restrict__ dout, T* __restrict__ dx, int n,
          int D, int O) {
  using S = Shape<ORDER, GRID>;
  constexpr int pitch = S::AC + 1;  // odd pitch: conflict-free staging stores
  extern __shared__ __align__(16) float smem[];
  float* dout_s = smem;                 // kDxRows x O
  float* w_s = smem + kDxRows * O;      // kOT x pitch, [o - o0][g*kDC + j]
  const int row0 = blockIdx.x * kDxRows;
  const int dd = threadIdx.x % kDC;
  const int rg = threadIdx.x / kDC;  // 8 row groups of 8 rows

  for (int i = threadIdx.x; i < kDxRows * O; i += kThreads) {
    const int row = row0 + i / O;
    dout_s[i] = row < n ? to_f(dout[(size_t)row0 * O + i]) : 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += kDC) {
    float acc[8][S::NG];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int g = 0; g < S::NG; ++g) acc[i][g] = 0.f;
    // the chunk's weights one kOT-wide tile of outputs at a time, so that
    // shared memory does not grow with O; acc sums over o in order
    for (int o0 = 0; o0 < O; o0 += kOT) {
      const int on = min(kOT, O - o0);
      __syncthreads();  // dout_s is complete; the previous tile is consumed
      for (int i = threadIdx.x; i < on * S::AC; i += kThreads) {
        const int o = i % on, rest = i / on;
        const int j = rest % kDC, g = rest / kDC;
        const int d = d0 + j;
        w_s[o * pitch + g * kDC + j] =
            d < D ? to_f(weight_row(wb, ws, g, d, D, O)[o0 + o]) : 0.f;
      }
      __syncthreads();
      for (int o = 0; o < on; ++o) {
        float w[S::NG];
#pragma unroll
        for (int g = 0; g < S::NG; ++g) w[g] = w_s[o * pitch + g * kDC + dd];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dv = dout_s[(rg * 8 + i) * O + o0 + o];
#pragma unroll
          for (int g = 0; g < S::NG; ++g) acc[i][g] += dv * w[g];
        }
      }
    }
    const int d = d0 + dd;
    if (d < D) {
      float t[S::NK];
#pragma unroll
      for (int j = 0; j < S::NK; ++j) t[j] = to_f(knots[(size_t)j * D + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + rg * 8 + i;
        if (row >= n) continue;
        const float xv = to_f(x[(size_t)row * D + d]);
        float v = acc[i][0] * dsilu(xv, sigmoid(xv));
        float b[S::NK - 1], pen[S::NK - ORDER];
        ladder<ORDER, S::NK>(xv, t, b, pen);
#pragma unroll
        for (int g = 0; g < S::NB; ++g) {
          const float left = pen[g] * (1.f / (t[g + ORDER] - t[g]));
          const float right = pen[g + 1] * (1.f / (t[g + ORDER + 1] - t[g + 1]));
          v += acc[i][g + 1] * ((float)ORDER * (left - right));
        }
        dx[(size_t)row * D + d] = from_f<T>(v);
      }
    }
  }
}

// grid (D chunks, splits, O tiles). Thread t owns 4 output columns
// (t % 16) x KPT basis columns (t / 16) of the chunk's (AC, kOT) block.
template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ knots,
                  const T* __restrict__ dout, float* __restrict__ partial, int n, int D, int O,
                  int rows_per_split) {
  using S = Shape<ORDER, GRID>;
  constexpr int KPT = S::AC / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                      // kDwRows x AC
  float* dout_s = smem + kDwRows * S::AC; // kDwRows x kOT
  const int d0 = blockIdx.x * kDC;
  const int split = blockIdx.y;
  const int o0 = blockIdx.z * kOT;
  const int og = threadIdx.x % 16, kg = threadIdx.x / 16;
  const int rbeg = split * rows_per_split;
  const int rend = min(n, rbeg + rows_per_split);
  float acc[KPT][4];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  auto load = [&](int, int row, int d) { return to_f(x[(size_t)row * D + d]); };

  for (int r0 = rbeg; r0 < rend; r0 += kDwRows) {
    __syncthreads();
    build_basis_chunk<T, ORDER, GRID>(load, A_s, kDwRows, r0, rend, d0, D, knots);
    for (int i = threadIdx.x; i < kDwRows * kOT; i += kThreads) {
      const int row = r0 + i / kOT, o = o0 + i % kOT;
      dout_s[i] = (row < rend && o < O) ? to_f(dout[(size_t)row * O + o]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kDwRows; ++r) {
      const float4 dv = *reinterpret_cast<const float4*>(dout_s + r * kOT + og * 4);
      const float* a = A_s + r * S::AC + kg * KPT;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float av = a[j];
        acc[j][0] += av * dv.x;
        acc[j][1] += av * dv.y;
        acc[j][2] += av * dv.z;
        acc[j][3] += av * dv.w;
      }
    }
  }
  const size_t m = (size_t)S::NG * D * O;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int c = kg * KPT + j;
    const int d = d0 + c % kDC;
    if (d >= D) continue;
    const size_t gc = (size_t)(c / kDC) * D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) partial[split * m + gc * O + o] = acc[j][q];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int ORDER, int GRID>
int launch_fwd(const void* x, const void* knots, const void* wb, const void* ws, void* out,
               int n, int D, int O, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  const size_t smem = sizeof(float) * kFwdRows * S::AC;
  if (int e = set_smem(fwd_kernel<T, ORDER, GRID>, smem)) return e;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  if (grid.x > 0)
    fwd_kernel<T, ORDER, GRID><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(knots), static_cast<const T*>(wb),
        static_cast<const T*>(ws), static_cast<T*>(out), n, D, O);
  return (int)cudaGetLastError();
}

template <typename T, int ORDER, int GRID>
int launch_bwd(const void* x, const void* knots, const void* wb, const void* ws,
               const void* dout, void* dx, float* partial, void* dw, int n, int D, int O,
               int splits, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(knots);
  const T* gt = static_cast<const T*>(dout);
  if (dx != nullptr && n > 0) {
    const size_t smem = sizeof(float) * ((size_t)kDxRows * O + (size_t)kOT * (S::AC + 1));
    if (int e = set_smem(dx_kernel<T, ORDER, GRID>, smem)) return e;
    dx_kernel<T, ORDER, GRID><<<(n + kDxRows - 1) / kDxRows, kThreads, smem, stream>>>(
        xt, kt, static_cast<const T*>(wb), static_cast<const T*>(ws), gt,
        static_cast<T*>(dx), n, D, O);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const int tiles = (n + kDwRows - 1) / kDwRows;
  const int rows_per_split = ((tiles + splits - 1) / splits) * kDwRows;
  const size_t smem = sizeof(float) * ((size_t)kDwRows * S::AC + kDwRows * kOT);
  if (int e = set_smem(dw_partial_kernel<T, ORDER, GRID>, smem)) return e;
  dim3 grid((D + kDC - 1) / kDC, splits, (O + kOT - 1) / kOT);
  dw_partial_kernel<T, ORDER, GRID><<<grid, kThreads, smem, stream>>>(
      xt, kt, gt, partial, n, D, O, rows_per_split);
  if (int e = (int)cudaGetLastError()) return e;
  return reduce_partials<T>(partial, static_cast<T*>(dw), splits, (size_t)S::NG * D * O,
                            stream);
}

}  // namespace

// out (n, O) = KANLinear(x). x (n, D), knots (K, D), wb (D, O), ws (NB*D, O),
// all of one dtype; every pointer is device memory, every array contiguous.
extern "C" int bspline_fwd(const void* x, const void* knots, const void* wb, const void* ws,
                           void* out, int n, int d, int o, int grid, int order, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch_fwd, x, knots, wb, ws, out, n, d, o, s);
}

// dx (n, D) (skipped when dx is null) and dw (NG*D, O) = [dWb; dWs] from
// dout (n, O). partial is f32 scratch of splits * NG*D*O elements.
extern "C" int bspline_bwd(const void* x, const void* knots, const void* wb, const void* ws,
                           const void* dout, void* dx, float* partial, void* dw, int n, int d,
                           int o, int grid, int order, int dtype, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch_bwd, x, knots, wb, ws, dout, dx, partial, dw, n, d,
               o, splits, s);
}
