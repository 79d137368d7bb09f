// Fused RBF basis and spline product, forward and backward, for Hopper
// (sm_90a).
//
// Replaces kagnn_tpu/pallas/rbf_fused.py::_fwd_kernel and ::_bwd_kernel
// (rbf_spline_matmul: the FastKANLayer without layernorm or without base
// update):
//   B_g(x) = exp(-d_g^2),  d_g = (x - c_g) * inv_h            g = 0..G-1
//   out[n, o] = sum_{g, d} B_g(x[n, d]) * W[g*D + d, o]
//   dx[n, d]  = sum_g (dout @ W^T)[n, g*D + d] * B_g * (-2 inv_h) * d_g
//   dW        = B^T @ dout, summed over row tiles
// x, out, dout and dx are of one type TX, W and dW of another, TW; each is
// f32 or bf16. Products and sums run in f32.
//
// Rounding, settled against the JAX kernel in interpret mode
// (tests/test_torch_rbf.py): with x in bf16 the distance is computed in
// bf16 as the JAX kernel writes it, t = bf16(x - c_g), d = bf16(t * inv_h),
// then bf16(d * d), with c_g and inv_h rounded to bf16 on the host
// (kernels/rbf_fused.py::constants); exp runs in f32. The forward rounds
// the basis to bf16 before its product; the backward multiplies the f32
// exp, as the JAX kernel does under XLA's excess precision. dW is summed
// over the JAX kernel's row tiles (512 rows, 256 under 256 rows) in tile
// order and rounded to W's type after each tile, as its
// `dw_ref += partial.astype(dw.dtype)` does; in f32 that is an ordered sum.
//
// Bound on the H100: at the slice's shapes (N = 169,344 rows, (D, O) =
// (128, 64) or (64, 64), G = 8) the forward does 2*N*G*D*O operations
// against N*(D + O) elements moved: about 340 and 260 operations per byte
// in bf16, around the tensor cores' ridge of about 295. This first version
// runs the products on the CUDA cores in f32 (as csrc/fastkan_layer.cu),
// so the SMs' instruction rate sets its time; the (N, G*D) basis never
// leaves the SM. Moving the products to wgmma is later work.
//
// Design: the forward gives each block a 32-row tile and a 64-wide output
// tile and builds the basis a 32-feature chunk at a time in shared memory:
// the basis builder and tile product of the FastKANLayer kernels
// (fastkan_common.cuh) without the layernorm and the SiLU column, with the
// distance rounded to x's type.
// The backward runs as up to three launches on the caller's stream:
//   1. rbf_dx_kernel (skipped when x needs no gradient): one 32-row tile per
//      block; per feature chunk dout @ W^T with the chunk's weights staged
//      in shared memory one 64-wide output tile at a time, then the basis
//      derivative summed over g;
//   2. rbf_dw_partial_kernel: one block per (feature chunk, row tile, output
//      tile) writes the tile's f32 partial B^T @ dout (the TPU kernel sums
//      the tiles across its sequential grid; Hopper blocks run in
//      parallel);
//   3. kan::walk_tiles adds the partials in tile order, rounding as above.
//      No atomics: the result is deterministic.
//
// Shapes: any number of centers 2-32 (one library each, FKAN_G; the feature
// chunk narrows past 8 centers, fastkan_common.cuh), any D, and O up to the
// dx kernel's staged dout tile (about 1,200 outputs).

#include "fastkan_common.cuh"

namespace {

using fkan::basis_chunk;
using fkan::Centers;
using fkan::rbf;
using kan::from_f;
using kan::kFwdRows;
using kan::kOT;
using kan::kThreads;
using kan::to_f;

constexpr int kDxRows = 32;  // rows per dx tile
constexpr int kDwRows = 32;  // rows per step of a dW tile

// load for basis_chunk: x itself is the basis input
template <typename TX>
struct LoadX {
  const TX* x;
  int D;
  __device__ __forceinline__ void operator()(int, int row, int d, float& xv, float& xs) const {
    xv = xs = to_f(x[(size_t)row * D + d]);
  }
};

// grid (row tiles, output tiles); the basis is rounded to x's type before
// the product, as the JAX forward has it.
template <typename TX, typename TW, int G>
__global__ void __launch_bounds__(kThreads)
rbf_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out, int n,
               int D, int O, Centers cs, float inv_h) {
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;  // kFwdRows x AC
  const int row0 = blockIdx.x * kFwdRows;
  auto build = [&](int d0) {
    basis_chunk<G, false, TX, true>(LoadX<TX>{x, D}, A_s, kFwdRows, row0, n, d0, D, cs, inv_h);
  };
  fkan::chunked_forward<G, false, TW, TX>(build, A_s, row0, n, D, O, nullptr, w, nullptr, out);
}

// One 32-row tile per block. Thread t owns feature d0 + t % DC of RPT rows
// (row group t / DC) in each feature chunk.
template <typename TX, typename TW, int G>
__global__ void __launch_bounds__(kThreads)
rbf_dx_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ dout,
              TX* __restrict__ dx, int n, int D, int O, Centers cs, float inv_h, float k2) {
  using S = fkan::Shape<G, false>;
  constexpr int DC = S::DC, AC = S::AC;
  constexpr int RPT = kDxRows * DC / kThreads;  // rows a thread: 4, 2 or 1
  constexpr int pitch = AC + 1;  // odd pitch: conflict-free staging stores
  extern __shared__ __align__(16) float smem[];
  float* dout_s = smem;                       // kDxRows x O
  float* w_s = dout_s + (size_t)kDxRows * O;  // kOT x pitch, [o - o0][g*DC + j]
  const int dd = threadIdx.x % DC;
  const int rg = threadIdx.x / DC;  // row groups of RPT rows
  const int r0 = blockIdx.x * kDxRows;
  for (int i = threadIdx.x; i < kDxRows * O; i += kThreads) {
    const int row = r0 + i / O;
    dout_s[i] = row < n ? to_f(dout[(size_t)r0 * O + i]) : 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += DC) {
    float acc[RPT][G];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[i][g] = 0.f;
    // dbasis = dout @ W^T for the chunk, one kOT-wide tile of outputs at a
    // time so that shared memory does not grow with O; acc sums over o in
    // order
    for (int o0 = 0; o0 < O; o0 += kOT) {
      const int on = min(kOT, O - o0);
      __syncthreads();  // dout_s is complete; the previous tile is done with w_s
      for (int i = threadIdx.x; i < on * AC; i += kThreads) {
        const int o = i % on, rest = i / on;
        const int j = rest % DC, g = rest / DC;
        const int d = d0 + j;
        w_s[o * pitch + g * DC + j] = d < D ? to_f(w[((size_t)g * D + d) * O + o0 + o]) : 0.f;
      }
      __syncthreads();
      for (int o = 0; o < on; ++o) {
        float wv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) wv[g] = w_s[o * pitch + g * DC + dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dv = dout_s[(rg * RPT + i) * O + o0 + o];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[i][g] += dv * wv[g];
        }
      }
    }
    const int d = d0 + dd;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = r0 + rg * RPT + i;
      if (row >= n) continue;
      float b[G], dist[G];
      rbf<G, TX>(to_f(x[(size_t)row * D + d]), cs, inv_h, b, dist);
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s += ((acc[i][g] * b[g]) * k2) * dist[g];
      dx[(size_t)row * D + d] = from_f<TX>(s);
    }
  }
}

// grid (feature chunks, row tiles, output tiles): the f32 partial
// B^T @ dout of rows [t*tile, (t+1)*tile) for one (chunk, output tile).
// Thread t owns 4 output columns (t % 16) x KPT basis columns (t / 16).
template <typename TX, int G>
__global__ void __launch_bounds__(kThreads)
rbf_dw_partial_kernel(const TX* __restrict__ x, const TX* __restrict__ dout,
                      float* __restrict__ partial, int n, int D, int O, Centers cs, float inv_h,
                      int tile) {
  using S = fkan::Shape<G, false>;
  constexpr int DC = S::DC, AC = S::AC;
  constexpr int KPT = (AC + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                    // kDwRows x AC
  float* dout_s = smem + kDwRows * AC;  // kDwRows x kOT
  const int d0 = blockIdx.x * DC;
  const int o0 = blockIdx.z * kOT;
  const int og = threadIdx.x % 16, kg = threadIdx.x / 16;
  const int rbeg = blockIdx.y * tile;
  const int rend = min(n, rbeg + tile);
  const LoadX<TX> load{x, D};
  float acc[KPT][4];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int r0 = rbeg; r0 < rend; r0 += kDwRows) {
    __syncthreads();  // the previous step's products are done
    basis_chunk<G, false, TX>(load, A_s, kDwRows, r0, rend, d0, D, cs, inv_h);
    for (int i = threadIdx.x; i < kDwRows * kOT; i += kThreads) {
      const int row = r0 + i / kOT, o = o0 + i % kOT;
      dout_s[i] = (row < rend && o < O) ? to_f(dout[(size_t)row * O + o]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kDwRows; ++r) {
      const float4 dv = *reinterpret_cast<const float4*>(dout_s + r * kOT + og * 4);
      const float* a = A_s + r * AC + kg * KPT;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // columns past AC only where AC is not a multiple of 16
        const float av = AC % 16 == 0 || kg * KPT + j < AC ? a[j] : 0.f;
        acc[j][0] += av * dv.x;
        acc[j][1] += av * dv.y;
        acc[j][2] += av * dv.z;
        acc[j][3] += av * dv.w;
      }
    }
  }
  float* part = partial + (size_t)blockIdx.y * G * D * O;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int c = kg * KPT + j;
    const int d = d0 + c % DC;
    if (c >= AC || d >= D) continue;
    const size_t row = (size_t)(c / DC) * D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) part[row * O + o] = acc[j][q];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename TX, typename TW, int G>
int launch_fwd(const void* x, const void* w, void* out, int n, int D, int O, Centers cs,
               float inv_h, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kFwdRows * fkan::Shape<G, false>::AC;
  if (int e = set_smem(rbf_fwd_kernel<TX, TW, G>, smem)) return e;
  dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
  if (grid.x > 0 && grid.y > 0)
    rbf_fwd_kernel<TX, TW, G><<<grid, kThreads, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), n, D, O,
        cs, inv_h);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, int G>
int launch_bwd(const void* x, const void* w, const void* dout, void* dx, float* partial,
               void* dw, int n, int D, int O, Centers cs, float inv_h, float k2, int tile,
               cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TX* gt = static_cast<const TX*>(dout);
  if (dx != nullptr && n > 0) {
    const size_t smem =
        sizeof(float) * ((size_t)kDxRows * O + (size_t)kOT * (fkan::Shape<G, false>::AC + 1));
    if (smem > kan::kSmemLimit) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(rbf_dx_kernel<TX, TW, G>, smem)) return e;
    rbf_dx_kernel<TX, TW, G><<<(n + kDxRows - 1) / kDxRows, kThreads, smem, stream>>>(
        xt, static_cast<const TW*>(w), gt, static_cast<TX*>(dx), n, D, O, cs, inv_h, k2);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const int tiles = (n + tile - 1) / tile;
  if (tiles > 0) {
    const size_t smem =
        sizeof(float) * ((size_t)kDwRows * fkan::Shape<G, false>::AC + kDwRows * kOT);
    if (int e = set_smem(rbf_dw_partial_kernel<TX, G>, smem)) return e;
    constexpr int DC = fkan::Shape<G, false>::DC;
    dim3 grid((D + DC - 1) / DC, tiles, (O + kOT - 1) / kOT);
    rbf_dw_partial_kernel<TX, G><<<grid, kThreads, smem, stream>>>(xt, gt, partial, n, D, O, cs,
                                                               inv_h, tile);
    if (int e = (int)cudaGetLastError()) return e;
  }
  return kan::walk_tiles<float, TW>(partial, static_cast<TW*>(dw), tiles, (size_t)G * D * O,
                                    false, stream);
}

Centers centers_of(const float* c, int G) {
  Centers cs{};
  for (int g = 0; g < G && g < fkan::kMaxG; ++g) cs.c[g] = c[g];
  return cs;
}

}  // namespace

// Calls FN<TX, TW, FKAN_G>(args...) for x and w types f32/bf16 and returns
// cudaErrorInvalidValue for another type or number of centers.
#define RBF_DISPATCH(xd, wd, G_, FN, ...)                                              \
  do {                                                                                 \
    using bf16 = __nv_bfloat16;                                                        \
    if (G_ != FKAN_G) return (int)cudaErrorInvalidValue;                               \
    if (xd == kan::kF32 && wd == kan::kF32) return FN<float, float, FKAN_G>(__VA_ARGS__); \
    if (xd == kan::kF32 && wd == kan::kBF16) return FN<float, bf16, FKAN_G>(__VA_ARGS__); \
    if (xd == kan::kBF16 && wd == kan::kF32) return FN<bf16, float, FKAN_G>(__VA_ARGS__); \
    if (xd == kan::kBF16 && wd == kan::kBF16) return FN<bf16, bf16, FKAN_G>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                                 \
  } while (0)

// out (n, O) in x's type = basis(x) @ w. x (n, D); w (G*D, O) g-major;
// device memory, contiguous. centers: G floats in host memory, already
// rounded to x's type, as inv_h.
extern "C" int rbf_fwd(const void* x, const void* w, void* out, int n, int d, int o, int G,
                       const float* centers, float inv_h, int x_dtype, int w_dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  RBF_DISPATCH(x_dtype, w_dtype, G, launch_fwd, x, w, out, n, d, o, cs, inv_h, s);
}

// dx (n, D) in x's type (skipped when dx is null) and dw (G*D, O) in w's
// type, from dout (n, O) in x's type. dscale = -2 * inv_h in f32 (inv_h
// unrounded: the JAX kernel's derivative factor). partial: f32 scratch of
// ceil(n / tile) * G*D*O floats.
extern "C" int rbf_bwd(const void* x, const void* w, const void* dout, void* dx, float* partial,
                       void* dw, int n, int d, int o, int G, const float* centers, float inv_h,
                       float dscale, int tile, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  RBF_DISPATCH(x_dtype, w_dtype, G, launch_bwd, x, w, dout, dx, partial, dw, n, d, o, cs,
               inv_h, dscale, tile, s);
}
