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
// tensor-core ridge of about 295: device-memory bytes bound it. The forward
// computes its product on the CUDA cores in f32, so its time is set by
// issue rate, not by bytes; the basis matrix never leaves the SM.
//
// The backward, under bf16, runs both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32 accumulators): the
// JAX `preferred_element_type=f32` products, exact products summed in f32
// in another order. (wgmma needs 64-row warpgroup tiles fed by shared-memory
// descriptors; the per-(row, feature) ladder epilogue here wants each
// thread to hold all of a feature's groups, which the m16n8 fragment layout
// gives directly. Moving to wgmma is later work.) In f32 the products stay
// on the CUDA cores (TF32 would miss the f32 bars). Launches (the wrapper
// runs 1 on a second stream, beside 2 and 3 on the caller's: they share
// only their inputs, and the dx kernel's one block an SM leaves room for
// the dW kernel's):
//   1. dx. bf16: dx_mma_kernel, persistent blocks each own one 32-feature
//      chunk and stage its weights [Wb; Ws] once in shared memory, ordered
//      so that warp nw's 8 n-tiles of 8 columns are the NG groups of
//      features nw*8 .. nw*8+7; then per 32-row tile dbasis = dout @ W^T on
//      the tensor cores, and each thread, holding every group of its
//      (row, feature) pairs in its accumulators, rebuilds the Cox-de Boor
//      ladder (kan::ladder) with its penultimate bases and writes dx. The
//      tiles' dout and x go through two shared-memory buffers, the next
//      tile's copied with cp.async while this one computes. f32:
//      dx_kernel, the same function on the CUDA cores, 64-row tiles, the
//      chunk's weights staged one 64-wide output tile at a time;
//   2. dW partials, one per row tile of the JAX backward (128 rows): the
//      TPU kernel adds them across its sequential grid; Hopper blocks run in
//      parallel, so each (feature chunk, tile) block writes its partial of
//      [SiLU(x) | B(x)]^T @ dout, rounded to the weights' dtype (exact: the
//      walk rounds it first). bf16: dw_mma_kernel builds the tile's basis in
//      shared memory (rounded to bf16 as the JAX kernel casts it) and runs
//      the product on the tensor cores; f32: dw_partial_kernel on the CUDA
//      cores;
//   3. kan::walk_tiles adds the partials in tile order, rounding the running
//      sum after each tile, as `dw_ref += partial.astype(dw.dtype)`. The
//      partials are walked in windows of at most 128 MiB of scratch that
//      carry the running sum (1,323 tiles of 524,288 bf16 at (256, 256) are
//      1.39 GB: 11 windows). Partials rather than blocks that own a dW tile and walk
//      the rows themselves: each (row, feature) ladder is then built once,
//      and 1,323 x D/32 blocks fill the card, where an in-block walk runs
//      as many blocks as dW has 64 x 64 tiles (8 at (64, 64)).
// No atomics: the result is deterministic.

#include "kan_common.cuh"

namespace {

using namespace kan;

constexpr int kDxRows = 64;   // rows per tile of the f32 dx kernel: 8 row groups of 8
constexpr int kDwRows = 32;   // rows per step of the f32 dW partial kernel
constexpr int kTile = 128;    // rows per tile of the JAX backward (DEFAULT_TILE_N)
constexpr int kMmaRows = 32;  // rows per tile of the bf16 dx kernel

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

// f32: grid (D chunks, row tiles t0.. of one window, O tiles): the partial
// of rows [t*kTile, (t+1)*kTile). Thread t owns 4 output columns (t % 16) x
// KPT basis columns (t / 16) of the chunk's (AC, kOT) block.
template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ knots,
                  const T* __restrict__ dout, T* __restrict__ partial, int n, int D, int O,
                  int t0) {
  using S = Shape<ORDER, GRID>;
  constexpr int KPT = S::AC / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                      // kDwRows x AC
  float* dout_s = smem + kDwRows * S::AC; // kDwRows x kOT
  const int d0 = blockIdx.x * kDC;
  const int o0 = blockIdx.z * kOT;
  const int og = threadIdx.x % 16, kg = threadIdx.x / 16;
  const int rbeg = (t0 + blockIdx.y) * kTile;
  const int rend = min(n, rbeg + kTile);
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
  T* part = partial + blockIdx.y * ((size_t)S::NG * D * O);
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int c = kg * KPT + j;
    const int d = d0 + c % kDC;
    if (d >= D) continue;
    const size_t gc = (size_t)(c / kDC) * D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) part[gc * O + o] = from_f<T>(acc[j][q]);
    }
  }
}

// ---- bf16 backward on the tensor cores -------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane t gives the address of row t % 8 of matrix
// t / 8. TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// two 8x8 b16 matrices (lanes 0..15 give the addresses)
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8, f32) += a (16x16, bf16, row) @ b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global src to shared dst without passing through registers;
// in flight until a cp.async.wait_group that covers its commit group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of `cols` bf16 (row r from src(r), or zeros where src(r)
// is null) into dst (pitch elements a row), and zero columns cols..cpad-1.
// With `wide` (every source row 16-byte aligned, cols % 8 == 0) the copies
// are cp.async of 16 bytes: they land once the caller has committed them and
// waited (cp_async_wait, then a barrier). Otherwise plain stores, in place
// at the next barrier.
template <typename Src>
__device__ __forceinline__ void stage_rows(bf16* dst, int pitch, int rows, int cols, int cpad,
                                           bool wide, Src src) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (wide) {
    const int vpr = cpad / 8;  // 16-byte packs a row
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, c = (i % vpr) * 8;
      const bf16* sr = src(r);
      bf16* d = dst + (size_t)r * pitch + c;
      if (sr != nullptr && c < cols)
        cp_async16(d, sr + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cpad; i += kThreads) {
      const int r = i / cpad, c = i % cpad;
      const bf16* sr = src(r);
      dst[(size_t)r * pitch + c] = (sr != nullptr && c < cols) ? sr[c] : zero;
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

constexpr int kXPitch = kDC + 8;  // bf16 a row of the dx kernel's staged x tile

// dx under bf16. grid (persistent row blocks, D chunks). Shared memory:
// W_s (AC x (O16 + 8)): row n = nw*NG*8 + g*8 + l holds [Wb; Ws] row
// (g, d0 + nw*8 + l), so warp (mw, nw) (8 warps: 2 x 4) computes rows
// mw*16.. of the 32-row tile against NG n-tiles that are the NG groups of
// its 8 features; two buffers of the tile's dout (32 x (O16 + 8)) and of its
// x chunk (32 x kXPitch). The next tile's dout and x are copied with
// cp.async while this one computes (W_s lands with the first tile), so the
// epilogue reads x from shared memory. One block an SM (about 170 registers
// a thread): two at 128 registers, with the knots in shared memory and x
// loaded ahead of the barrier, measured slower on the H100.
template <int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
dx_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ knots,
              const bf16* __restrict__ wb, const bf16* __restrict__ ws,
              const bf16* __restrict__ dout, bf16* __restrict__ dx, int n, int D, int O) {
  using S = Shape<ORDER, GRID>;
  constexpr int NG = S::NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int O16 = round_up(O, 16), pitch = O16 + 8;
  bf16* W_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dout_s = W_s + (size_t)S::AC * pitch;         // 2 buffers
  bf16* x_s = dout_s + (size_t)2 * kMmaRows * pitch;  // 2 buffers
  const int d0 = blockIdx.y * kDC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / 4, nw = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int stride = gridDim.x * kMmaRows;
  // the tile at rows r0.. into buffer b
  auto stage = [&](int r0, int b) {
    stage_rows(dout_s + (size_t)b * kMmaRows * pitch, pitch, kMmaRows, O, O16, O % 8 == 0,
               [&](int r) -> const bf16* {
                 return r0 + r < n ? dout + (size_t)(r0 + r) * O : nullptr;
               });
    stage_rows(x_s + (size_t)b * kMmaRows * kXPitch, kXPitch, kMmaRows, min(kDC, D - d0), kDC,
               D % 8 == 0, [&](int r) -> const bf16* {
                 return r0 + r < n ? x + (size_t)(r0 + r) * D + d0 : nullptr;
               });
  };
  stage_rows(W_s, pitch, S::AC, O, O16, O % 8 == 0, [&](int r) -> const bf16* {
    const int q = r / (NG * 8), g = (r % (NG * 8)) / 8, l = r % 8;
    const int d = d0 + q * 8 + l;
    return d < D ? weight_row(wb, ws, g, d, D, O) : nullptr;
  });
  stage(blockIdx.x * kMmaRows, 0);
  cp_async_commit();
  // this thread's two features and their knots
  float t[2][S::NK];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int d = d0 + nw * 8 + tig * 2 + p;
#pragma unroll
    for (int j = 0; j < S::NK; ++j) t[p][j] = d < D ? to_f(knots[(size_t)j * D + d]) : 0.f;
  }
  int buf = 0;
  for (int r0 = blockIdx.x * kMmaRows; r0 < n; r0 += stride, buf ^= 1) {
    __syncthreads();  // the tile before this one is done with the buffer staged next
    if (r0 + stride < n) stage(r0 + stride, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and W_s) landed for every thread
    const bf16* dt = dout_s + (size_t)buf * kMmaRows * pitch;
    const bf16* xt = x_s + (size_t)buf * kMmaRows * kXPitch;
    float acc[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
    for (int k0 = 0; k0 < O16; k0 += 16) {
      unsigned a[4];
      ldmatrix_x4<false>(a, dt + (size_t)(mw * 16 + (lane / 8 % 2) * 8 + lane % 8) * pitch + k0 +
                                (lane / 16) * 8);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        unsigned b[2];
        ldmatrix_x2(b, W_s + (size_t)(nw * NG * 8 + g * 8 + lane % 8) * pitch + k0 +
                           (lane / 8 % 2) * 8);
        mma_bf16(acc[g], a, b[0], b[1]);
      }
    }
    // acc[g][2*h + p] is dbasis of row mw*16 + gid + 8*h, group g, feature
    // d0 + nw*8 + tig*2 + p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rt = mw * 16 + gid + 8 * h, row = r0 + rt;
      if (row >= n) continue;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j = nw * 8 + tig * 2 + p, d = d0 + j;
        if (d >= D) continue;
        const float xv = to_f(xt[rt * kXPitch + j]);
        float v = acc[0][2 * h + p] * dsilu(xv, sigmoid(xv));
        float b[S::NK - 1], pen[S::NK - ORDER];
        ladder<ORDER, S::NK>(xv, t[p], b, pen);
#pragma unroll
        for (int g = 0; g < S::NB; ++g) {
          const float left = pen[g] * (1.f / (t[p][g + ORDER] - t[p][g]));
          const float right = pen[g + 1] * (1.f / (t[p][g + ORDER + 1] - t[p][g + 1]));
          v += acc[g + 1][2 * h + p] * ((float)ORDER * (left - right));
        }
        dx[(size_t)row * D + d] = from_f<bf16>(v);
      }
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
}

// dW partials under bf16. grid (D chunks, row tiles t0.. of one window).
// Shared memory: A_s (kTile x (AC + 8)), the tile's [SiLU(x) | B(x)]
// rounded to bf16, column g*kDC + j for feature d0 + j; dout_s (kTile x
// (O64 + 8)), copied with cp.async while the block builds the basis (a
// block owns one tile, so there is no next tile to double-buffer: the
// resident blocks of an SM overlap each other's copies and products).
// Per 64-wide output pass, warp w computes the 16-row m-tiles w, w + 8, ..
// of A^T @ dout (M = AC, K = kTile rows, N = 64) and writes them rounded to
// bf16.
template <int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ knots,
              const bf16* __restrict__ dout, bf16* __restrict__ partial, int n, int D, int O,
              int t0) {
  using S = Shape<ORDER, GRID>;
  constexpr int pa = S::AC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int O64 = round_up(O, 64), po = O64 + 8;
  bf16* A_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dout_s = A_s + (size_t)kTile * pa;
  const int d0 = blockIdx.x * kDC;
  const int rbeg = (t0 + blockIdx.y) * kTile;
  const int rows = min(kTile, n - rbeg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  stage_rows(dout_s, po, kTile, O, O64, O % 8 == 0, [&](int r) -> const bf16* {
    return r < rows ? dout + (size_t)(rbeg + r) * O : nullptr;
  });
  cp_async_commit();

  {  // the basis of the tile: thread t owns feature d0 + t % kDC
    const int j = threadIdx.x % kDC, d = d0 + j;
    float t[S::NK];
#pragma unroll
    for (int q = 0; q < S::NK; ++q) t[q] = d < D ? to_f(knots[(size_t)q * D + d]) : 0.f;
    for (int r = threadIdx.x / kDC; r < kTile; r += kThreads / kDC) {
      bf16* a = A_s + (size_t)r * pa + j;
      if (d < D && r < rows) {
        const float xv = to_f(x[(size_t)(rbeg + r) * D + d]);
        a[0] = from_f<bf16>(xv * sigmoid(xv));
        float b[S::NK - 1];
        ladder<ORDER, S::NK>(xv, t, b, nullptr);
#pragma unroll
        for (int g = 0; g < S::NB; ++g) a[(g + 1) * kDC] = from_f<bf16>(b[g]);
      } else {
#pragma unroll
        for (int g = 0; g < S::NG; ++g) a[g * kDC] = from_f<bf16>(0.f);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the basis and dout landed for every thread

  bf16* part = partial + blockIdx.y * ((size_t)S::NG * D * O);
  const bool pairs = O % 2 == 0;
  for (int o0 = 0; o0 < O; o0 += 64) {
    for (int mt = warp; mt < S::AC / 16; mt += kThreads / 32) {
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        unsigned a[4];
        ldmatrix_x4<true>(a, A_s + (size_t)(k0 + (lane / 16) * 8 + lane % 8) * pa + mt * 16 +
                                 (lane / 8 % 2) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b[4];
          ldmatrix_x4<true>(b, dout_s + (size_t)(k0 + (lane / 8 % 2) * 8 + lane % 8) * po + o0 +
                                   np * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
      // acc[nt][2*h + p]: A column mt*16 + gid + 8*h, output o0 + nt*8 + tig*2 + p
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = mt * 16 + gid + 8 * h;
        const int d = d0 + c % kDC;
        if (d >= D) continue;
        bf16* prow = part + ((size_t)(c / kDC) * D + d) * O;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int o = o0 + nt * 8 + tig * 2;
          if (pairs && o + 1 < O) {
            *reinterpret_cast<__nv_bfloat162*>(prow + o) =
                __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
          } else {
            if (o < O) prow[o] = from_f<bf16>(acc[nt][2 * h]);
            if (o + 1 < O) prow[o + 1] = from_f<bf16>(acc[nt][2 * h + 1]);
          }
        }
      }
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

// dx (the caller may put it on a stream of its own: it shares nothing with
// the dW launches but their inputs).
template <typename T, int ORDER, int GRID>
int launch_dx(const void* x, const void* knots, const void* wb, const void* ws,
              const void* dout, void* dx, int n, int D, int O, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(knots);
  const T* gt = static_cast<const T*>(dout);
  if (n == 0) return 0;
  if constexpr (std::is_same_v<T, bf16>) {
    const int chunks = (D + kDC - 1) / kDC;
    const size_t smem = sizeof(bf16) * ((size_t)(S::AC + 2 * kMmaRows) * (round_up(O, 16) + 8) +
                                        2 * kMmaRows * kXPitch);
    if (int e = set_smem(dx_mma_kernel<ORDER, GRID>, smem)) return e;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int tiles = (n + kMmaRows - 1) / kMmaRows;
    dim3 grid(std::max(1, std::min(tiles, (2 * sms + chunks - 1) / chunks)), chunks);
    dx_mma_kernel<ORDER, GRID><<<grid, kThreads, smem, stream>>>(
        xt, kt, static_cast<const T*>(wb), static_cast<const T*>(ws), gt, static_cast<T*>(dx),
        n, D, O);
  } else {
    const size_t smem = sizeof(float) * ((size_t)kDxRows * O + (size_t)kOT * (S::AC + 1));
    if (int e = set_smem(dx_kernel<T, ORDER, GRID>, smem)) return e;
    dx_kernel<T, ORDER, GRID><<<(n + kDxRows - 1) / kDxRows, kThreads, smem, stream>>>(
        xt, kt, static_cast<const T*>(wb), static_cast<const T*>(ws), gt, static_cast<T*>(dx),
        n, D, O);
  }
  return (int)cudaGetLastError();
}

// The dW partials of `window` tiles at a time, each window walked into dw
// (carrying the running sum).
template <typename T, int ORDER, int GRID>
int launch_dw(const void* x, const void* knots, const void* dout, void* partial, void* dw, int n,
              int D, int O, int window, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  constexpr bool kMma = std::is_same_v<T, bf16>;
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(knots);
  const T* gt = static_cast<const T*>(dout);
  T* pt = static_cast<T*>(partial);
  const int chunks = (D + kDC - 1) / kDC;
  size_t smem;
  if constexpr (kMma) {
    smem = sizeof(bf16) * (size_t)kTile * (S::AC + 8 + round_up(O, 64) + 8);
    if (int e = set_smem(dw_mma_kernel<ORDER, GRID>, smem)) return e;
  } else {
    smem = sizeof(float) * ((size_t)kDwRows * S::AC + kDwRows * kOT);
    if (int e = set_smem(dw_partial_kernel<T, ORDER, GRID>, smem)) return e;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const size_t m = (size_t)S::NG * D * O;
  for (int t0 = 0; t0 < tiles || t0 == 0; t0 += window) {
    const int wt = std::max(0, std::min(window, tiles - t0));
    if (wt > 0) {
      if constexpr (kMma) {
        dw_mma_kernel<ORDER, GRID><<<dim3(chunks, wt), kThreads, smem, stream>>>(xt, kt, gt, pt,
                                                                                 n, D, O, t0);
      } else {
        dw_partial_kernel<T, ORDER, GRID>
            <<<dim3(chunks, wt, (O + kOT - 1) / kOT), kThreads, smem, stream>>>(xt, kt, gt, pt,
                                                                               n, D, O, t0);
      }
      if (int e = (int)cudaGetLastError()) return e;
    }
    if (int e = kan::walk_tiles<T, T>(pt, static_cast<T*>(dw), wt, m, t0 > 0, stream)) return e;
  }
  return 0;
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

// dx (n, D) from dout (n, O); x (n, D), knots (K, D), wb (D, O), ws
// (NB*D, O), all of one dtype, device memory, contiguous.
extern "C" int bspline_bwd_dx(const void* x, const void* knots, const void* wb, const void* ws,
                              const void* dout, void* dx, int n, int d, int o, int grid,
                              int order, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch_dx, x, knots, wb, ws, dout, dx, n, d, o, s);
}

// dw (NG*D, O) = [dWb; dWs] from dout (n, O), summed over row tiles of 128
// in tile order. partial: scratch of window * NG*D*O elements of the
// inputs' dtype.
extern "C" int bspline_bwd_dw(const void* x, const void* knots, const void* dout, void* partial,
                              void* dw, int n, int d, int o, int grid, int order, int dtype,
                              int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch_dw, x, knots, dout, partial, dw, n, d, o, window, s);
}
