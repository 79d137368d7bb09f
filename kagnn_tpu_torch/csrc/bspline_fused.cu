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
// tensor-core ridge of about 295: device-memory bytes bound it (operations
// at the GAT transform's (256, 256)). The basis matrix never leaves the SM.
//
// The forward, under bf16, runs its product on the tensor cores
// (bspline_fwd_mma_kernel, its body in kan_fwd.cuh, which gin_fused.cu
// shares): persistent blocks of 128-row tiles and all
// outputs (or parts of 256), the bf16 basis of a feature chunk built once
// per block (basis_tile_bf16, the same tile the dW kernel builds) and
// multiplied with the chunk's weight slab, staged with cp.async (once, where
// the weights fit; else two slabs taking turns). In f32 it stays on the CUDA
// cores (bspline_fwd_kernel: 32-row tiles x 64 outputs).
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
//   1. dx. bf16: bspline_dx_mma_kernel, persistent blocks each own one 32-feature
//      chunk and stage its weights [Wb; Ws] once in shared memory, ordered
//      so that warp nw's 8 n-tiles of 8 columns are the NG groups of
//      features nw*8 .. nw*8+7; then per 32-row tile dbasis = dout @ W^T on
//      the tensor cores, and each thread, holding every group of its
//      (row, feature) pairs in its accumulators, rebuilds the Cox-de Boor
//      ladder (kan::ladder) with its penultimate bases and writes dx. The
//      tiles' dout and x go through two shared-memory buffers, the next
//      tile's copied with cp.async while this one computes. Where the
//      chunk's weights do not fit beside the tiles (wide outputs at large
//      basis counts) they are staged in output pieces per tile instead. f32:
//      bspline_dx_kernel, the same function on the CUDA cores, 64-row tiles (16 or
//      32 at large basis counts), the chunk's weights staged one 64-wide
//      (or 32-wide) output tile at a time. Both stage whole rows of dout;
//      where those do not fit in a block (past about 650 outputs in f32 and
//      1,650 in bf16 at the main path's basis count) the outputs are cut into
//      parts of a width the caller plans (kernels/bspline_fused.py
//      `bwd_parts`), each part's f32 share of dx goes to scratch, and
//      bspline_dx_sum_kernel adds the parts in order (rbf_fused.cu's
//      design). With one part nothing changes: no scratch, no extra launch;
//   2. dW partials, one per row tile of the JAX backward (128 rows): the
//      TPU kernel adds them across its sequential grid; Hopper blocks run in
//      parallel, so each (feature chunk, tile) block writes its partial of
//      [SiLU(x) | B(x)]^T @ dout, rounded to the weights' dtype (exact: the
//      walk rounds it first). bf16: bspline_dw_mma_kernel builds the tile's basis in
//      shared memory (rounded to bf16 as the JAX kernel casts it) and runs
//      the product on the tensor cores; f32: bspline_dw_partial_kernel on the CUDA
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
//
// Shapes: each library is built for one (spline order, grid size), any
// order 1-4 and grid 1-16 (KAN_ORDER, KAN_GRID; kernels/_build.py), as the
// JAX kernels take the order and basis count as parameters. D and O are
// free: the dx kernels cut wide outputs into parts, the dW kernels stage
// them in parts (kernels/bspline_fused.py::bwd_smem sizes a part).

#include "kan_fwd.cuh"

namespace {

using namespace kan;

constexpr int kDwRows = 32;   // rows per step of the f32 dW partial kernel
constexpr int kTile = 128;    // rows per tile of the JAX backward (DEFAULT_TILE_N)
constexpr int kMmaRows = 32;  // rows per tile of the bf16 dx kernel
constexpr int kDwCols = 256;  // basis columns of one f32 dW partial block

// The f32 dx kernel's tiling at NG groups: RPT rows a thread (8 row groups
// of RPT rows: fewer at large NG, where the accumulators of all NG groups
// fill the registers) and OTX outputs a staged weight tile (narrower at
// large NG, where a chunk has more basis columns).
template <int NG> struct DxF32 {
  static constexpr int RPT = NG <= 9 ? 8 : (NG <= 14 ? 4 : 2);
  static constexpr int ROWS = 8 * RPT;
  static constexpr int OTX = NG * kDC <= 320 ? kOT : 32;
};

template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
bspline_fwd_kernel(const T* __restrict__ x, const T* __restrict__ knots, const T* __restrict__ wb,
                   const T* __restrict__ ws, T* __restrict__ out, int n, int D, int O) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * kFwdRows;
  auto load = [&](int, int row, int d) { return to_f(x[(size_t)row * D + d]); };
  kan_forward_tile<T, ORDER, GRID>(load, smem, row0, n, D, O, knots, wb, ws, out);
}

// The forward under bf16, on the tensor cores: kan_fwd.cuh's body on x.
// grid (persistent row blocks, output parts of plan.op).
template <int ORDER, int GRID, int NPW>
__global__ void __launch_bounds__(kThreads, kKanFwdBlocks<ORDER, GRID, NPW>)
bspline_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ knots,
                       const bf16* __restrict__ wb, const bf16* __restrict__ ws,
                       bf16* __restrict__ out, int n, int D, int O, FwdPlan plan) {
  kan_fwd_mma_body<bf16, ORDER, GRID, NPW>(x, knots, wb, ws, out, n, D, O, plan);
}

// grid (row tiles of X::ROWS, output parts of OP): the block stages its
// rows' dout over the part's outputs once. With one part (OP = O) it writes
// dx, with several the part's f32 share into vbuf.
template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
bspline_dx_kernel(const T* __restrict__ x, const T* __restrict__ knots, const T* __restrict__ wb,
                  const T* __restrict__ ws, const T* __restrict__ dout, T* __restrict__ dx,
                  float* __restrict__ vbuf, int n, int D, int O, int OP) {
  using S = Shape<ORDER, GRID>;
  using X = DxF32<S::NG>;
  constexpr int RPT = X::RPT;
  constexpr int pitch = S::AC + 1;  // odd pitch: conflict-free staging stores
  extern __shared__ __align__(16) float smem[];
  float* dout_s = smem;                 // ROWS x OP
  float* w_s = smem + X::ROWS * OP;     // OTX x pitch, [o - o0][g*kDC + j]
  const int row0 = blockIdx.x * X::ROWS;
  const int dd = threadIdx.x % kDC;
  const int rg = threadIdx.x / kDC;  // 8 row groups of RPT rows
  const int part = blockIdx.y, op = part * OP, kw = min(OP, O - op);

  for (int i = threadIdx.x; i < X::ROWS * kw; i += kThreads) {
    const int r = i / kw, row = row0 + r;
    dout_s[r * OP + i % kw] = row < n ? to_f(dout[(size_t)row * O + op + i % kw]) : 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += kDC) {
    float acc[RPT][S::NG];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int g = 0; g < S::NG; ++g) acc[i][g] = 0.f;
    // the chunk's weights one OTX-wide tile of outputs at a time, so that
    // shared memory does not grow with O; acc sums over o in order
    for (int o0 = 0; o0 < kw; o0 += X::OTX) {
      const int on = min(X::OTX, kw - o0);
      __syncthreads();  // dout_s is complete; the previous tile is consumed
      for (int i = threadIdx.x; i < on * S::AC; i += kThreads) {
        const int o = i % on, rest = i / on;
        const int j = rest % kDC, g = rest / kDC;
        const int d = d0 + j;
        w_s[o * pitch + g * kDC + j] =
            d < D ? to_f(weight_row(wb, ws, g, d, D, O)[op + o0 + o]) : 0.f;
      }
      __syncthreads();
      for (int o = 0; o < on; ++o) {
        float w[S::NG];
#pragma unroll
        for (int g = 0; g < S::NG; ++g) w[g] = w_s[o * pitch + g * kDC + dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dv = dout_s[(rg * RPT + i) * OP + o0 + o];
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
      for (int i = 0; i < RPT; ++i) {
        const int row = row0 + rg * RPT + i;
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
        if (vbuf != nullptr)
          vbuf[((size_t)part * n + row) * D + d] = v;
        else
          dx[(size_t)row * D + d] = from_f<T>(v);
      }
    }
  }
}

// f32: grid (D chunks, row tiles t0.. of one window, O tiles x column
// splits): the partial of rows [t*kTile, (t+1)*kTile). A block owns kOT
// outputs and kDwCols of the chunk's AC basis columns (all of them up to
// NG = 8; at larger NG the blocks of a chunk split its columns, each
// building the whole basis chunk); thread t owns 4 output columns (t % 16) x
// KPT basis columns (t / 16) of that block.
template <typename T, int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
bspline_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ knots,
                          const T* __restrict__ dout, T* __restrict__ partial, int n, int D, int O,
                          int t0) {
  using S = Shape<ORDER, GRID>;
  constexpr int CB = S::AC < kDwCols ? S::AC : kDwCols;  // basis columns a block
  constexpr int KPT = CB / 16;
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                      // kDwRows x AC
  float* dout_s = smem + kDwRows * S::AC; // kDwRows x kOT
  const int d0 = blockIdx.x * kDC;
  const int otiles = (O + kOT - 1) / kOT;
  const int o0 = (blockIdx.z % otiles) * kOT;
  const int c0 = (blockIdx.z / otiles) * CB;
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
      const float* a = A_s + r * S::AC + c0 + kg * KPT;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // columns past AC only in the last split of a chunk wider than a block
        const float av = S::AC <= kDwCols || c0 + kg * KPT + j < S::AC ? a[j] : 0.f;
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
    const int c = c0 + kg * KPT + j;
    const int d = d0 + c % kDC;
    if (c >= S::AC || d >= D) continue;
    const size_t gc = (size_t)(c / kDC) * D + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + og * 4 + q;
      if (o < O) part[gc * O + o] = from_f<T>(acc[j][q]);
    }
  }
}

// ---- bf16 backward on the tensor cores -------------------------------------

constexpr int kXPitch = kDC + 8;  // bf16 a row of the dx kernel's staged x tile

// dx under bf16. grid (persistent row blocks, D chunks, output parts of
// OP). A block takes the outputs o0p .. o0p + OP - 1 of its part (all of
// them, OP = O16, unless two buffers of the tile's dout rows do not fit:
// very wide outputs). Shared memory: W_s (AC x (OW + 8)): row n = nw*NG*8 +
// g*8 + l holds columns o0..o0+OW-1 of the part's [Wb; Ws] row (g, d0 +
// nw*8 + l), so warp (mw, nw) (8 warps: 2 x 4) computes rows mw*16.. of the
// 32-row tile against NG n-tiles that are the NG groups of its 8 features;
// two buffers of the tile's dout (32 x (OP + 8)) and of its x chunk (32 x
// kXPitch). The next tile's dout and x are copied with cp.async while this
// one computes, so the epilogue reads x from shared memory. When the
// chunk's weights fit (OW = the part's width, every main path) W_s is
// staged once, with the first tile, and stays; otherwise (wide outputs at
// large basis counts) the tile's product walks the part in OW-wide pieces,
// each staged in turn, and acc sums over them in order. With one part the
// block writes dx, with several the part's f32 share (linear in its dbasis)
// into vbuf. One block an SM at the main path's shape (about 170 registers
// a thread): two at 128 registers, with the knots in shared memory and x
// loaded ahead of the barrier, measured slower on the H100.
template <int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
bspline_dx_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ knots,
                      const bf16* __restrict__ wb, const bf16* __restrict__ ws,
                      const bf16* __restrict__ dout, bf16* __restrict__ dx,
                      float* __restrict__ vbuf, int n, int D, int O, int OP, int OW) {
  using S = Shape<ORDER, GRID>;
  constexpr int NG = S::NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int part = blockIdx.z, o0p = part * OP;
  const int kw = min(OP, O - o0p), k16 = round_up(kw, 16);  // the part's outputs
  const int pitch = OP + 8, wpitch = OW + 8;
  const bool resident = OW >= k16;
  bf16* W_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dout_s = W_s + (size_t)S::AC * wpitch;        // 2 buffers
  bf16* x_s = dout_s + (size_t)2 * kMmaRows * pitch;  // 2 buffers
  const int d0 = blockIdx.y * kDC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / 4, nw = warp % 4;
  const int gid = lane / 4, tig = lane % 4;
  const int stride = gridDim.x * kMmaRows;
  // the tile at rows r0.. into buffer b
  auto stage = [&](int r0, int b) {
    stage_rows(dout_s + (size_t)b * kMmaRows * pitch, pitch, kMmaRows, kw, k16, O % 8 == 0,
               [&](int r) -> const bf16* {
                 return r0 + r < n ? dout + (size_t)(r0 + r) * O + o0p : nullptr;
               });
    stage_rows(x_s + (size_t)b * kMmaRows * kXPitch, kXPitch, kMmaRows, min(kDC, D - d0), kDC,
               D % 8 == 0, [&](int r) -> const bf16* {
                 return r0 + r < n ? x + (size_t)(r0 + r) * D + d0 : nullptr;
               });
  };
  // columns o0.. of the part's weights of the chunk
  auto stage_w = [&](int o0) {
    stage_rows(W_s, wpitch, S::AC, min(OW, kw - o0), OW, O % 8 == 0, [&](int r) -> const bf16* {
      const int q = r / (NG * 8), g = (r % (NG * 8)) / 8, l = r % 8;
      const int d = d0 + q * 8 + l;
      return d < D ? weight_row(wb, ws, g, d, D, O) + o0p + o0 : nullptr;
    });
  };
  if (resident) stage_w(0);
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
    __syncthreads();  // this tile (and a resident W_s) landed for every thread
    const bf16* dt = dout_s + (size_t)buf * kMmaRows * pitch;
    const bf16* xt = x_s + (size_t)buf * kMmaRows * kXPitch;
    float acc[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
    for (int o0 = 0; o0 < k16; o0 += OW) {
      if (!resident) {
        __syncthreads();  // the previous part's products are done with W_s
        stage_w(o0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int kend = min(OW, k16 - o0);
      for (int k0 = 0; k0 < kend; k0 += 16) {
        unsigned a[4];
        ldmatrix_x4<false>(a, dt + (size_t)(mw * 16 + (lane / 8 % 2) * 8 + lane % 8) * pitch +
                                  o0 + k0 + (lane / 16) * 8);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          unsigned b[2];
          ldmatrix_x2(b, W_s + (size_t)(nw * NG * 8 + g * 8 + lane % 8) * wpitch + k0 +
                             (lane / 8 % 2) * 8);
          mma_bf16(acc[g], a, b[0], b[1]);
        }
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
        if (vbuf != nullptr)
          vbuf[((size_t)part * n + row) * D + d] = v;
        else
          dx[(size_t)row * D + d] = from_f<bf16>(v);
      }
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
}

// dx = the sum over the output parts, in order, of their shares
template <typename T>
__global__ void bspline_dx_sum_kernel(const float* __restrict__ vbuf, T* __restrict__ dx,
                                      size_t m, int parts) {
  sum_parts<T>(vbuf, dx, m, parts);
}

// dW partials under bf16. grid (D chunks, row tiles t0.. of one window).
// Shared memory: A_s (kTile x (AC + 8)), the tile's [SiLU(x) | B(x)]
// rounded to bf16, column g*kDC + j for feature d0 + j; dout_s (kTile x
// (OPW + 8)), copied with cp.async while the block builds the basis (a
// block owns one tile, so there is no next tile to double-buffer: the
// resident blocks of an SM overlap each other's copies and products).
// OPW (a multiple of 64) is every output (O64) unless the basis and the
// outputs do not fit beside each other (wide outputs at large basis
// counts): then the outputs go in OPW-wide parts, each staged after the
// last, against the one basis. Per 64-wide output pass, warp w computes the
// 16-row m-tiles w, w + 8, .. of A^T @ dout (M = AC, K = kTile rows, N =
// 64) and writes them rounded to bf16.
template <int ORDER, int GRID>
__global__ void __launch_bounds__(kThreads)
bspline_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ knots,
                      const bf16* __restrict__ dout, bf16* __restrict__ partial, int n,
                      int D, int O, int t0, int OPW) {
  using S = Shape<ORDER, GRID>;
  constexpr int pa = S::AC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int po = OPW + 8;
  bf16* A_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dout_s = A_s + (size_t)kTile * pa;
  const int d0 = blockIdx.x * kDC;
  const int rbeg = (t0 + blockIdx.y) * kTile;
  const int rows = min(kTile, n - rbeg);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  // outputs op0.. of the tile's dout
  auto stage_d = [&](int op0) {
    stage_rows(dout_s, po, kTile, min(OPW, O - op0), OPW, O % 8 == 0, [&](int r) -> const bf16* {
      return r < rows ? dout + (size_t)(rbeg + r) * O + op0 : nullptr;
    });
  };
  stage_d(0);
  cp_async_commit();

  // the basis of the tile (kan_common.cuh, shared with the forward)
  basis_tile_bf16<ORDER, GRID, kDC>(
      [&](int, int row, int d) { return to_f(x[(size_t)row * D + d]); }, A_s, pa, kTile, rbeg,
      rows, d0, D, knots);
  cp_async_wait<0>();
  __syncthreads();  // the basis and dout landed for every thread

  bf16* part = partial + blockIdx.y * ((size_t)S::NG * D * O);
  const bool pairs = O % 2 == 0;
  for (int op0 = 0; op0 < O; op0 += OPW) {
    if (op0 > 0) {
      __syncthreads();  // the previous part's products are done with dout_s
      stage_d(op0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int o0 = op0; o0 < min(O, op0 + OPW); o0 += 64) {
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
            ldmatrix_x4<true>(b, dout_s + (size_t)(k0 + (lane / 8 % 2) * 8 + lane % 8) * po +
                                     o0 - op0 + np * 16 + (lane / 16) * 8);
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
}

// The forward's launch: bf16 on the tensor cores (bspline_fwd_mma_kernel,
// persistent blocks, the widest output part that fits), f32 on the CUDA cores
// (bspline_fwd_kernel: TF32 would miss the f32 bars).
template <typename T, int ORDER, int GRID>
int launch_fwd(const void* x, const void* knots, const void* wb, const void* ws, void* out,
               int n, int D, int O, cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_fwd_mma<bf16, ORDER, GRID>(
        [](auto npw) { return bspline_fwd_mma_kernel<ORDER, GRID, decltype(npw)::value>; },
        static_cast<const bf16*>(x), static_cast<const bf16*>(knots),
        static_cast<const bf16*>(wb), static_cast<const bf16*>(ws), static_cast<bf16*>(out), n,
        D, O, stream);
  } else {
    const size_t smem = sizeof(float) * kFwdRows * S::AC;
    if (int e = set_smem(bspline_fwd_kernel<T, ORDER, GRID>, smem)) return e;
    dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
    if (grid.x > 0)
      bspline_fwd_kernel<T, ORDER, GRID><<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(knots), static_cast<const T*>(wb),
          static_cast<const T*>(ws), static_cast<T*>(out), n, D, O);
  }
  return (int)cudaGetLastError();
}

// shared memory of bspline_dx_mma_kernel with OP-wide output parts and
// OW-wide weight pieces (kernels/bspline_fused.py::bwd_smem mirrors it)
template <int ORDER, int GRID>
size_t dx_mma_smem(int OP, int OW) {
  return sizeof(bf16) * ((size_t)Shape<ORDER, GRID>::AC * (OW + 8) +
                         (size_t)2 * kMmaRows * (OP + 8) + 2 * kMmaRows * kXPitch);
}

// dx in output parts of OP (the caller's plan, kernels/bspline_fused.py
// `bwd_parts`: one part of every output where its staged rows fit; in bf16
// OP is a multiple of 16), the parts' shares in vbuf summed in order where
// there are several. The caller may put it on a stream of its own: it
// shares nothing with the dW launches but their inputs.
template <typename T, int ORDER, int GRID>
int launch_dx(const void* x, const void* knots, const void* wb, const void* ws,
              const void* dout, void* dx, float* vbuf, int n, int D, int O, int OP,
              cudaStream_t stream) {
  using S = Shape<ORDER, GRID>;
  const T* xt = static_cast<const T*>(x);
  const T* kt = static_cast<const T*>(knots);
  const T* gt = static_cast<const T*>(dout);
  if (n == 0) return 0;
  if (OP <= 0) return (int)cudaErrorInvalidValue;
  const int parts = (O + OP - 1) / OP;
  if (parts > 1 && vbuf == nullptr) return (int)cudaErrorInvalidValue;
  float* shares = parts > 1 ? vbuf : nullptr;
  if constexpr (std::is_same_v<T, bf16>) {
    if (OP % 16 != 0) return (int)cudaErrorInvalidValue;
    const int chunks = (D + kDC - 1) / kDC;
    int OW = std::min(OP, round_up(O, 16));  // the widest weight piece that fits
    while (OW > 16 && dx_mma_smem<ORDER, GRID>(OP, OW) > kSmemLimit) OW -= 16;
    const size_t smem = dx_mma_smem<ORDER, GRID>(OP, OW);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(bspline_dx_mma_kernel<ORDER, GRID>, smem)) return e;
    const int sms = sm_count();
    const int tiles = (n + kMmaRows - 1) / kMmaRows;
    const int blocks = chunks * parts;
    dim3 grid(std::max(1, std::min(tiles, (2 * sms + blocks - 1) / blocks)), chunks, parts);
    bspline_dx_mma_kernel<ORDER, GRID><<<grid, kThreads, smem, stream>>>(
        xt, kt, static_cast<const T*>(wb), static_cast<const T*>(ws), gt, static_cast<T*>(dx),
        shares, n, D, O, OP, OW);
  } else {
    using X = DxF32<S::NG>;
    const size_t smem = sizeof(float) * ((size_t)X::ROWS * OP + (size_t)X::OTX * (S::AC + 1));
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(bspline_dx_kernel<T, ORDER, GRID>, smem)) return e;
    bspline_dx_kernel<T, ORDER, GRID>
        <<<dim3((n + X::ROWS - 1) / X::ROWS, parts), kThreads, smem, stream>>>(
            xt, kt, static_cast<const T*>(wb), static_cast<const T*>(ws), gt,
            static_cast<T*>(dx), shares, n, D, O, OP);
  }
  if (int e = (int)cudaGetLastError()) return e;
  if (parts > 1) {
    const size_t m = (size_t)n * D;
    bspline_dx_sum_kernel<T><<<sum_parts_blocks(m), kThreads, 0, stream>>>(
        vbuf, static_cast<T*>(dx), m, parts);
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
  int OPW = round_up(O, 64);  // the widest output part that fits beside the basis
  int zdim = 1;
  if constexpr (kMma) {
    auto need = [&](int w) { return sizeof(bf16) * (size_t)kTile * (S::AC + 8 + w + 8); };
    while (OPW > 64 && need(OPW) > kSmemLimit) OPW -= 64;
    smem = need(OPW);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(bspline_dw_mma_kernel<ORDER, GRID>, smem)) return e;
  } else {
    smem = sizeof(float) * ((size_t)kDwRows * S::AC + kDwRows * kOT);
    if (int e = set_smem(bspline_dw_partial_kernel<T, ORDER, GRID>, smem)) return e;
    zdim = ((O + kOT - 1) / kOT) * ((S::AC + kDwCols - 1) / kDwCols);
  }
  const int tiles = (n + kTile - 1) / kTile;
  const size_t m = (size_t)S::NG * D * O;
  for (int t0 = 0; t0 < tiles || t0 == 0; t0 += window) {
    const int wt = std::max(0, std::min(window, tiles - t0));
    if (wt > 0) {
      if constexpr (kMma) {
        bspline_dw_mma_kernel<ORDER, GRID><<<dim3(chunks, wt), kThreads, smem, stream>>>(
            xt, kt, gt, pt, n, D, O, t0, OPW);
      } else {
        bspline_dw_partial_kernel<T, ORDER, GRID>
            <<<dim3(chunks, wt, zdim), kThreads, smem, stream>>>(
            xt, kt, gt, pt, n, D, O, t0);
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
// (NB*D, O), all of one dtype, device memory, contiguous. op: the width of
// the outputs' parts (kernels/bspline_fused.py `bwd_parts`); vbuf: f32
// scratch of ceil(o / op) * n * d floats where that is more than one part,
// else unused.
extern "C" int bspline_bwd_dx(const void* x, const void* knots, const void* wb, const void* ws,
                              const void* dout, void* dx, float* vbuf, int n, int d, int o,
                              int op, int grid, int order, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KAN_DISPATCH(dtype, order, grid, launch_dx, x, knots, wb, ws, dout, dx, vbuf, n, d, o, op, s);
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
