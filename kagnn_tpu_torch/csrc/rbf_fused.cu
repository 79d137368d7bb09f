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
// in bf16, around the tensor cores' ridge of about 295; the (N, G*D) basis
// never leaves the SM. Where w is bf16 (the base-free FastKAN under bf16, x
// f32; the layernorm-free layer, x bf16) the forward runs its products on
// the tensor cores (rbf_fwd_mma_kernel, fastkan_fwd.cuh's body without the
// layer, the design of the FastKAN forward's: persistent blocks of 64-row
// tiles owning all of their outputs, weight slabs staged with cp.async, each
// (row, feature) basis built once for every output). The JAX kernel builds
// the basis in x's type and takes jnp.dot(basis, w) in f32: an f32 basis is
// split into three bf16 terms, the value whole (the output is f32; two
// terms, the FastKAN forward's split, miss the f32 bar), a bf16 x's rounded
// basis is one term, exact; the products go to f32
// accumulators and the output, in x's type, is rounded once. Before this
// design it multiplied on the CUDA cores in f32, where the SMs' instruction
// rate set its time (0.551 ms at (64, 64), x f32 / w bf16, on the H100,
// PERF.md §6). Where w is f32 the forward stays on the CUDA cores
// (rbf_fwd_kernel: a 32-row tile x 64 outputs a block, the basis built a
// chunk at a time in shared memory with the distance rounded to x's type):
// TF32 products would miss the f32 bars.
//
// The backward runs as up to four launches on the caller's stream. Where W
// is bf16 (the base-free FastKAN under bf16, x f32; the layernorm-free
// layer, x bf16) its products run on the tensor cores (mma.sync.m16n8k16,
// bf16 operands, f32 accumulators; the design of fastkan_layer.cu's
// backward without the LayerNorm and the SiLU group):
//   1. rbf_dx_mma_kernel (skipped when x needs no gradient): persistent
//      blocks each own one feature chunk and one part of the outputs (all
//      of them unless the chunk's weights and two row tiles do not fit),
//      stage the chunk's weights once, ordered so that warp (mw, nw)'s
//      n-tiles of 8 columns are the groups of its 8 features, and walk row
//      tiles, the next tile's dout and x copied with cp.async while this one
//      computes. Per tile dbasis = dout @ W^T on the tensor cores: an f32
//      dout is split into three bf16 terms as its fragments are loaded
//      (kan::split_terms' arithmetic: the terms carry the f32 value whole,
//      and W is exact in bf16, so the products are the JAX kernel's f32
//      products; a split once a tile in shared memory for the warps that
//      share its rows measured no faster on the H100), a bf16 dout is one
//      term; each 16 outputs' products go to a
//      fresh accumulator added to the running sum in f32. Each thread then
//      rebuilds B_g and d_g of its (row, feature) pairs and sums dbasis *
//      B_g * (-2 inv_h) * d_g over g in registers. With several output
//      parts each part's share goes to f32 scratch and
//   2. rbf_dx_sum_kernel adds the parts in order;
//   3. rbf_dw_mma_kernel: a block per (feature chunk, JAX row tile) builds
//      the chunk's f32 basis for 64 rows at a time, split into three bf16
//      terms (two failed the FastKAN backward's walk bar at (256, 256) on
//      the H100), and multiplies it with the step's dout on the tensor
//      cores: a bf16 dout as it is (three products), an f32 one split into
//      three terms too, of which the six products hi*hi, hi*mid, mid*hi,
//      hi*lo, mid*mid and lo*hi are taken (the rest are below 2^-24 of the
//      product); each 16-row step's products go to a fresh accumulator
//      added to the tile's in f32, written as the tile's f32 partial;
//   4. kan::walk_tiles adds the partials in tile order, rounding as above.
// Where W is f32 the same steps run on the CUDA cores (rbf_dx_kernel,
// rbf_dw_partial_kernel), as the f32 layer forwards do: TF32 products
// would miss the f32 bars. No atomics: the result is deterministic.
//
// Shapes: any number of centers 2-32 (one library each, FKAN_G; the feature
// chunk narrows past 8 centers, fastkan_common.cuh), any D, and any O: the
// dx kernels cut the outputs into parts that fit in shared memory.

#include "fastkan_fwd.cuh"

namespace {

using fkan::basis_chunk;
using fkan::Centers;
using fkan::rbf;
using kan::bf16;
using kan::cp_async_commit;
using kan::cp_async_wait;
using kan::from_f;
using kan::kFwdRows;
using kan::kOT;
using kan::kThreads;
using kan::round_up;
using kan::set_smem;
using kan::stage_rows;
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

// w in f32, on the CUDA cores. grid (row tiles, output tiles); the basis is
// rounded to x's type before the product, as the JAX forward has it.
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

// w in bf16, on the tensor cores: fastkan_fwd.cuh's body without the
// layer (no LayerNorm, SiLU or bias), out in x's type. grid (persistent row
// blocks, output parts of plan.op).
template <typename TX, int G, int NPW>
__global__ void __launch_bounds__(kThreads, NPW == 1 ? 3 : 2)
rbf_fwd_mma_kernel(const TX* __restrict__ x, const bf16* __restrict__ w, TX* __restrict__ out,
                   int n, int D, int O, Centers cs, float inv_h, kan::FwdPlan plan) {
  fkan::fwd_mma_body<TX, TX, G, false, NPW>(x, nullptr, nullptr, w, nullptr, nullptr, out, n, D,
                                            O, cs, inv_h, plan);
}

// ---- the backward on the CUDA cores (W in f32) -----------------------------

// grid (row tiles of kDxRows, output parts of OW). Thread t owns feature
// d0 + t % DC of RPT rows (row group t / DC) in each feature chunk; the
// block stages its rows' dout over the part's outputs once. With one part
// it writes dx, with several the part's f32 share into vbuf.
template <typename TX, typename TW, int G>
__global__ void __launch_bounds__(kThreads)
rbf_dx_kernel(const TX* __restrict__ x, const TW* __restrict__ w, const TX* __restrict__ dout,
              TX* __restrict__ dx, float* __restrict__ vbuf, int n, int D, int O, int OW,
              Centers cs, float inv_h, float k2) {
  using S = fkan::Shape<G, false>;
  constexpr int DC = S::DC, AC = S::AC;
  constexpr int RPT = kDxRows * DC / kThreads;  // rows a thread: 4, 2 or 1
  constexpr int pitch = AC + 1;  // odd pitch: conflict-free staging stores
  extern __shared__ __align__(16) float smem[];
  float* dout_s = smem;                        // kDxRows x OW
  float* w_s = dout_s + (size_t)kDxRows * OW;  // kOT x pitch, [o - o0][g*DC + j]
  const int dd = threadIdx.x % DC;
  const int rg = threadIdx.x / DC;  // row groups of RPT rows
  const int r0 = blockIdx.x * kDxRows;
  const int part = blockIdx.y, op = part * OW, ow = min(OW, O - op);
  for (int i = threadIdx.x; i < kDxRows * ow; i += kThreads) {
    const int row = r0 + i / ow;
    dout_s[(i / ow) * OW + i % ow] = row < n ? to_f(dout[(size_t)row * O + op + i % ow]) : 0.f;
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
    for (int o0 = 0; o0 < ow; o0 += kOT) {
      const int on = min(kOT, ow - o0);
      __syncthreads();  // dout_s is complete; the previous tile is done with w_s
      for (int i = threadIdx.x; i < on * AC; i += kThreads) {
        const int o = i % on, rest = i / on;
        const int j = rest % DC, g = rest / DC;
        const int d = d0 + j;
        w_s[o * pitch + g * DC + j] =
            d < D ? to_f(w[((size_t)g * D + d) * O + op + o0 + o]) : 0.f;
      }
      __syncthreads();
      for (int o = 0; o < on; ++o) {
        float wv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) wv[g] = w_s[o * pitch + g * DC + dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dv = dout_s[(rg * RPT + i) * OW + o0 + o];
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
      if (vbuf != nullptr)
        vbuf[((size_t)part * n + row) * D + d] = s;
      else
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

// The CUDA-core dx kernel's output part: the widest multiple of kOT whose
// staged dout rows fit in a block beside one weight tile (all of O where it
// fits: every main path).
template <int G>
int dx_part_width_f32(int O) {
  const size_t fixed = sizeof(float) * (size_t)kOT * (fkan::Shape<G, false>::AC + 1);
  const int per = (int)((kan::kSmemLimit - fixed) / (sizeof(float) * kDxRows)) / kOT * kOT;
  return std::min(round_up(O, kOT), per);
}

// ---- the backward on the tensor cores (W in bf16) --------------------------

// The dx kernel's tiling at G centers: DC features a chunk (Shape<G,
// false>), NW warps along them (8 features each) and MW along the rows (16
// each), so a tile has R rows; the products take the groups GB at a time.
// dout and x tiles have a pitch of 8 values past their width (16 bytes in
// bf16, 32 in f32: the f32 fragment loads of a half-warp then hit 32
// distinct banks).
template <int G> struct DxTile {
  static constexpr int DC = fkan::Shape<G, false>::DC;
  static constexpr int NW = DC / 8;
  static constexpr int MW = 8 / NW;
  static constexpr int R = 16 * MW;
  static constexpr int GB = G < 8 ? G : 8;
};
constexpr int kPad = 8;

// bf16 terms of an f32 operand on the tensor cores: three carry it whole
template <typename TX>
constexpr int kTermsOf = std::is_same_v<TX, float> ? 3 : 1;

// Shared memory of rbf_dx_mma_kernel with OW-wide output parts and nb
// buffers a tile: the chunk's weights (G*DC x (OW + 8) bf16), the dout tiles
// (nb x R x (OW + 8)) and x tiles (nb x R x (DC + 8)) in TX.
template <typename TX, int G>
size_t dx_smem(int OW, int nb) {
  using X = DxTile<G>;
  return sizeof(bf16) * (size_t)G * X::DC * (OW + kPad) +
         sizeof(TX) * (size_t)nb * X::R * (OW + kPad + X::DC + kPad);
}

// The widest output part (a multiple of 16) whose rbf_dx_mma_kernel fits in
// a block (0 if none does), and its buffers a tile: 2, unless 1 lets two
// blocks share an SM where 2 does not (wide outputs).
template <typename TX, int G>
int dx_part_width(int O, int& nb) {
  int OW = round_up(O, 16);
  while (OW > 16 && dx_smem<TX, G>(OW, 1) > kan::kSmemLimit) OW -= 16;
  if (dx_smem<TX, G>(OW, 1) > kan::kSmemLimit) return 0;
  const size_t half = kan::kSmemLimit / 2 - 1024;  // two blocks an SM, with the runtime's share
  nb = dx_smem<TX, G>(OW, 2) <= kan::kSmemLimit &&
               (dx_smem<TX, G>(OW, 2) <= half || dx_smem<TX, G>(OW, 1) > half)
           ? 2
           : 1;
  return OW;
}

// B_g(x) and its scaled distance d_g for one center c, rounded as fkan::rbf
// rounds them for x of type TX (the backward's f32 exp)
template <typename TX>
__device__ __forceinline__ float basis_of(float x, float c, float inv_h, float& dist) {
  dist = kan::round_t<TX>(kan::round_t<TX>(x - c) * inv_h);
  return expf(-kan::round_t<TX>(dist * dist));
}

// The A fragments (16 rows from m0, 16 columns from k0) of a row-major tile
// t (pitch p) for mma.sync.m16n8k16, as TERMS bf16 terms: a bf16 tile by
// ldmatrix (one term); an f32 one value pair by value pair, each pair split
// as kan::split_terms splits it (the value rounded to bf16, then each rest).
template <int TERMS>
__device__ __forceinline__ void a_terms(unsigned (&a)[TERMS][4], const bf16* t, int p, int m0,
                                        int k0) {
  const int lane = threadIdx.x % 32;
  kan::ldmatrix_x4<false>(a[0], t + (size_t)(m0 + (lane / 8 % 2) * 8 + lane % 8) * p + k0 +
                                    (lane / 16) * 8);
}

template <int TERMS>
__device__ __forceinline__ void a_terms(unsigned (&a)[TERMS][4], const float* t, int p, int m0,
                                        int k0) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // (row gid, gid + 8) x (columns 2*tig, 2*tig + 8)
    const float2 v = *reinterpret_cast<const float2*>(
        t + (size_t)(m0 + gid + 8 * (i & 1)) * p + k0 + 2 * tig + 8 * (i >> 1));
    float v0 = v.x, v1 = v.y;
#pragma unroll
    for (int q = 0; q < TERMS; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      a[q][i] = *reinterpret_cast<const unsigned*>(&h);
      const float2 f = __bfloat1622float2(h);
      v0 -= f.x;
      v1 -= f.y;
    }
  }
}

// Blocks an SM that the tensor-core kernels ask the compiler to leave
// registers for (__launch_bounds__).
constexpr int kDxBlocks = 2;
constexpr int kDwBlocks = 2;

// rbf_dx_mma_kernel: grid (persistent row blocks, D chunks, output parts of
// OW). With one part it writes dx, with several the part's f32 share
// (linear in its dbasis) into vbuf. See the file's header.
template <typename TX, int G>
__global__ void __launch_bounds__(kThreads, kDxBlocks)
rbf_dx_mma_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                  const TX* __restrict__ dout, TX* __restrict__ dx, float* __restrict__ vbuf,
                  int n, int D, int O, int OW, int nb, Centers cs, float inv_h, float k2) {
  using X = DxTile<G>;
  constexpr int DC = X::DC, NW = X::NW, R = X::R, GB = X::GB, TERMS = kTermsOf<TX>;
  constexpr int V = 16 / sizeof(TX);  // values of a 16-byte copy
  constexpr int XP = DC + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int part = blockIdx.z, o0 = part * OW;
  const int kw = min(OW, O - o0);  // outputs of this part
  const int k16 = round_up(kw, 16);
  const int wp = OW + kPad, dp = OW + kPad;
  bf16* W_s = reinterpret_cast<bf16*>(smem_raw);                   // G*DC x wp
  TX* d_s = reinterpret_cast<TX*>(W_s + (size_t)G * DC * wp);       // nb x R x dp
  TX* x_s = d_s + (size_t)nb * R * dp;                              // nb x R x XP
  const int d0 = blockIdx.y * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / NW, nw = warp % NW;
  const int gid = lane / 4, tig = lane % 4;
  const int stride = gridDim.x * R;
  const bool wide_d = O % V == 0, wide_x = D % V == 0;
  // the tile at rows r0.. into buffer b
  auto stage = [&](int r0, int b) {
    stage_rows(d_s + (size_t)b * R * dp, dp, R, kw, k16, wide_d, [&](int r) -> const TX* {
      return r0 + r < n ? dout + (size_t)(r0 + r) * O + o0 : nullptr;
    });
    stage_rows(x_s + (size_t)b * R * XP, XP, R, min(DC, D - d0), DC, wide_x,
               [&](int r) -> const TX* {
                 return r0 + r < n ? x + (size_t)(r0 + r) * D + d0 : nullptr;
               });
  };
  // the chunk's weights, once: row q*G*8 + g*8 + l is group g of feature
  // d0 + q*8 + l
  stage_rows(W_s, wp, G * DC, kw, k16, O % 8 == 0, [&](int r) -> const bf16* {
    const int q = r / (G * 8), g = (r % (G * 8)) / 8, l = r % 8;
    const int d = d0 + q * 8 + l;
    return d < D ? w + ((size_t)g * D + d) * O + o0 : nullptr;
  });
  stage(blockIdx.x * R, 0);
  cp_async_commit();
  int buf = 0;
  for (int r0 = blockIdx.x * R; r0 < n; r0 += stride, buf ^= nb - 1) {
    __syncthreads();  // the tile before this one is done with the buffers reused next
    if (nb == 2) {  // the next tile flies while this one computes
      if (r0 + stride < n) stage(r0 + stride, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (r0 != blockIdx.x * R) stage(r0, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and W_s) landed for every thread
    const TX* dt = d_s + (size_t)buf * R * dp;
    const TX* xt = x_s + (size_t)buf * R * XP;
    // pair q = 2*h + p: row mw*16 + gid + 8*h, feature d0 + nw*8 + tig*2 + p
    float xv[4], dxs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      xv[q] = to_f(xt[(mw * 16 + gid + 8 * (q / 2)) * XP + nw * 8 + tig * 2 + q % 2]);
#pragma unroll
    for (int g0 = 0; g0 < G; g0 += GB) {
      float acc[GB][4];
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < k16; k0 += 16) {
        unsigned a[TERMS][4];
        a_terms<TERMS>(a, dt, dp, mw * 16, k0);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g0 + g >= G) continue;
          unsigned b[2];
          kan::ldmatrix_x2(b, W_s + (size_t)(nw * G * 8 + (g0 + g) * 8 + lane % 8) * wp + k0 +
                                  (lane / 8 % 2) * 8);
          // the step's products in a fresh accumulator, added in f32
          float st[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int t = 0; t < TERMS; ++t) kan::mma_bf16(st, a[t], b[0], b[1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g][q] += st[q];
        }
      }
      // acc[g][q]: dbasis of pair q, group g0 + g; the derivative of B_g,
      // rounded as the JAX kernel computes it in x's type
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const int gg = g0 + g;
        if (gg >= G) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float dist;
          const float b = basis_of<TX>(xv[q], cs.c[gg], inv_h, dist);
          dxs[q] += ((acc[g][q] * b) * k2) * dist;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + mw * 16 + gid + 8 * (q / 2), d = d0 + nw * 8 + tig * 2 + q % 2;
      if (row >= n || d >= D) continue;
      if (vbuf != nullptr)
        vbuf[((size_t)part * n + row) * D + d] = dxs[q];
      else
        dx[(size_t)row * D + d] = from_f<TX>(dxs[q]);
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
}

// dx[i] = the sum over the output parts, in order, of their shares
template <typename TX>
__global__ void rbf_dx_sum_kernel(const float* __restrict__ vbuf, TX* __restrict__ dx, size_t m,
                                  int parts) {
  kan::sum_parts<TX>(vbuf, dx, m, parts);
}

constexpr int kSub = 64;    // rows per step of the dW kernel
constexpr int kTasks = 2;   // 16 x 64 output blocks a warp of the dW kernel holds
constexpr int kBasisTerms = 3;  // bf16 terms of each f32 basis value
// the (basis term, dout term) products of an f32 dout: the six whose
// product is above 2^-24 of the whole, p = 0..5: hi*hi, hi*mid, mid*hi,
// hi*lo, mid*mid, lo*hi
constexpr int kPairs = 6;
__host__ __device__ constexpr int pair_a(int p) { return p == 2 || p == 4 ? 1 : (p == 5 ? 2 : 0); }
__host__ __device__ constexpr int pair_b(int p) { return p == 1 || p == 4 ? 1 : (p == 3 ? 2 : 0); }

// The dW kernel's layout at G centers and dout in TX: the feature chunk
// dcw, the output pass opw (a multiple of 64, or every output) and the
// M-splits msplit of each block, so that a block has at most 8 * kTasks
// tasks and fits in shared memory; least (passes + 32 / dcw) per block an
// SM (each pass rebuilds the basis, each narrower chunk restages dout).
struct DwPlan {
  int dcw, opw, msplit;
  size_t smem;
};

// Shared memory of rbf_dw_mma_kernel: the basis terms (3 x kSub x (M + 8)
// bf16), dout (bf16: two buffers of kSub x (opw + 8); f32: one buffer of
// kSub x (opw + 4) f32 and its three bf16 terms, kSub x (opw + 8) each) and
// one buffer of the x chunk (kSub x (dcw + 8) in TX).
template <typename TX>
size_t dw_smem(int M, int opw, int dcw) {
  const size_t terms = sizeof(bf16) * kBasisTerms * kSub * (size_t)(M + 8);
  const size_t d = std::is_same_v<TX, float>
                       ? sizeof(float) * kSub * (size_t)(opw + 4) +
                             sizeof(bf16) * 3 * kSub * (size_t)(opw + 8)
                       : sizeof(bf16) * 2 * kSub * (size_t)(opw + 8);
  return terms + d + sizeof(TX) * kSub * (size_t)(dcw + kPad);
}

template <typename TX, int G>
bool plan_dw(int O, DwPlan& best) {
  const int O16 = round_up(O, 16);
  float least = 1e30f;
  for (int c = 32; c >= 8; c /= 2) {
    const int MT = round_up(G * c, 16) / 16;
    const int ms = (MT + 8 * kTasks - 1) / (8 * kTasks);  // M-splits
    const int per = (MT + ms - 1) / ms;                    // m-tiles a split
    const int ow = std::min(O16, std::max(1, 8 * kTasks / per) * 64);
    const size_t need = dw_smem<TX>(MT * 16, ow, c);
    if (need > kan::kSmemLimit) continue;
    const int blocks = need <= kan::kSmemLimit / 2 - 1024 ? 2 : 1;  // an SM
    const float cost = ((float)((O + ow - 1) / ow * ms) + 32.f / c) / blocks;
    if (cost < least) {
      least = cost;
      best = {c, ow, ms, need};
    }
  }
  return least < 1e30f;
}

// dW partials where W is bf16. grid (chunks of dcw features, JAX row tiles,
// output passes of opw x M-splits). Per 64-row step: x and dout staged with
// cp.async (the next step's issued once this one's basis is built), then
// every thread builds the basis terms (column g*dcw + j = B_g of feature
// d0 + j, zeros past D and past the tile's rows; and for an f32 dout its
// three terms), then the warps multiply: the block's 16 x 64 output blocks
// (its M-split's m-tiles x opw / 64) are the warps' tasks, kTasks a warp at
// most, each 16-row step's products in fresh accumulators added to the
// tile's in f32 (the tensor cores' own accumulation chained over 512 rows
// failed the FastKAN walk bar at (256, 256) on the H100). Writes the tile's
// f32 partial.
template <typename TX, int G>
__global__ void __launch_bounds__(kThreads, kDwBlocks)
rbf_dw_mma_kernel(const TX* __restrict__ x, const TX* __restrict__ dout,
                  float* __restrict__ partial, int n, int D, int O, Centers cs, float inv_h,
                  int tile, DwPlan plan) {
  constexpr bool kF32 = std::is_same_v<TX, float>;
  constexpr int V = 16 / sizeof(TX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dcw = plan.dcw, opw = plan.opw, msplit = plan.msplit;
  const int ac = G * dcw;              // basis columns
  const int M = round_up(ac, 16);
  const int MT = M / 16, NP = opw / 16, NQ = (NP + 3) / 4;
  const int mtb = (MT + msplit - 1) / msplit;           // m-tiles a split
  const int mt0 = (blockIdx.z % msplit) * mtb, mt1 = min(MT, mt0 + mtb);
  const int tasks = (mt1 - mt0) * NQ;
  const int pa = M + 8, po = opw + 8, pf = opw + 4, xp = dcw + kPad;
  bf16* A3 = reinterpret_cast<bf16*>(smem_raw);                 // kBasisTerms x kSub x pa
  bf16* dT = A3 + (size_t)kBasisTerms * kSub * pa;              // f32: 3 x kSub x po
  float* f_s = reinterpret_cast<float*>(dT + (size_t)3 * kSub * po);  // f32: kSub x pf
  bf16* d_s = dT;                                               // bf16: 2 x kSub x po
  TX* x_s = kF32 ? reinterpret_cast<TX*>(f_s + (size_t)kSub * pf)
                 : reinterpret_cast<TX*>(d_s + (size_t)2 * kSub * po);  // kSub x xp
  const int d0 = blockIdx.x * dcw;
  const int op0 = (blockIdx.z / msplit) * opw, ow = min(opw, O - op0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int rbeg = blockIdx.y * tile, rend = min(n, rbeg + tile);
  // the step at rows r0..: x always into x_s; dout into f_s (f32) or into
  // bf16 buffer b
  auto stage = [&](int r0, int b) {
    auto drow = [&](int r) -> const TX* {
      return r0 + r < rend ? dout + (size_t)(r0 + r) * O + op0 : nullptr;
    };
    if constexpr (kF32)
      stage_rows(f_s, pf, kSub, ow, opw, O % V == 0, drow);
    else
      stage_rows(d_s + (size_t)b * kSub * po, po, kSub, ow, opw, O % V == 0, drow);
    stage_rows(x_s, xp, kSub, min(dcw, D - d0), dcw, D % V == 0, [&](int r) -> const TX* {
      return r0 + r < rend ? x + (size_t)(r0 + r) * D + d0 : nullptr;
    });
  };
  stage(rbeg, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBasisTerms * kSub * (M - ac); i += kThreads) {
    const int r = i / (M - ac), c = ac + i % (M - ac);
    A3[(size_t)r * pa + c] = zero;
  }
  // this thread's two features (j, j + 1) and rows of A
  const int hw = dcw / 2, j = 2 * (threadIdx.x % hw), d = d0 + j;
  // acc[t][np][nt][q]: task warp + 8*t, its n-pair np, n-tile nt
  float acc[kTasks][4][2][4];
#pragma unroll
  for (int t = 0; t < kTasks; ++t)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][np][nt][q] = 0.f;

  int buf = 0;
  for (int r0 = rbeg; r0 < rend; r0 += kSub, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this step's x and dout landed; the last step's products are done
    for (int r = threadIdx.x / hw; r < kSub; r += kThreads / hw) {
      // B_g of features j, j + 1 (zeros past D or rend) as three bf16 terms
      const bool row_ok = r0 + r < rend;
      const bool ok0 = row_ok && d < D, ok1 = row_ok && d + 1 < D;
      const float x0 = to_f(x_s[r * xp + j]), x1 = to_f(x_s[r * xp + j + 1]);
      bf16* a = A3 + (size_t)r * pa + j;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dist;
        const float b0 = basis_of<TX>(x0, cs.c[g], inv_h, dist);
        const float b1 = basis_of<TX>(x1, cs.c[g], inv_h, dist);
        kan::split_terms<kBasisTerms>(a + g * dcw, (size_t)kSub * pa, ok0 ? b0 : 0.f,
                                      ok1 ? b1 : 0.f);
      }
    }
    if constexpr (kF32) {  // dout's three terms
      const int hp = opw / 2;
      for (int i = threadIdx.x; i < kSub * hp; i += kThreads) {
        const int r = i / hp, c = 2 * (i % hp);
        const float2 v = *reinterpret_cast<const float2*>(f_s + (size_t)r * pf + c);
        kan::split_terms<3>(dT + (size_t)r * po + c, (size_t)kSub * po, v.x, v.y);
      }
    }
    __syncthreads();  // the terms are complete; x_s (and f_s) are free
    if (r0 + kSub < rend) stage(r0 + kSub, buf ^ 1);
    cp_async_commit();
    const bf16* dt = kF32 ? dT : d_s + (size_t)buf * kSub * po;
#pragma unroll
    for (int k0 = 0; k0 < kSub; k0 += 16) {
#pragma unroll
      for (int t = 0; t < kTasks; ++t) {
        const int task = warp + 8 * t;
        if (task >= tasks) continue;
        const int mt = mt0 + task / NQ, nq = task % NQ;
        unsigned a[kBasisTerms][4];
#pragma unroll
        for (int q = 0; q < kBasisTerms; ++q)  // hi, mid, lo
          kan::ldmatrix_x4<true>(a[q], A3 + (size_t)q * kSub * pa +
                                           (size_t)(k0 + (lane / 16) * 8 + lane % 8) * pa +
                                           mt * 16 + (lane / 8 % 2) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (nq * 4 + np >= NP) continue;
          constexpr int DT = kF32 ? 3 : 1;
          unsigned b[DT][4];
#pragma unroll
          for (int q = 0; q < DT; ++q)
            kan::ldmatrix_x4<true>(b[q], dt + (size_t)q * kSub * po +
                                             (size_t)(k0 + (lane / 8 % 2) * 8 + lane % 8) * po +
                                             (nq * 4 + np) * 16 + (lane / 16) * 8);
          float step[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          if constexpr (kF32) {
#pragma unroll
            for (int p = 0; p < kPairs; ++p) {
              kan::mma_bf16(step[0], a[pair_a(p)], b[pair_b(p)][0], b[pair_b(p)][1]);
              kan::mma_bf16(step[1], a[pair_a(p)], b[pair_b(p)][2], b[pair_b(p)][3]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < kBasisTerms; ++q) {
              kan::mma_bf16(step[0], a[q], b[0][0], b[0][1]);
              kan::mma_bf16(step[1], a[q], b[0][2], b[0][3]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[t][np][nt][q] += step[nt][q];
        }
      }
    }
  }
  cp_async_wait<0>();  // the last, empty, commit group
  float* part = partial + (size_t)blockIdx.y * G * D * O;
  const bool pairs = O % 2 == 0;
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    const int task = warp + 8 * t;
    if (task >= tasks) continue;
    const int mt = mt0 + task / NQ, nq = task % NQ;
    // acc[t][np][nt][2*h + p]: A column mt*16 + gid + 8*h, output
    // op0 + (nq*4 + np)*16 + nt*8 + tig*2 + p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = mt * 16 + gid + 8 * h;
      const int dc = d0 + c % dcw;
      if (c >= ac || dc >= D) continue;
      float* prow = part + ((size_t)(c / dcw) * D + dc) * O;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int o = op0 + (nq * 4 + np) * 16 + nt * 8 + tig * 2;
          const float v0 = acc[t][np][nt][2 * h], v1 = acc[t][np][nt][2 * h + 1];
          if (pairs && o + 1 < O) {
            *reinterpret_cast<float2*>(prow + o) = make_float2(v0, v1);
          } else {
            if (o < O) prow[o] = v0;
            if (o + 1 < O) prow[o + 1] = v1;
          }
        }
    }
  }
}

// The forward: on the tensor cores where w is bf16 (rbf_fwd_mma_kernel,
// persistent blocks, the widest output part that fits), else on the CUDA
// cores (rbf_fwd_kernel: TF32 would miss the f32 bars).
template <typename TX, typename TW, int G>
int launch_fwd(const void* x, const void* w, void* out, int n, int D, int O, Centers cs,
               float inv_h, cudaStream_t stream) {
  if constexpr (std::is_same_v<TW, bf16>) {
    return fkan::with_fwd_mma_part<TX, G, false>(n, O, [&](auto npw, int op) {
      auto kernel = rbf_fwd_mma_kernel<TX, G, decltype(npw)::value>;
      dim3 grid;
      const kan::FwdPlan* plan = fkan::fwd_mma_plan<TX, G, false>(kernel, n, D, O, op, grid);
      if (plan == nullptr) return (int)cudaErrorInvalidValue;
      kernel<<<grid, kThreads, plan->smem, stream>>>(static_cast<const TX*>(x),
                                                     static_cast<const bf16*>(w),
                                                     static_cast<TX*>(out), n, D, O, cs, inv_h,
                                                     *plan);
      return (int)cudaGetLastError();
    });
  } else {
    const size_t smem = sizeof(float) * kFwdRows * fkan::Shape<G, false>::AC;
    if (int e = set_smem(rbf_fwd_kernel<TX, TW, G>, smem)) return e;
    dim3 grid((n + kFwdRows - 1) / kFwdRows, (O + kOT - 1) / kOT);
    if (grid.x > 0 && grid.y > 0)
      rbf_fwd_kernel<TX, TW, G><<<grid, kThreads, smem, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), n, D, O,
          cs, inv_h);
  }
  return (int)cudaGetLastError();
}

// The dx kernel's output parts: out[0] = parts of out[1] outputs each.
template <typename TX, typename TW, int G>
int plan_dx(int, int, int O, int* out) {
  int OW;
  if constexpr (std::is_same_v<TW, bf16>) {
    int nb = 2;
    OW = dx_part_width<TX, G>(O, nb);
  } else {
    OW = dx_part_width_f32<G>(O);
  }
  if (OW <= 0) return (int)cudaErrorInvalidValue;
  out[0] = (O + OW - 1) / OW;
  out[1] = OW;
  return 0;
}

// dx: rbf_dx_mma_kernel where W is bf16, else rbf_dx_kernel; the parts'
// shares summed when there are several.
template <typename TX, typename TW, int G>
int launch_dx(const TX* x, const TW* w, const TX* dout, TX* dx, float* vbuf, int n, int D,
              int O, Centers cs, float inv_h, float k2, cudaStream_t stream) {
  int pl[2];
  if (int e = plan_dx<TX, TW, G>(n, D, O, pl)) return e;
  const int parts = pl[0], OW = pl[1];
  float* shares = parts > 1 ? vbuf : nullptr;
  if constexpr (std::is_same_v<TW, bf16>) {
    using X = DxTile<G>;
    int nb = 2;
    dx_part_width<TX, G>(O, nb);
    const size_t smem = dx_smem<TX, G>(OW, nb);
    auto kernel = rbf_dx_mma_kernel<TX, G>;
    if (int e = set_smem(kernel, smem)) return e;
    int per_sm, sms;
    kan::occupancy(kernel, smem, per_sm, sms);
    const int chunks = (D + X::DC - 1) / X::DC;
    const int tiles = (n + X::R - 1) / X::R;
    const int rows = std::max(1, std::min(tiles, (per_sm * sms + chunks * parts - 1) /
                                                     (chunks * parts)));
    kernel<<<dim3(rows, chunks, parts), kThreads, smem, stream>>>(x, w, dout, dx, shares, n, D, O,
                                                                  OW, nb, cs, inv_h, k2);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)kDxRows * OW + (size_t)kOT * (fkan::Shape<G, false>::AC + 1));
    if (int e = set_smem(rbf_dx_kernel<TX, TW, G>, smem)) return e;
    rbf_dx_kernel<TX, TW, G><<<dim3((n + kDxRows - 1) / kDxRows, parts), kThreads, smem,
                               stream>>>(x, w, dout, dx, shares, n, D, O, OW, cs, inv_h, k2);
  }
  if (int e = (int)cudaGetLastError()) return e;
  if (parts > 1) {
    const size_t m = (size_t)n * D;
    rbf_dx_sum_kernel<TX><<<kan::sum_parts_blocks(m), kThreads, 0, stream>>>(vbuf, dx, m, parts);
  }
  return (int)cudaGetLastError();
}

// the tiles' f32 dW partials: rbf_dw_mma_kernel where W is bf16, else
// rbf_dw_partial_kernel
template <typename TX, typename TW, int G>
int launch_dw(const TX* x, const TX* dout, float* partial, int n, int D, int O, Centers cs,
              float inv_h, int tile, int tiles, cudaStream_t stream) {
  if constexpr (std::is_same_v<TW, bf16>) {
    DwPlan plan{};
    if (!plan_dw<TX, G>(O, plan)) return (int)cudaErrorInvalidValue;
    if (int e = set_smem(rbf_dw_mma_kernel<TX, G>, plan.smem)) return e;
    dim3 grid((D + plan.dcw - 1) / plan.dcw, tiles, (O + plan.opw - 1) / plan.opw * plan.msplit);
    rbf_dw_mma_kernel<TX, G><<<grid, kThreads, plan.smem, stream>>>(x, dout, partial, n, D, O,
                                                                    cs, inv_h, tile, plan);
  } else {
    const size_t smem =
        sizeof(float) * ((size_t)kDwRows * fkan::Shape<G, false>::AC + kDwRows * kOT);
    if (int e = set_smem(rbf_dw_partial_kernel<TX, G>, smem)) return e;
    constexpr int DC = fkan::Shape<G, false>::DC;
    dim3 grid((D + DC - 1) / DC, tiles, (O + kOT - 1) / kOT);
    rbf_dw_partial_kernel<TX, G><<<grid, kThreads, smem, stream>>>(x, dout, partial, n, D, O, cs,
                                                                   inv_h, tile);
  }
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, int G>
int launch_bwd(const void* x, const void* w, const void* dout, void* dx, float* vbuf,
               float* partial, void* dw, int n, int D, int O, Centers cs, float inv_h, float k2,
               int tile, cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  const TX* gt = static_cast<const TX*>(dout);
  if (dx != nullptr && n > 0) {
    if (int e = launch_dx<TX, TW, G>(xt, static_cast<const TW*>(w), gt, static_cast<TX*>(dx),
                                     vbuf, n, D, O, cs, inv_h, k2, stream))
      return e;
  }
  const int tiles = (n + tile - 1) / tile;
  if (tiles > 0) {
    if (int e = launch_dw<TX, TW, G>(xt, gt, partial, n, D, O, cs, inv_h, tile, tiles, stream))
      return e;
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

// plan = {parts, part width}: the dx kernel's output parts (the caller
// allocates vbuf, parts * n * d f32, when there are several).
extern "C" int rbf_bwd_plan(int n, int d, int o, int G, int x_dtype, int w_dtype, int* plan) {
  RBF_DISPATCH(x_dtype, w_dtype, G, plan_dx, n, d, o, plan);
}

// dx (n, D) in x's type (skipped when dx is null) and dw (G*D, O) in w's
// type, from dout (n, O) in x's type. dscale = -2 * inv_h in f32 (inv_h
// unrounded: the JAX kernel's derivative factor). vbuf: f32 scratch of
// parts * n * D floats where rbf_bwd_plan gives several parts, else
// unused; partial: f32 scratch of ceil(n / tile) * G*D*O floats. x, w and
// dout 16-byte aligned.
extern "C" int rbf_bwd(const void* x, const void* w, const void* dout, void* dx, float* vbuf,
                       float* partial, void* dw, int n, int d, int o, int G,
                       const float* centers, float inv_h, float dscale, int tile, int x_dtype,
                       int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Centers cs = centers_of(centers, G);
  RBF_DISPATCH(x_dtype, w_dtype, G, launch_bwd, x, w, dout, dx, vbuf, partial, dw, n, d, o, cs,
               inv_h, dscale, tile, s);
}
