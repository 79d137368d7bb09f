// The B-spline KANLinear forward on the tensor cores as a device body, shared
// by bspline_fused.cu (bspline_fwd_mma_kernel: the layer forward on its bf16
// x) and gin_fused.cu (gin_fwd_mma_kernel: the forward on the GIN
// aggregate's unrounded f32 z), with its shared-memory size and its launch
// (the plan by occupancy, the output pairs a warp holds). The input TX is
// bf16 or f32: the ladder runs on its f32 value, the basis is rounded to
// bf16 once, the weights and the output are bf16.
#pragma once

#include "mma_common.cuh"

namespace kan {

// The span reciprocals of every chunk are held where they take at most
// this many bytes.
constexpr size_t kRcpAllBytes = 32768;

template <int ORDER, int GRID, int NPW>  // of one chunk
constexpr size_t kRcpBytes =
    sizeof(float) * kRcps<ORDER, Shape<ORDER, GRID>::NK> * KanFwdChunk<ORDER, GRID, NPW>::FC;

// blocks an SM the kernel's registers are bounded for: two where a thread's
// accumulators and ladder leave room (up to 64 outputs at up to 13 knots,
// the main path's 11), else one (at 128 registers a thread, 65-128 outputs
// spilled 1.1 KB a thread on the H100)
template <int ORDER, int GRID, int NPW>
constexpr int kKanFwdBlocks = 8 * kKanFwdMT * NPW + 3 * Shape<ORDER, GRID>::NK <= 80 ? 2 : 1;

template <int ORDER, int GRID, int NPW>
__host__ __device__ constexpr bool rcp_all(int D) {
  constexpr int FC = KanFwdChunk<ORDER, GRID, NPW>::FC;
  return (size_t)((D + FC - 1) / FC) * kRcpBytes<ORDER, GRID, NPW> <= kRcpAllBytes;
}

// The pitch, in values of TX, of a chunk's staged x rows: FC and 16 bytes.
template <typename TX, int ORDER, int GRID, int NPW>
constexpr int kFwdXPitch = KanFwdChunk<ORDER, GRID, NPW>::FC + 16 / (int)sizeof(TX);

// The forward on the tensor cores, the body of a kernel launched with
// grid (persistent row blocks, output parts of plan.op). Each block walks
// row tiles of R = 32*MT = 128 rows (kKanFwdMT) and, per chunk of FC
// features (KanFwdChunk: 16 at the main path's 8 groups, 8 at wide outputs),
// builds the chunk's bf16 basis once (basis_tile_bf16, the span reciprocals
// of its ladders from a table made once per chunk: rcp_table) and
// multiplies it with the chunk's weight slab for all of its outputs
// (kan_forward_tile_mma, mma_common.cuh). Shared memory: the weight slabs
// (every chunk's, staged once, where that keeps as many blocks on an SM as
// two slabs taking turns; else two, the next chunk's copied with cp.async
// while this one's basis is built and multiplied: plan_forward), the basis
// tile, two buffers of a chunk's x rows (in TX), the next step's copied
// while this one runs, and the span reciprocals: every chunk's, made once,
// where they take at most kRcpAllBytes (D up to about 300 at the main
// path's order), else two buffers, the next step's made while this one
// runs. NPW: output pairs a warp holds (fwd_pairs); two blocks an SM up to
// 64 outputs at the main path's ladder, one at wide outputs (128
// accumulators a thread): the kernels' __launch_bounds__ take
// kKanFwdBlocks.
template <typename TX, int ORDER, int GRID, int NPW>
__device__ __forceinline__ void kan_fwd_mma_body(const TX* __restrict__ x,
                                                 const bf16* __restrict__ knots,
                                                 const bf16* __restrict__ wb,
                                                 const bf16* __restrict__ ws,
                                                 bf16* __restrict__ out, int n, int D, int O,
                                                 const FwdPlan& plan) {
  using S = Shape<ORDER, GRID>;
  using C = KanFwdChunk<ORDER, GRID, NPW>;
  constexpr int MT = kKanFwdMT, FC = C::FC, KC = C::KC, R = 32 * MT, pa = KC + 8;
  constexpr int xp = kFwdXPitch<TX, ORDER, GRID, NPW>;
  constexpr int RT = kRcps<ORDER, S::NK> * FC;  // floats of a chunk's reciprocals
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (D + FC - 1) / FC, tiles = (n + R - 1) / R;
  const int wp = plan.wp;
  const int o0 = blockIdx.y * plan.op, ow = min(plan.op, O - o0), np = (ow + 15) / 16;
  bf16* W_s = reinterpret_cast<bf16*>(smem_raw);                      // slabs, KC x wp
  bf16* A_s = W_s + (size_t)(plan.resident ? chunks : 2) * KC * wp;  // R x pa
  TX* x_s = reinterpret_cast<TX*>(A_s + (size_t)R * pa);             // 2 x R x xp
  float* r_s = reinterpret_cast<float*>(x_s + 2 * R * xp);           // chunks or 2 x RT
  const bool all_rcp = rcp_all<ORDER, GRID, NPW>(D);
  if constexpr (KC > S::NG * FC) {  // the columns past the groups stay zero
    constexpr int padc = KC - S::NG * FC;
    for (int i = threadIdx.x; i < R * padc; i += kThreads)
      A_s[(size_t)(i / padc) * pa + S::NG * FC + i % padc] = from_f<bf16>(0.f);
  }
  // chunk c's slab into slot `slot`: row g*FC + j = [Wb; Ws] row (g, c*FC + j)
  auto stage_w = [&](int c, int slot) {
    stage_rows(W_s + (size_t)slot * KC * wp, wp, KC, ow, np * 16, O % 8 == 0,
               [&](int k) -> const bf16* {
                 const int g = k / FC, d = c * FC + k % FC;
                 return g < S::NG && d < D ? weight_row(wb, ws, g, d, D, O) + o0 : nullptr;
               });
  };
  // chunk c of tile t's x rows into buffer b
  auto stage_x = [&](int t, int c, int b) {
    stage_rows(x_s + (size_t)b * R * xp, xp, R, min(FC, D - c * FC), FC,
               D % (16 / (int)sizeof(TX)) == 0 && FC % (16 / (int)sizeof(TX)) == 0,
               [&](int r) -> const TX* {
                 const int row = t * R + r;
                 return row < n ? x + (size_t)row * D + c * FC : nullptr;
               });
  };
  int t = blockIdx.x;
  if (t >= tiles) return;
  if (plan.resident) {
    for (int c = 0; c < chunks; ++c) stage_w(c, c);
  } else {
    stage_w(0, 0);
  }
  stage_x(t, 0, 0);
  for (int c = 0; c < (all_rcp ? chunks : 1); ++c)
    rcp_table<ORDER, GRID, FC>(r_s + c * RT, c * FC, D, knots);
  cp_async_commit();
  FwdAcc<MT, NPW> acc;
  fwd_zero(acc);
  // step: the chunks this block walked before the tile; a step's x, table
  // and streamed slab are in buffer (step + c) & 1
  for (int step = 0; t < tiles; t += gridDim.x, step += chunks) {
    const int row0 = t * R, next = t + gridDim.x;
    auto load = [&](int rr, int, int d) {
      const int c = d / FC;
      return to_f(x_s[(size_t)((step + c) & 1) * R * xp + rr * xp + d - c * FC]);
    };
    auto table = [&](int c) -> const float* {
      return r_s + (all_rcp ? c : (step + c) & 1) * RT;
    };
    // the next step's chunk: this tile's next, or the next tile's first
    auto prefetch = [&](int c) {
      const bool last = c + 1 == chunks;
      if (last && next >= tiles) return;
      const int tn = last ? next : t, cn = last ? 0 : c + 1, b = (step + c + 1) & 1;
      if (!plan.resident) stage_w(cn, b);
      stage_x(tn, cn, b);
      if (!all_rcp) rcp_table<ORDER, GRID, FC>(r_s + b * RT, cn * FC, D, knots);
    };
    auto slab = [&](int c) -> const bf16* {
      return W_s + (size_t)(plan.resident ? c : (step + c) & 1) * KC * wp;
    };
    kan_forward_tile_mma<ORDER, GRID, MT, NPW>(acc, load, table, prefetch, slab, A_s, row0, n, D,
                                               knots, wp, np);
    fwd_store<MT, NPW>(acc, out, row0, n, O, o0, np, [](int) { return 0.f; });
  }
  cp_async_wait<0>();  // the last, empty, commit group
}

// kan_fwd_mma_body's shared memory besides its weight slabs: the basis
// tile, two buffers of a chunk's x rows, and the span reciprocals (every
// chunk's or two buffers: rcp_all).
template <typename TX, int ORDER, int GRID, int NPW>
size_t fwd_mma_fixed(int D) {
  using C = KanFwdChunk<ORDER, GRID, NPW>;
  constexpr int R = 32 * kKanFwdMT;
  const size_t tables = rcp_all<ORDER, GRID, NPW>(D) ? (D + C::FC - 1) / C::FC : 2;
  return sizeof(bf16) * R * (C::KC + 8) + sizeof(TX) * 2 * R * kFwdXPitch<TX, ORDER, GRID, NPW> +
         tables * kRcpBytes<ORDER, GRID, NPW>;
}

// The launch of a kernel whose body is kan_fwd_mma_body<TX, ORDER, GRID, NPW>
// at part width op; the plan is made at the first launch of each (D, O) and
// kept.
template <typename TX, int ORDER, int GRID, int NPW, typename K>
int launch_fwd_mma_part(K kernel, const TX* x, const bf16* knots, const bf16* wb,
                        const bf16* ws, bf16* out, int n, int D, int O, int op,
                        cudaStream_t stream) {
  using C = KanFwdChunk<ORDER, GRID, NPW>;
  static std::unordered_map<uint64_t, FwdPlan> plans;
  FwdPlan& plan = plans[(uint64_t)D << 32 | (uint32_t)O];
  if (plan.smem == 0) {
    plan = plan_forward(kernel, op, D, C::KC, (D + C::FC - 1) / C::FC,
                        fwd_mma_fixed<TX, ORDER, GRID, NPW>(D), 0);
    if (plan.smem == 0) return (int)cudaErrorInvalidValue;
  }
  static const int sms = sm_count();
  const int R = 32 * kKanFwdMT, tiles = (n + R - 1) / R;
  dim3 grid(std::min(tiles, plan.per_sm * sms), (O + plan.op - 1) / plan.op);
  kernel<<<grid, kThreads, plan.smem, stream>>>(x, knots, wb, ws, out, n, D, O, plan);
  return (int)cudaGetLastError();
}

// The bf16 forward of x (TX) at the widest output part that fits (a
// narrower part's wider chunk fits beside its narrower slabs) and the
// output pairs a warp holds there: kernel_of(std::integral_constant<int,
// NPW>) gives the kernel of NPW.
template <typename TX, int ORDER, int GRID, typename KernelOf>
int launch_fwd_mma(KernelOf kernel_of, const TX* x, const bf16* knots, const bf16* wb,
                   const bf16* ws, bf16* out, int n, int D, int O, cudaStream_t stream) {
  const int op = fwd_part_width(O, KanFwdChunk<ORDER, GRID, 4>::KC,
                                fwd_mma_fixed<TX, ORDER, GRID, 4>(D));
  if (op == 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || O == 0) return 0;
  auto go = [&](auto npw) {
    return launch_fwd_mma_part<TX, ORDER, GRID, decltype(npw)::value>(
        kernel_of(npw), x, knots, wb, ws, out, n, D, O, op, stream);
  };
  const int npw = fwd_pairs(op);
  return npw == 1 ? go(std::integral_constant<int, 1>{})
                  : npw == 2 ? go(std::integral_constant<int, 2>{})
                             : go(std::integral_constant<int, 4>{});
}

}  // namespace kan
