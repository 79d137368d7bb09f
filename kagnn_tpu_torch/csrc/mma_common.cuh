// Shared device code of the tensor-core layer kernels (bspline_fused.cu,
// fastkan_layer.cu): ldmatrix, mma.sync.m16n8k16 with bf16 operands and f32
// accumulators, 16-byte cp.async copies with commit/wait groups, the staging
// of row tiles into shared memory, the split of f32 values into bf16 terms,
// and the row-tile walk of the two layer forwards.
#pragma once

#include "kan_common.cuh"

#include <unordered_map>

namespace kan {

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

// Copy `rows` rows of `cols` values of T (row r from src(r), or zeros where
// src(r) is null) into dst (pitch elements a row), and zero columns
// cols..cpad-1. With `wide` (every source row 16-byte aligned, cols and
// cpad multiples of 16 / sizeof(T), dst rows 16-byte aligned) the copies
// are cp.async of 16 bytes: they land once the caller has committed them and
// waited (cp_async_wait, then a barrier). Otherwise plain stores, in place
// at the next barrier.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, int rows, int cols, int cpad,
                                           bool wide, Src src) {
  constexpr int V = 16 / sizeof(T);
  if (wide) {
    const int vpr = cpad / V;  // 16-byte packs a row
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, c = (i % vpr) * V;
      const T* sr = src(r);
      T* d = dst + (size_t)r * pitch + c;
      if (sr != nullptr && c < cols)
        cp_async16(d, sr + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cpad; i += kThreads) {
      const int r = i / cpad, c = i % cpad;
      const T* sr = src(r);
      dst[(size_t)r * pitch + c] = (sr != nullptr && c < cols) ? sr[c] : from_f<T>(0.f);
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The number of SMs of the current device.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// blocks of `kernel` (kThreads threads, `smem` bytes) resident on one SM,
// and the number of SMs
template <typename K>
void occupancy(K kernel, size_t smem, int& per_sm, int& sms) {
  sms = sm_count();
  per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  per_sm = per_sm < 1 ? 1 : per_sm;
}

// Split two neighbouring f32 values into TERMS bf16 terms, stored as pairs
// at a + q * stride (q = 0 .. TERMS-1): the first is the value rounded to
// bf16, each next one the rest rounded. Their sum is the value to about
// 2^-(8 * TERMS + 1) of it (three terms carry it whole), so TERMS products
// with a bf16 operand, exact in f32, multiply the f32 value itself.
template <int TERMS>
__device__ __forceinline__ void split_terms(bf16* a, size_t stride, float v0, float v1) {
#pragma unroll
  for (int q = 0; q < TERMS; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(a + (size_t)q * stride) = h;
    const float2 f = __bfloat1622float2(h);
    v0 -= f.x;
    v1 -= f.y;
  }
}

// ---- the tensor-core layer forwards ----------------------------------------
//
// A block walks row tiles of R = 32*MT rows and owns a part of up to
// kFwdMaxOut outputs (all of them up to 256). Per feature chunk it builds
// the chunk's basis in shared memory, R x KC bf16 (TERMS such tiles where an
// f32 basis is split into bf16 terms), and multiplies it on the tensor
// cores with the chunk's weight slab, KC rows x the part's outputs, staged
// with cp.async. The 8 warps are 2 (rows) x 4 (outputs): warp (mw, nw)
// holds rows mw*16*MT .. of the tile (MT m-tiles of 16) and the 16-column
// output pairs nw, nw + 4, .., nw + 4*(NPW-1) of the part, 8*MT*NPW f32
// accumulators a thread kept across the chunks, so each (row, feature)
// basis value is built once for all of the block's outputs. NPW (1, 2 or
// 4: fwd_pairs) is a template argument, so that narrow outputs hold no idle
// accumulators; MT is each kernel's (4 for the B-spline forward, 2 for the
// FastKAN forward: the faster of the two on the H100 for each).
constexpr int kFwdMaxOut = 256;  // outputs a block holds: 4 warps x 4 pairs x 16

template <int MT, int NPW>
using FwdAcc = float[MT][NPW][2][4];

// The pairs a warp holds at part width op (the kernels' NPW).
inline int fwd_pairs(int op) {
  const int np = op / 16;
  return np <= 4 ? 1 : (np <= 8 ? 2 : 4);
}

// The chunk of a tensor-core forward at NG groups a feature: FC features
// (32, 16 or 8: the widest whose NG*FC basis columns stay within KMAX; 8 up
// to 33 groups, past them 4 and, past 66, 2, so that a chunk's basis terms
// fit in a block) and KC = NG*FC columns rounded up to the mma depth of 16
// (the columns past NG*FC stay zero).
template <int NG, int KMAX> struct FwdChunk {
  static constexpr int FC = NG * 32 <= KMAX   ? 32
                            : NG * 16 <= KMAX ? 16
                            : NG <= 33        ? 8
                            : NG <= 66        ? 4
                                              : 2;
  static constexpr int KC = (NG * FC + 15) / 16 * 16;
};

// A forward's launch plan: the output part width op (a multiple of 16) and
// the weight slabs' pitch wp; whether every chunk's slab stays in shared
// memory (resident: staged once, the rows walked past them) or two take
// turns (streamed: the next chunk's slab copied while this one is used);
// whether the tile's x rows (pitch xp) are held in two buffers, the next
// tile's copied while this one computes, or read from device memory; the
// bytes, and the blocks an SM.
struct FwdPlan {
  int op, wp, xp;
  bool resident, hold;
  size_t smem;
  int per_sm;
};

// The widest output part (a multiple of 16, at most kFwdMaxOut) whose
// smallest layout (two streamed slabs, rows not held) fits in a block beside
// `fixed` bytes of the kernel's own; 0 if none does.
inline int fwd_part_width(int O, int KC, size_t fixed) {
  for (int op = std::min(round_up(O, 16), kFwdMaxOut); op >= 16; op -= 16)
    if (fixed + 2 * sizeof(bf16) * (size_t)KC * (op + 8) <= kSmemLimit) return op;
  return 0;
}

// The layout of `kernel` at part width op, `chunks` chunks of KC columns and
// `fixed` bytes of its own (basis terms, x chunks, tables, statistics), and
// xrows bytes for two buffers of the tile's x rows (pitch round_up(D, 8) + 8)
// where the kernel can hold them (0 where it cannot): of those that fit, the
// one with the most blocks resident on an SM (registers and shared memory,
// from the runtime's occupancy calculation), then resident weights, then
// held rows. smem == 0 where none fits. The kernel's shared memory limit is
// raised first.
template <typename K>
FwdPlan plan_forward(K kernel, int op, int D, int KC, int chunks, size_t fixed, size_t xrows) {
  const int wp = op + 8, xp = round_up(D, 8) + 8;
  const size_t slab = sizeof(bf16) * (size_t)KC * wp;
  const FwdPlan cands[4] = {{op, wp, xp, true, true, fixed + chunks * slab + xrows, 0},
                            {op, wp, xp, false, true, fixed + 2 * slab + xrows, 0},
                            {op, wp, xp, true, false, fixed + chunks * slab, 0},
                            {op, wp, xp, false, false, fixed + 2 * slab, 0}};
  FwdPlan best{op, wp, xp, false, false, 0, 0};
  if (set_smem(kernel, kSmemLimit) != 0) return best;
  for (const FwdPlan& p : cands) {
    if ((p.hold && xrows == 0) || p.smem > kSmemLimit) continue;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, p.smem);
    if (blocks > best.per_sm) {
      best = p;
      best.per_sm = blocks;
    }
  }
  return best;
}

// acc += sum over the TERMS tiles A_s + q*tstride (32*MT rows of KC
// columns, pitch pa) of A @ W, W_s the slab (KC rows, pitch wp) of the
// part's np 16-column pairs.
template <int TERMS, int KC, int MT, int NPW>
__device__ __forceinline__ void fwd_mma(FwdAcc<MT, NPW>& acc, const bf16* A_s, int pa,
                                        size_t tstride, const bf16* W_s, int wp, int np) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / 4, nw = warp % 4;
  if (nw >= np) return;  // no output pair for this warp (narrow outputs)
  const bf16* ap =
      A_s + (size_t)(mw * 16 * MT + (lane / 8 % 2) * 8 + lane % 8) * pa + (lane / 16) * 8;
  const bf16* bp = W_s + (size_t)((lane / 8 % 2) * 8 + lane % 8) * wp + nw * 16 + (lane / 16) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < KC; k0 += 16) {
    unsigned a[TERMS][MT][4];
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4<false>(a[q][mt], ap + q * tstride + (size_t)mt * 16 * pa + k0);
#pragma unroll
    for (int p = 0; p < NPW; ++p) {
      if (nw + 4 * p >= np) continue;
      unsigned b[4];
      ldmatrix_x4<true>(b, bp + (size_t)k0 * wp + p * 64);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          mma_bf16(acc[mt][p][0], a[q][mt], b[0], b[1]);
          mma_bf16(acc[mt][p][1], a[q][mt], b[2], b[3]);
        }
    }
  }
}

template <int MT, int NPW>
__device__ __forceinline__ void fwd_zero(FwdAcc<MT, NPW>& acc) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int p = 0; p < NPW; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][p][nt][q] = 0.f;
}

// out[row0 + r, o0 + c] = TO(acc + bias(o)) (bf16, or f32 where the
// forward's input is: the RBF product of an f32 x) for the rows below n and
// the outputs below O of this thread's accumulators, which are then zeroed.
// acc[mt][p][nt][2*h + e]: row mw*16*MT + mt*16 + gid + 8*h, output
// o0 + (nw + 4*p)*16 + nt*8 + tig*2 + e.
template <int MT, int NPW, typename TO, typename Bias>
__device__ __forceinline__ void fwd_store(FwdAcc<MT, NPW>& acc, TO* __restrict__ out, int row0,
                                          int n, int O, int o0, int np, Bias bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mw = warp / 4, nw = warp % 4, gid = lane / 4, tig = lane % 4;
  const bool pairs = O % 2 == 0;
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    if (nw + 4 * p >= np) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int o = o0 + (nw + 4 * p) * 16 + nt * 8 + tig * 2;
      const float b0 = bias(o), b1 = bias(o + 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + mw * 16 * MT + mt * 16 + gid + 8 * h;
          if (row >= n) continue;
          const float v0 = acc[mt][p][nt][2 * h] + b0, v1 = acc[mt][p][nt][2 * h + 1] + b1;
          TO* orow = out + (size_t)row * O;
          if (pairs && o + 1 < O) {
            if constexpr (std::is_same_v<TO, bf16>)
              *reinterpret_cast<__nv_bfloat162*>(orow + o) = __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<float2*>(orow + o) = make_float2(v0, v1);
          } else {
            if (o < O) orow[o] = from_f<TO>(v0);
            if (o + 1 < O) orow[o + 1] = from_f<TO>(v1);
          }
        }
    }
  }
  fwd_zero(acc);
}

// One row tile of a tensor-core layer forward, over `chunks` feature chunks.
// At each: wait for the copies in flight and synchronise, then prefetch(c)
// issues the copies of the next step (committed here as one group, perhaps
// empty), build(c) fills the chunk's TERMS basis tiles in A_s (every thread
// takes part; it may synchronise), and after a barrier the warps multiply
// them with the chunk's weight slab slab(c) into acc. The last chunk's
// products may still read A_s and the slab on return: the next call's first
// barrier orders them before either is written again.
template <int TERMS, int KC, int MT, int NPW, typename Prefetch, typename Build, typename Slab>
__device__ __forceinline__ void forward_tile_mma(FwdAcc<MT, NPW>& acc, int chunks,
                                                 Prefetch prefetch, Build build, Slab slab,
                                                 const bf16* A_s, int pa, size_t tstride, int wp,
                                                 int np) {
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    // this step's copies landed for every thread; the last step's products are done
    __syncthreads();
    prefetch(c);
    cp_async_commit();
    build(c);
    __syncthreads();  // the chunk's basis is complete
    fwd_mma<TERMS, KC, MT, NPW>(acc, A_s, pa, tstride, slab(c), wp, np);
  }
}

// The B-spline forward's tile on the tensor cores: 128 rows (4 m-tiles a
// warp; the taller tile spreads a tile's fixed costs over more rows and, at
// wide outputs, halves the weight slabs streamed from L2 per row, which
// measured faster on the H100 than 64 rows at every main-path shape);
// chunks of about 128 basis columns (16 features at the main path's 8
// groups), or 64 at wide outputs (NPW 4), where two slabs of 256 outputs
// must fit beside the rest.
constexpr int kKanFwdMT = 4;
template <int ORDER, int GRID, int NPW>
using KanFwdChunk = FwdChunk<Shape<ORDER, GRID>::NG, NPW == 4 ? 64 : 128>;

// The bf16 KANLinear forward of the R-row tile at row0 (R = 32*MT) on the
// tensor cores: per chunk c of FC features (KanFwdChunk), the chunk's bf16
// basis from load(rr, row, d) (kan_forward_tile's Load) and the chunk's span
// reciprocals table(c) (rcp_table) into A_s (R x (KC + 8)), times slab(c):
// row g*FC + j the part's outputs of [Wb; Ws] row (g, c*FC + j), zeros past
// the NG groups and past D. prefetch as in forward_tile_mma.
template <int ORDER, int GRID, int MT, int NPW, typename Load, typename Table,
          typename Prefetch, typename Slab>
__device__ __forceinline__ void kan_forward_tile_mma(FwdAcc<MT, NPW>& acc, Load load,
                                                     Table table, Prefetch prefetch, Slab slab,
                                                     bf16* A_s, int row0, int n, int D,
                                                     const bf16* __restrict__ knots, int wp,
                                                     int np) {
  using C = KanFwdChunk<ORDER, GRID, NPW>;
  constexpr int pa = C::KC + 8, R = 32 * MT;
  const int valid = min(R, n - row0);
  auto build = [&](int c) {
    basis_tile_bf16<ORDER, GRID, C::FC>(load, A_s, pa, R, row0, valid, c * C::FC, D, knots,
                                        table(c));
  };
  forward_tile_mma<1, C::KC, MT, NPW>(acc, (D + C::FC - 1) / C::FC, prefetch, build, slab, A_s,
                                      pa, 0, wp, np);
}

}  // namespace kan
