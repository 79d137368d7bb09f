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
// Design: a light row (at most kPiece = 64 valid edges) is one warp's
// (gat_common.cuh: J passes of 32 slots, any C), two passes over its edges
// in CSR order: the max of the gathered asrc (leaky is increasing, so that
// gives the shift), then the weights, the denominator and the weighted sum
// of the gathered rows, in registers, unroll<J>() rows in flight. A heavy
// row is split into pieces at the chunks of kan_common.cuh's schedule
// (before the split one warp walked node 0's 2,748 edges alone, about 1.4 ms
// while the rest of the card idled). The shift must be final before any
// piece forms a weight, so three launches:
//   1. gat_fwd_max_kernel, one warp a chunk: the rows of the chunk's first
//      and last edge (a warp search of row_ptr, kept for launches 2 and 3),
//      and each heavy piece's max of the gathered asrc per head, its lanes
//      over the piece's edges (max is exact and order-free);
//   2. gat_fwd_kernel: chunk warps reduce their heavy row's piece maxima to
//      the one rounded shift, then sum their piece's denominator and
//      numerator into f32 partials (two slots a chunk); the other warps take
//      the light rows whole, as above;
//   3. gat_fwd_combine_kernel, one warp a chunk ending a heavy row: the self
//      term first, then the pieces in chunk order; out = acc / den, alpha.
// The rounding points are the light rows' (the shift rounded once from the
// row's max, each weight rounded with it); only the f32 sums are grouped
// by piece. No atomics and no schedule from the host: deterministic, and
// the wrapper never waits on the host. The light rows set the launch's
// time now: at one pass a row gat_fwd_kernel is held to 5 blocks an SM (48
// registers, kRowBlocks).

#include "gat_common.cuh"

namespace {

using namespace gat;

// The split's device scratch (kernels/gat_fused.py allocates it, sized by
// scratch_floats there): per piece slot, two a chunk, the f32 numerator
// (H*C), the max of the gathered asrc (H) and the denominator (H); per
// chunk the rows of its first and last edge.
struct Scratch {
  float* acc;
  float* pmax;
  float* den;
  int* crow;
  Scratch(float* s, int chunks, int H, int C) {
    const size_t slots = 2 * (size_t)chunks;
    acc = s;
    pmax = acc + slots * H * C;
    den = pmax + slots * H;
    crow = reinterpret_cast<int*>(den + slots * H);
  }
};

// ma[j] = the max over edges [lo, hi) of the gathered asrc of slot j's head
template <int J>
__device__ __forceinline__ void asrc_max(const float* __restrict__ asrc,
                                         const int* __restrict__ senders, int lo, int hi, int H,
                                         const Slot (&sl)[J], float (&ma)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ma[j] = -INFINITY;
#pragma unroll 4
    for (int e = lo; e < hi; ++e)
      ma[j] = fmaxf(ma[j], __ldg(asrc + (size_t)__ldg(senders + e) * H + sl[j].head));
  }
}

// den[j] += w and acc[j] += T(w) h_s over edges [lo, hi) in order, with
// w = exp(leaky(asrc_s + ad[j]) - m[j])
template <typename T, int J, bool VEC>
__device__ __forceinline__ void weighted_sum(const T* __restrict__ h, const float* __restrict__ asrc,
                                             const int* __restrict__ senders, int lo, int hi,
                                             int H, size_t HC, float slope, const Slot (&sl)[J],
                                             const float (&ad)[J], const float (&m)[J],
                                             float (&den)[J], float (&acc)[J][kCols]) {
  constexpr int U = unroll<J>();
  auto edge = [&](int j, float a, const float (&v)[kCols]) {
    const float w = expf(leaky(a + ad[j], slope) - m[j]);
    den[j] += w;
    const float wq = kan::round_t<T>(w);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] += wq * v[k];
  };
  int e = lo;
  for (; e + U <= hi; e += U) {
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
  for (; e < hi; ++e) {
    const int s = __ldg(senders + e);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float v[kCols];
      load_cols<VEC>(h + s * HC, sl[j], v);
      edge(j, __ldg(asrc + (size_t)s * H + sl[j].head), v);
    }
  }
}

// slot j's place, adst_r and self-loop logit of row `row`
template <int J>
__device__ __forceinline__ void row_slots(const float* __restrict__ asrc,
                                          const float* __restrict__ adst, int row, int H, int C,
                                          int P, float slope, Slot (&sl)[J], float (&ad)[J],
                                          float (&self)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sl[j] = slot_of(j, H, C, P);
    ad[j] = adst[(size_t)row * H + sl[j].head];
    self[j] = leaky(asrc[(size_t)row * H + sl[j].head] + ad[j], slope);
  }
}

// the rounded shift of a heavy row [e0, e1) from its pieces' maxima
template <int J>
__device__ __forceinline__ void heavy_shift(const float* __restrict__ pmax, int e0, int e1, int H,
                                            float slope, const Slot (&sl)[J],
                                            const float (&ad)[J], const float (&self)[J],
                                            float (&m)[J]) {
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float ma = -INFINITY;
#pragma unroll 8
    for (int k = slot.first; k <= (e1 - 1) / kPiece; ++k)
      ma = fmaxf(ma, __ldg(pmax + slot(k) * H + sl[j].head));
    m[j] = kan::round_t<__nv_bfloat16>(fmaxf(self[j], leaky(ma + ad[j], slope)));
  }
}

// Launch 1, one warp a chunk.
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_max_kernel(const float* __restrict__ asrc, const int* __restrict__ senders,
                   const int* __restrict__ row_ptr, Scratch sc, int n, int H, int n_edge) {
  static_assert(kPiece % 32 == 0, "a lane holds kPiece / 32 edges of a piece");
  const int ch = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  int cs, ce;
  if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
  const int first = row_of_edge(row_ptr, n, cs), last = row_of_edge(row_ptr, n, ce - 1);
  if (lane == 0) {
    sc.crow[2 * ch] = first;
    sc.crow[2 * ch + 1] = last;
  }
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    kan::Piece p;
    if (!kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edge, row_ptr, p)) continue;
    int s[kPiece / 32];
#pragma unroll
    for (int i = 0; i < kPiece / 32; ++i) {
      const int e = p.lo + lane + 32 * i;
      s[i] = e < p.hi ? __ldg(senders + e) : -1;
    }
    float* out = sc.pmax + (2 * (size_t)ch + slot) * H;
    for (int hh = 0; hh < H; ++hh) {
      float v = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPiece / 32; ++i)
        if (s[i] >= 0) v = fmaxf(v, __ldg(asrc + (size_t)s[i] * H + hh));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) out[hh] = v;
    }
  }
}

// blocks an SM at one pass a row (gat_common.cuh)
template <int J> constexpr int kRowBlocks = J == 1 ? 5 : 1;

// Launch 2. Blocks [0, chunk_blocks) sum the heavy rows' pieces, one warp a
// chunk; the rest take the light rows whole, one warp a row.
template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, kRowBlocks<J>)
gat_fwd_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
               const float* __restrict__ adst, const int* __restrict__ senders,
               const int* __restrict__ row_ptr, T* __restrict__ out, float* __restrict__ alpha,
               Scratch sc, int n, int H, int C, int P, int n_edge, float slope,
               int chunk_blocks) {
  const int warp = threadIdx.x / 32;
  const size_t HC = (size_t)H * C;
  Slot sl[J];
  float ad[J], self[J], m[J], den[J], acc[J][kCols];
  if ((int)blockIdx.x < chunk_blocks) {
    const int ch = blockIdx.x * kWarps + warp;
    int cs, ce;
    if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
    const int first = sc.crow[2 * ch], last = sc.crow[2 * ch + 1];
#pragma unroll 1
    for (int slot = 0; slot < 2; ++slot) {
      kan::Piece p;
      if (!kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edge, row_ptr, p)) continue;
      int e0, e1;
      kan::clipped_row(row_ptr, p.row, n_edge, e0, e1);
      row_slots<J>(asrc, adst, p.row, H, C, P, slope, sl, ad, self);
      heavy_shift<J>(sc.pmax, e0, e1, H, slope, sl, ad, self, m);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        den[j] = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[j][k] = 0.f;
      }
      weighted_sum<T, J, VEC>(h, asrc, senders, p.lo, p.hi, H, HC, slope, sl, ad, m, den, acc);
      const size_t q = 2 * (size_t)ch + slot;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        store_cols<VEC>(sc.acc + q * HC, sl[j], acc[j]);
        if (sl[j].leader) sc.den[q * H + sl[j].head] = den[j];
      }
    }
    return;
  }
  const int row = (blockIdx.x - chunk_blocks) * kWarps + warp;
  if (row >= n) return;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  if (e1 - e0 > kPiece) return;  // a heavy row: launch 3 writes it
  row_slots<J>(asrc, adst, row, H, C, P, slope, sl, ad, self);

  // pass 1: the shift
  asrc_max<J>(asrc, senders, e0, e1, H, sl, m);
#pragma unroll
  for (int j = 0; j < J; ++j)
    m[j] = kan::round_t<__nv_bfloat16>(e1 > e0 ? fmaxf(self[j], leaky(m[j] + ad[j], slope))
                                               : self[j]);

  // pass 2: the self-loop, then the edges in order
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float es = expf(self[j] - m[j]);
    den[j] = es;
    load_cols<VEC>(h + row * HC, sl[j], acc[j]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] *= es;
  }
  weighted_sum<T, J, VEC>(h, asrc, senders, e0, e1, H, HC, slope, sl, ad, m, den, acc);
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

// Launch 3, one warp a chunk: the heavy row holding the chunk's first edge
// and ending inside the chunk has all its pieces written. The self term
// first, then the pieces in chunk order; out and alpha as a light row's.
template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_combine_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                       const float* __restrict__ adst, const int* __restrict__ row_ptr,
                       T* __restrict__ out, float* __restrict__ alpha, Scratch sc, int H, int C,
                       int P, int n_edge, float slope) {
  const int ch = blockIdx.x * kWarps + threadIdx.x / 32;
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
  const int row = sc.crow[2 * ch];
  if (!kan::ends_heavy<kPiece>(cs, row, n_edge, row_ptr, e0, e1)) return;
  const size_t HC = (size_t)H * C;
  Slot sl[J];
  float ad[J], self[J], m[J], den[J], acc[J][kCols];
  row_slots<J>(asrc, adst, row, H, C, P, slope, sl, ad, self);
  heavy_shift<J>(sc.pmax, e0, e1, H, slope, sl, ad, self, m);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float es = expf(self[j] - m[j]);
    den[j] = es;
    load_cols<VEC>(h + row * HC, sl[j], acc[j]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] *= es;
  }
  // the pieces in chunk order, B at a time: their loads all in flight
  // before the adds, which keep the order (node 0 of the main graph has 43)
  constexpr int B = J <= 2 ? 8 : 2;
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  for (int k0 = slot.first; k0 <= ch; k0 += B) {
    float v[B][J][kCols], d[B][J];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const size_t q = slot(min(k0 + b, ch));
#pragma unroll
      for (int j = 0; j < J; ++j) {
        load_cols<VEC>(sc.acc + q * HC, sl[j], v[b][j]);
        d[b][j] = __ldg(sc.den + q * H + sl[j].head);
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (k0 + b > ch) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        den[j] += d[b][j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[j][c] += v[b][j][c];
      }
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
           const int* row_ptr, void* out, float* alpha, float* scratch, int n, int H, int C,
           int n_edge, float slope, cudaStream_t stream) {
  const int chunks = (n_edge + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int blocks = chunk_blocks + (n + kWarps - 1) / kWarps;
  const Scratch sc(scratch, chunks, H, C);
  const T* ht = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  if (chunk_blocks > 0)
    gat_fwd_max_kernel<<<chunk_blocks, kWarps * 32, 0, stream>>>(asrc, senders, row_ptr, sc, n,
                                                                H, n_edge);
  if (int e = (int)cudaGetLastError()) return e;
  if (blocks > 0)
    gat_fwd_kernel<T, J, VEC><<<blocks, kWarps * 32, 0, stream>>>(
        ht, asrc, adst, senders, row_ptr, o, alpha, sc, n, H, C, P, n_edge, slope, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0)
    gat_fwd_combine_kernel<T, J, VEC><<<chunk_blocks, kWarps * 32, 0, stream>>>(
        ht, asrc, adst, row_ptr, o, alpha, sc, H, C, P, n_edge, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, H*C) in h's dtype and alpha (n, H) f32 from h (n, H*C), asrc and
// adst (n, H) f32 over the receiver CSR (row_ptr of n+1 entries, senders in
// receiver-sorted order; edges at or past n_edge are padding, the tail of
// the edges). scratch: f32 device memory of 2 * ceil(n_edge / 64) *
// (H*C + 2*H + 1) values. Any C >= 1 with H * P <= 256 slots
// (gat_common.cuh); h 16-byte aligned when C is a multiple of 8.
extern "C" int gat_fwd(const void* h, const float* asrc, const float* adst, const int* senders,
                       const int* row_ptr, void* out, float* alpha, float* scratch, int n, int H,
                       int C, int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GAT_DISPATCH(dtype, H, C, launch, h, asrc, adst, senders, row_ptr, out, alpha, scratch, n, H,
               C, n_edge, slope, s);
}
