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
// gat_dadst: one warp per row (gat_common.cuh: J passes of 32 slots, any
// C), edges in CSR order, unroll<J>() rows in flight, the per-head dot by a
// butterfly over the head's slots, every sum in registers: no atomics,
// deterministic. It reads dout_r, adst_r, alpha_r and S_r once per row and
// gathers h_s and asrc_s; it splits a heavy row (more than kPiece = 64
// valid edges; node 0 of the main graph has 2,748, about 0.9 ms for one
// warp alone before the split) at the chunks of kan_common.cuh's schedule:
// in launch 1 one warp a chunk finds its rows (a warp search of row_ptr)
// and sums its pieces' dz into f32 partials of H values, two slots a chunk,
// beside the warps of the light rows; launch 2 (gat_dadst_combine_kernel)
// adds a heavy row's pieces in chunk order; at one pass a row launch 1 is
// held to 4 blocks an SM (64 registers).
//
// gat_sender reads h_s and asrc_s once per sender row and gathers dout_r,
// adst_r, alpha_r and S_r per edge. What bounds it on the H100: each sender
// row is a chain of dependent loads (row_ptr, its receivers, their dout
// rows), about 7 edges a row on the main graph, and the rows in flight are
// set by the registers a warp holds; its bytes (h and the f32 dh, 260 MB at
// H 4, C 64) bound it at about 0.11 ms against the first version's 0.447
// (one warp a row, 4 edges in flight, no heavy-row split). This design
// (PERF.md §6 has the readings):
//   * the next round's receivers are loaded while a round's gathers are in
//     flight, so a round waits for its gathers alone, and a bf16 dout pack
//     stays packed until it is used (4 registers an edge in flight): 2
//     edges in flight at 4 blocks an SM (64 registers);
//   * heads in slabs that fill a warp's 32 slots (the whole row at H 4, C
//     64): slabs of one head (128 bytes at C 64 in bf16, an L2-resident
//     21.7 MB table each, 4 rows a warp) read 0.42 ms and two heads 0.39
//     against 0.37 for the whole row: the latency of the chains, not L2
//     misses, bounds the pass, and each slab repeats the row's fixed work;
//   * heavy sender rows split: a row of more than kPiece valid edges (none
//     on the main graph, whose out-degree is at most 23, but a graph whose
//     edges run both ways has a sender row as heavy as its heaviest
//     receiver row) is cut at the chunks of the same schedule over the
//     sender CSR; one warp a chunk sums a piece, slab by slab, its lane
//     groups taking every R-th edge and meeting in a fixed butterfly, into
//     f32 partials of dh and dasrc, and gat_sender_combine_kernel adds them
//     in chunk order, up to 8 warps a heavy row (one warp walked node 0's
//     43 pieces of 260 columns in 0.12 ms). A light row is summed whole in
//     edge order, as before.
// Scratch comes from the caller (torch.empty at each call); no host sync.

#include "gat_common.cuh"

namespace {

using namespace gat;

// da[j] += dz_e of slot j's head over edges [lo, hi) of a receiver row in
// order: ad, al, sr and dv are the row's adst, alpha, S and dout columns
template <typename T, int J, bool VEC>
__device__ __forceinline__ void dz_sum(const T* __restrict__ h, const float* __restrict__ asrc,
                                       const int* __restrict__ senders, int lo, int hi, int H,
                                       size_t HC, int P, float slope, const Slot (&sl)[J],
                                       const float (&ad)[J], const float (&al)[J],
                                       const float (&sr)[J], const float (&dv)[J][kCols],
                                       float (&da)[J]) {
  constexpr int U = unroll<J>();
  // one edge: a[j] = asrc_s of slot j's head, v[j] its columns of h_s
  auto edge = [&](const float (&a)[J], const float (&v)[J][kCols]) {
    float dw[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) p += dv[j][k] * v[j][k];
      dw[j] = p;
    }
    head_sum<J>(dw, P);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float z = a[j] + ad[j];
      const float w = expf(fminf(leaky(z, slope) - al[j], kClamp));
      da[j] += w * (dw[j] - sr[j]) * dleaky(z, slope);
    }
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
    for (int u = 0; u < U; ++u) edge(a[u], v[u]);
  }
  for (; e < hi; ++e) {
    const int s = __ldg(senders + e);
    float a[J], v[J][kCols];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      a[j] = __ldg(asrc + (size_t)s * H + sl[j].head);
      load_cols<VEC>(h + s * HC, sl[j], v[j]);
    }
    edge(a, v);
  }
}

// blocks an SM at one pass a row (gat_common.cuh)
template <int J> constexpr int kRowBlocks = J == 1 ? 4 : 1;

// Launch 1 of gat_dadst. Blocks [0, chunk_blocks) sum the heavy rows'
// pieces, one warp a chunk (and keep the chunk's first row for launch 2);
// the rest take the light rows whole, one warp a row.
template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, kRowBlocks<J>)
gat_dadst_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                 const float* __restrict__ adst, const float* __restrict__ alpha,
                 const float* __restrict__ S, const T* __restrict__ dout,
                 const int* __restrict__ senders, const int* __restrict__ row_ptr,
                 float* __restrict__ dadst, float* __restrict__ partial, int* __restrict__ crow,
                 int n, int H, int C, int P, int jb, int n_edge, float slope, int chunk_blocks) {
  const int warp = threadIdx.x / 32;
  const size_t HC = (size_t)H * C;
  const bool chunk = (int)blockIdx.x < chunk_blocks;
  const int ch = blockIdx.x * kWarps + warp;  // chunk warps
  int cs, ce, first, last;
  kan::Piece p;  // a light row's warp: the row whole
  if (chunk) {
    if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
    first = row_of_edge(row_ptr, n, cs);
    last = row_of_edge(row_ptr, n, ce - 1);
    if (threadIdx.x % 32 == 0) crow[ch] = first;
  } else {
    p.row = (blockIdx.x - chunk_blocks) * kWarps + warp;
    if (p.row >= n) return;
    row_edges(row_ptr, p.row, n_edge, p.lo, p.hi);
    if (p.hi - p.lo > kPiece) return;  // a heavy row: launch 2 writes it
  }
#pragma unroll 1
  for (int slot = 0; slot < 2; ++slot) {
    if (chunk ? !kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edge, row_ptr, p)
              : slot == 1)
      continue;
    const int row = p.row;
    Slot sl[J];
    float ad[J], al[J], sr[J], da[J], dv[J][kCols];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sl[j] = slot_of(jb + j, H, C, P);
      const size_t rh = (size_t)row * H + sl[j].head;
      ad[j] = adst[rh];
      al[j] = alpha[rh];
      sr[j] = S[rh];
      da[j] = 0.f;
      load_cols<VEC>(dout + row * HC, sl[j], dv[j]);
    }
    dz_sum<T, J, VEC>(h, asrc, senders, p.lo, p.hi, H, HC, P, slope, sl, ad, al, sr, dv, da);
    float* dst = chunk ? partial + (2 * (size_t)ch + slot) * H : dadst + (size_t)row * H;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (sl[j].leader) dst[sl[j].head] = da[j];
  }
}

// Launch 2, one warp a chunk: the heavy row holding the chunk's first edge
// and ending inside the chunk has all its pieces written; add them in chunk
// order, a lane a head.
__global__ void __launch_bounds__(kWarps * 32)
gat_dadst_combine_kernel(const int* __restrict__ row_ptr, const float* __restrict__ partial,
                         const int* __restrict__ crow, float* __restrict__ dadst, int H,
                         int n_edge) {
  const int ch = blockIdx.x * kWarps + threadIdx.x / 32;
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
  const int row = crow[ch];
  if (!kan::ends_heavy<kPiece>(cs, row, n_edge, row_ptr, e0, e1)) return;
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  for (int hh = threadIdx.x % 32; hh < H; hh += 32) {
    float s = 0.f;
#pragma unroll 8
    for (int k = slot.first; k <= ch; ++k) s += __ldg(partial + slot(k) * H + hh);
    dadst[(size_t)row * H + hh] = s;
  }
}

// The sender pass's layout (SenderPlan): the heads are cut into slabs of HS
// heads that fill a warp's 32 slots (all 4 heads of 64 columns: the whole
// row) where the heads allow, and grid.y walks the slabs. A slab's HS * P
// slots are held by L = min(32, HS * P) lanes in J = HS * P / L passes (J >
// 1 only for heads of more than 256 columns), so a warp walks R = 32 / L
// sender rows at once (more than one only where the row is narrower than
// 32 slots), each lane group of L lanes one row. Each slot is 8 columns of
// one head (gat_common.cuh), and a head's dot is a butterfly over its P
// slots (head_sum).
struct SenderPlan {
  int P, HS, L, J, slabs;
};

// floats of a heavy sender row's piece partial: its H*C columns of dh, then
// its H of dasrc, rounded up to 16 bytes
inline int sender_partial_width(int H, int C) { return (H * C + H + 3) / 4 * 4; }

// the layout of H heads of C columns (any H; at most kMaxP slots a head,
// so J <= 8); false past them
inline bool sender_plan(int H, int C, SenderPlan& sp) {
  int P, J;
  if (!plan(H, C, P, J)) return false;
  sp.P = P;
  sp.HS = 1;
  while (sp.HS < H && sp.HS * P < 32) sp.HS *= 2;
  const int slots = sp.HS * P;
  sp.L = slots < 32 ? slots : 32;
  sp.J = slots / sp.L;
  sp.slabs = (H + sp.HS - 1) / sp.HS;
  return sp.J <= 8;
}

// pass j of this lane (lane gl of its group) in slab `slab`
__device__ __forceinline__ Slot slab_slot(int j, int gl, int slab, const SenderPlan& sp, int H,
                                          int C) {
  const int v = j * sp.L + gl;
  const int head = slab * sp.HS + v / sp.P, q = v % sp.P;
  const bool active = head < H && q * kCols < C;
  Slot s;
  s.head = head < H ? head : 0;
  s.col = active ? head * C + q * kCols : 0;
  s.cnt = active ? min(kCols, C - q * kCols) : 0;
  s.leader = active && q == 0;
  return s;
}

// A slot's 8 columns of a gathered dout row as loaded: one 16-byte pack
// of bf16 kept packed until its use (4 registers an edge in flight instead
// of 8), else 8 floats.
template <typename T, bool VEC>
struct SlotCols {
  static constexpr bool kPacked = VEC && std::is_same_v<T, __nv_bfloat16>;
  std::conditional_t<kPacked, uint4, float[kCols]> v;
  __device__ __forceinline__ void load(const T* __restrict__ row, const Slot& s) {
    if constexpr (kPacked)
      v = __ldg(reinterpret_cast<const uint4*>(row + s.col));
    else
      load_cols<VEC>(row, s, v);
  }
  __device__ __forceinline__ void zero() {
    if constexpr (kPacked)
      v = make_uint4(0, 0, 0, 0);
    else
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k] = 0.f;
  }
  // the columns as floats: zeros for a slot without columns
  __device__ __forceinline__ void get(const Slot& s, float (&f)[kCols]) const {
    if constexpr (kPacked) {
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(b[k]);
        f[2 * k] = s.cnt > 0 ? x.x : 0.f;
        f[2 * k + 1] = s.cnt > 0 ? x.y : 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) f[k] = v[k];
    }
  }
};

// Edges a lane group keeps in flight, and blocks an SM the sender kernel's
// registers are bounded for (64 registers), at one pass of slots (J = 1:
// heads of up to 256 columns). The kernel is bound by each row's chain of
// dependent loads (row_ptr, receivers, gathers), so it wants warps in
// flight more than edges a warp: on the H100 at H 4, C 64 in bf16, 4
// blocks and 2 edges read 0.37 ms, 3 blocks and 4 edges 0.40, 2 and 4
// 0.53 (PERF.md §6).
template <int J> constexpr int kSenderU = J == 1 ? 2 : unroll<J>();
template <int J> constexpr int kSenderBlocks = J == 1 ? 4 : 1;

// acc[j] += w_e dout_r and da[j] += dz_e over the edges e = e0, e0 + step,
// ... < e1 of a sender row in order, `rounds` rounds of U edges: the same
// count in every lane of the warp (edges past e1 are masked), so that the
// heads' butterflies run in step. Each round's receivers are loaded while
// the round before it gathers, so a round waits for its gathers alone. as
// and hv: the sender's asrc and columns of h.
template <typename T, int J, bool VEC>
__device__ __forceinline__ void sender_sum(const float* __restrict__ adst,
                                           const float* __restrict__ alpha,
                                           const float* __restrict__ S, const T* __restrict__ dout,
                                           const int* __restrict__ receivers, int e0, int e1,
                                           int step, int rounds, int H, size_t HC, int P,
                                           float slope, const Slot (&sl)[J], const float (&as)[J],
                                           const float (&hv)[J][kCols], float (&acc)[J][kCols],
                                           float (&da)[J]) {
  constexpr int U = kSenderU<J>;
  int rn[U];  // the next round's receivers (-1: masked)
  auto fetch = [&](int e) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + u * step;
      rn[u] = eu < e1 ? __ldg(receivers + eu) : -1;
    }
  };
  if (rounds > 0) fetch(e0);
  for (int it = 0, e = e0; it < rounds; ++it) {
    int r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = rn[u];
    float ad[U][J], al[U][J], sr[U][J];
    SlotCols<T, VEC> dv[U][J];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (r[u] >= 0) {
          const size_t rh = (size_t)r[u] * H + sl[j].head;
          ad[u][j] = __ldg(adst + rh);
          al[u][j] = __ldg(alpha + rh);
          sr[u][j] = __ldg(S + rh);
          dv[u][j].load(dout + r[u] * HC, sl[j]);
        } else {
          ad[u][j] = al[u][j] = sr[u][j] = 0.f;
          dv[u][j].zero();
        }
      }
    e += U * step;
    if (it + 1 < rounds) fetch(e);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dw[J], f[J][kCols];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        dv[u][j].get(sl[j], f[j]);
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) p += f[j][k] * hv[j][k];
        dw[j] = p;
      }
      head_sum<J>(dw, P);
      if (r[u] < 0) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float z = as[j] + ad[u][j];
        const float w = expf(fminf(leaky(z, slope) - al[u][j], kClamp));
        da[j] += w * (dw[j] - sr[u][j]) * dleaky(z, slope);
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[j][k] += w * f[j][k];
      }
    }
  }
}

// One slab's walk of sender row `row` over edges e0, e0 + step, ... < e1
// (m_max of them at most in any lane group of the warp): the slots of this
// lane (lane gl of its group), the row's asrc and h read once, and the
// sums (sender_sum).
template <typename T, int J, bool VEC>
__device__ __forceinline__ void sender_slab(const T* __restrict__ h,
                                            const float* __restrict__ asrc,
                                            const float* __restrict__ adst,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ S,
                                            const T* __restrict__ dout,
                                            const int* __restrict__ receivers, int row, int e0,
                                            int e1, int step, int m_max, int slab, int gl,
                                            const SenderPlan& sp, int H, int C, float slope,
                                            Slot (&sl)[J], float (&acc)[J][kCols],
                                            float (&da)[J]) {
  const size_t HC = (size_t)H * C;
  float as[J], hv[J][kCols];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sl[j] = slab_slot(j, gl, slab, sp, H, C);
    as[j] = asrc[(size_t)row * H + sl[j].head];
    da[j] = 0.f;
    load_cols<VEC>(h + row * HC, sl[j], hv[j]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] = 0.f;
  }
  sender_sum<T, J, VEC>(adst, alpha, S, dout, receivers, e0, e1, step,
                        (m_max + kSenderU<J> - 1) / kSenderU<J>, H, HC, sp.P, slope, sl, as, hv,
                        acc, da);
}

// Launch 1 of gat_sender. Blocks [0, chunk_blocks) of slab 0 sum the heavy
// sender rows' pieces, one warp a chunk and every slab in turn (its lane
// groups take every R-th edge of a piece and meet in a fixed butterfly),
// into f32 partials of pw values a slot (the row's H*C columns of dh, then
// its H of dasrc), and keep each chunk's first row for launch 2 (those
// blocks of the other slabs return at once); the rest take slab blockIdx.y
// of the light rows whole in edge order, one lane group a row.
template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, kSenderBlocks<J>)
gat_sender_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                  const float* __restrict__ adst, const float* __restrict__ alpha,
                  const float* __restrict__ S, const T* __restrict__ dout,
                  const int* __restrict__ receivers, const int* __restrict__ row_ptr,
                  float* __restrict__ dh, float* __restrict__ dasrc, float* __restrict__ partial,
                  int* __restrict__ crow, int n, int H, int C, SenderPlan sp, int pw, int n_edge,
                  float slope, int chunk_blocks) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / sp.L, gl = lane % sp.L, R = 32 / sp.L;
  const size_t HC = (size_t)H * C;
  Slot sl[J];
  float acc[J][kCols], da[J];
  if ((int)blockIdx.x < chunk_blocks) {
    if (blockIdx.y != 0) return;
    const int ch = blockIdx.x * kWarps + warp;
    int cs, ce;
    if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
    const int first = row_of_edge(row_ptr, n, cs);
    const int last = row_of_edge(row_ptr, n, ce - 1);
    if (lane == 0) crow[ch] = first;
#pragma unroll 1
    for (int slot = 0; slot < 2; ++slot) {
      kan::Piece p;
      if (!kan::chunk_piece<kPiece>(slot, cs, ce, first, last, n_edge, row_ptr, p)) continue;
      float* part = partial + (2 * (size_t)ch + slot) * pw;
#pragma unroll 1
      for (int slab = 0; slab < sp.slabs; ++slab) {
        sender_slab<T, J, VEC>(h, asrc, adst, alpha, S, dout, receivers, p.row, p.lo + group,
                               p.hi, R, (p.hi - p.lo + R - 1) / R, slab, gl, sp, H, C, slope, sl,
                               acc, da);
        // the groups' sums meet in a fixed butterfly (the same order every run)
        for (int off = sp.L; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            da[j] += __shfl_xor_sync(0xffffffffu, da[j], off);
#pragma unroll
            for (int k = 0; k < kCols; ++k)
              acc[j][k] += __shfl_xor_sync(0xffffffffu, acc[j][k], off);
          }
        }
        if (group != 0) continue;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (sl[j].cnt > 0) store_cols<VEC>(part, sl[j], acc[j]);
          if (sl[j].leader) part[HC + sl[j].head] = da[j];
        }
      }
    }
    return;
  }
  // a light row's group: its row whole; rows past n and heavy rows (launch 2
  // writes them) walk no edge, in step with the warp
  const int row = ((blockIdx.x - chunk_blocks) * kWarps + warp) * R + group;
  int e0 = 0, e1 = 0;
  if (row < n) row_edges(row_ptr, row, n_edge, e0, e1);
  const bool mine = row < n && e1 - e0 <= kPiece;
  if (!mine) e0 = e1 = 0;
  sender_slab<T, J, VEC>(h, asrc, adst, alpha, S, dout, receivers, mine ? row : 0, e0, e1, 1,
                         __reduce_max_sync(0xffffffffu, e1 - e0), blockIdx.y, gl, sp, H, C, slope,
                         sl, acc, da);
  if (!mine) return;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (sl[j].cnt > 0) store_cols<VEC>(dh + row * HC, sl[j], acc[j]);
    if (sl[j].leader) dasrc[(size_t)row * H + sl[j].head] = da[j];
  }
}

// Launch 2, one warp a chunk and column part blockIdx.y of gridDim.y
// (kan::combine_parts): the heavy sender row holding the chunk's first edge
// and ending inside the chunk has all its pieces written; add them in chunk
// order, a lane a column of dh or of dasrc.
__global__ void __launch_bounds__(kWarps * 32)
gat_sender_combine_kernel(const int* __restrict__ row_ptr, const float* __restrict__ partial,
                          const int* __restrict__ crow, float* __restrict__ dh,
                          float* __restrict__ dasrc, int H, int HC, int pw, int n_edge) {
  const int ch = blockIdx.x * kWarps + threadIdx.x / 32;
  int cs, ce, e0, e1;
  if (!kan::chunk_edges<kPiece>(ch, n_edge, cs, ce)) return;
  const int row = crow[ch];
  if (!kan::ends_heavy<kPiece>(cs, row, n_edge, row_ptr, e0, e1)) return;
  const kan::PieceSlots slot = kan::piece_slots<kPiece>(e0);
  for (int c = blockIdx.y * 32 + threadIdx.x % 32; c < HC + H; c += 32 * gridDim.y) {
    float s = 0.f;
#pragma unroll 8
    for (int k = slot.first; k <= ch; ++k) s += __ldg(partial + slot(k) * pw + c);
    if (c < HC)
      dh[(size_t)row * HC + c] = s;
    else
      dasrc[(size_t)row * H + c - HC] = s;
  }
}

// Launch 1 once a group of J passes (jb its first) of the row's Jt; each
// group writes its own heads.
template <typename T, int J, bool VEC>
int launch_dadst(int P, int Jt, const void* h, const float* asrc, const float* adst, const float* alpha,
                 const float* S, const void* dout, const int* senders, const int* row_ptr,
                 float* dadst, float* scratch, int n, int H, int C, int n_edge, float slope,
                 cudaStream_t stream) {
  const int chunks = (n_edge + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int blocks = chunk_blocks + (n + kWarps - 1) / kWarps;
  float* partial = scratch;
  int* crow = reinterpret_cast<int*>(scratch + 2 * (size_t)chunks * H);
  for (int jb = 0; jb < Jt; jb += J) {
    if (blocks > 0)
      gat_dadst_kernel<T, J, VEC><<<blocks, kWarps * 32, 0, stream>>>(
          static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), senders,
          row_ptr, dadst, partial, crow, n, H, C, P, jb, n_edge, slope, chunk_blocks);
    if (int e = (int)cudaGetLastError()) return e;
  }
  if (chunk_blocks > 0)
    gat_dadst_combine_kernel<<<chunk_blocks, kWarps * 32, 0, stream>>>(row_ptr, partial, crow,
                                                                      dadst, H, n_edge);
  return (int)cudaGetLastError();
}

template <typename T, int J, bool VEC>
int launch_sender(const SenderPlan& sp, const void* h, const float* asrc, const float* adst,
                  const float* alpha, const float* S, const void* dout, const int* receivers,
                  const int* row_ptr, float* dh, float* dasrc, float* scratch, int n, int H,
                  int C, int n_edge, float slope, cudaStream_t stream) {
  const int chunks = (n_edge + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int rows_per_block = kWarps * (32 / sp.L);
  const int pw = sender_partial_width(H, C);
  float* partial = scratch;
  int* crow = reinterpret_cast<int*>(scratch + 2 * (size_t)chunks * pw);
  const dim3 grid(chunk_blocks + (n + rows_per_block - 1) / rows_per_block, sp.slabs);
  if (grid.x > 0)
    gat_sender_kernel<T, J, VEC><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), receivers,
        row_ptr, dh, dasrc, partial, crow, n, H, C, sp, pw, n_edge, slope, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0)
    gat_sender_combine_kernel<<<dim3(chunk_blocks, kan::combine_parts(H * C + H)),
                                kWarps * 32, 0, stream>>>(row_ptr, partial, crow, dh, dasrc, H,
                                                          H * C, pw, n_edge);
  return (int)cudaGetLastError();
}

}  // namespace

// dadst (n, H) f32 over the receiver CSR (senders in receiver-sorted order).
// h and dout (n, H*C) of one dtype; asrc, adst, alpha, S (n, H) f32.
// scratch: f32 device memory of ceil(n_edge / 64) * (2*H + 1) values. Any
// H >= 1 and 1 <= C <= 2,048 (gat_common.cuh).
extern "C" int gat_dadst(const void* h, const float* asrc, const float* adst, const float* alpha,
                         const float* S, const void* dout, const int* senders,
                         const int* row_ptr, float* dadst, float* scratch, int n, int H, int C,
                         int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GAT_DISPATCH(dtype, H, C, launch_dadst, h, asrc, adst, alpha, S, dout, senders, row_ptr,
               dadst, scratch, n, H, C, n_edge, slope, s);
}

// dh (n, H*C) f32 and dasrc (n, H) f32 over the sender CSR (receivers in
// sender-sorted order, i.e. receivers_by_sender). scratch: f32 device memory
// of ceil(n_edge / 64) * (2 * sender_partial_width(H, C) + 1) values.
extern "C" int gat_sender(const void* h, const float* asrc, const float* adst, const float* alpha,
                          const float* S, const void* dout, const int* receivers,
                          const int* row_ptr, float* dh, float* dasrc, float* scratch, int n,
                          int H, int C, int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SenderPlan sp;
  if (!sender_plan(H, C, sp)) return (int)cudaErrorInvalidValue;
  const bool vec = C % kCols == 0;
#define SENDER_J(T)                                                                   \
  switch (sp.J) {                                                                     \
    case 1: return vec ? launch_sender<T, 1, true>(sp, SENDER_ARGS)                   \
                       : launch_sender<T, 1, false>(sp, SENDER_ARGS);                 \
    case 2: return vec ? launch_sender<T, 2, true>(sp, SENDER_ARGS)                   \
                       : launch_sender<T, 2, false>(sp, SENDER_ARGS);                 \
    case 4: return vec ? launch_sender<T, 4, true>(sp, SENDER_ARGS)                   \
                       : launch_sender<T, 4, false>(sp, SENDER_ARGS);                 \
    case 8: return vec ? launch_sender<T, 8, true>(sp, SENDER_ARGS)                   \
                       : launch_sender<T, 8, false>(sp, SENDER_ARGS);                 \
    default: return (int)cudaErrorInvalidValue;                                       \
  }
#define SENDER_ARGS \
  h, asrc, adst, alpha, S, dout, receivers, row_ptr, dh, dasrc, scratch, n, H, C, n_edge, slope, s
  if (dtype == kan::kF32) { SENDER_J(float) }
  if (dtype == kan::kBF16) { SENDER_J(__nv_bfloat16) }
#undef SENDER_ARGS
#undef SENDER_J
  return (int)cudaErrorInvalidValue;
}
