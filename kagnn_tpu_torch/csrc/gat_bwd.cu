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
// Design: one warp per row (gat_common.cuh: J passes of 32 slots, any C),
// edges in CSR order, unroll<J>() rows in flight, the per-head dot by a
// butterfly over the head's slots, every sum in registers: no atomics,
// deterministic. gat_dadst reads dout_r, adst_r, alpha_r and S_r once per
// row and gathers h_s and asrc_s; gat_sender reads h_s and asrc_s once and
// gathers dout_r, adst_r, alpha_r and S_r. gat_dadst splits a heavy row
// (more than kPiece = 64 valid edges; node 0 of the main graph has 2,748,
// about 0.9 ms for one warp alone before the split) at the chunks of
// kan_common.cuh's schedule: in launch 1 one warp a chunk finds its rows
// (a warp search of row_ptr) and sums its pieces' dz into f32 partials of
// H values, two slots a chunk, beside the warps of the light rows; launch 2
// (gat_dadst_combine_kernel) adds a heavy row's pieces in chunk order; at
// one pass a row launch 1 is held to 4 blocks an SM (64 registers). The
// sender CSR's rows are short (out-degree <= 23 there): gat_sender walks
// them whole.

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
                 int n, int H, int C, int P, int n_edge, float slope, int chunk_blocks) {
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
      sl[j] = slot_of(j, H, C, P);
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

template <typename T, int J, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
gat_sender_kernel(const T* __restrict__ h, const float* __restrict__ asrc,
                  const float* __restrict__ adst, const float* __restrict__ alpha,
                  const float* __restrict__ S, const T* __restrict__ dout,
                  const int* __restrict__ receivers, const int* __restrict__ row_ptr,
                  float* __restrict__ dh, float* __restrict__ dasrc, int n, int H, int C, int P,
                  int n_edge, float slope) {
  constexpr int U = unroll<J>();
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const size_t HC = (size_t)H * C;
  int e0, e1;
  row_edges(row_ptr, row, n_edge, e0, e1);
  Slot sl[J];
  float as[J], da[J], hv[J][kCols], acc[J][kCols];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    sl[j] = slot_of(j, H, C, P);
    as[j] = asrc[(size_t)row * H + sl[j].head];
    da[j] = 0.f;
    load_cols<VEC>(h + row * HC, sl[j], hv[j]);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[j][k] = 0.f;
  }

  // one edge: the receiver's adst, alpha and S of slot j's head, and its
  // columns of dout
  auto edge = [&](const float (&ad)[J], const float (&al)[J], const float (&sr)[J],
                  const float (&dv)[J][kCols]) {
    float dw[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k) p += dv[j][k] * hv[j][k];
      dw[j] = p;
    }
    head_sum<J>(dw, P);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float z = as[j] + ad[j];
      const float w = expf(fminf(leaky(z, slope) - al[j], kClamp));
      da[j] += w * (dw[j] - sr[j]) * dleaky(z, slope);
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[j][k] += w * dv[j][k];
    }
  };
  int e = e0;
  for (; e + U <= e1; e += U) {
    int r[U];
    float ad[U][J], al[U][J], sr[U][J], dv[U][J][kCols];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = __ldg(receivers + e + u);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const size_t rh = (size_t)r[u] * H + sl[j].head;
        ad[u][j] = __ldg(adst + rh);
        al[u][j] = __ldg(alpha + rh);
        sr[u][j] = __ldg(S + rh);
        load_cols<VEC>(dout + r[u] * HC, sl[j], dv[u][j]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) edge(ad[u], al[u], sr[u], dv[u]);
  }
  for (; e < e1; ++e) {
    const size_t r = __ldg(receivers + e);
    float ad[J], al[J], sr[J], dv[J][kCols];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t rh = r * H + sl[j].head;
      ad[j] = __ldg(adst + rh);
      al[j] = __ldg(alpha + rh);
      sr[j] = __ldg(S + rh);
      load_cols<VEC>(dout + r * HC, sl[j], dv[j]);
    }
    edge(ad, al, sr, dv);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (sl[j].cnt > 0) store_cols<VEC>(dh + row * HC, sl[j], acc[j]);
    if (sl[j].leader) dasrc[(size_t)row * H + sl[j].head] = da[j];
  }
}

template <typename T, int J, bool VEC>
int launch_dadst(int P, const void* h, const float* asrc, const float* adst, const float* alpha,
                 const float* S, const void* dout, const int* senders, const int* row_ptr,
                 float* dadst, float* scratch, int n, int H, int C, int n_edge, float slope,
                 cudaStream_t stream) {
  const int chunks = (n_edge + kPiece - 1) / kPiece;
  const int chunk_blocks = (chunks + kWarps - 1) / kWarps;
  const int blocks = chunk_blocks + (n + kWarps - 1) / kWarps;
  float* partial = scratch;
  int* crow = reinterpret_cast<int*>(scratch + 2 * (size_t)chunks * H);
  if (blocks > 0)
    gat_dadst_kernel<T, J, VEC><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), senders,
        row_ptr, dadst, partial, crow, n, H, C, P, n_edge, slope, chunk_blocks);
  if (int e = (int)cudaGetLastError()) return e;
  if (chunk_blocks > 0)
    gat_dadst_combine_kernel<<<chunk_blocks, kWarps * 32, 0, stream>>>(row_ptr, partial, crow,
                                                                      dadst, H, n_edge);
  return (int)cudaGetLastError();
}

template <typename T, int J, bool VEC>
int launch_sender(int P, const void* h, const float* asrc, const float* adst,
                  const float* alpha, const float* S, const void* dout, const int* receivers,
                  const int* row_ptr, float* dh, float* dasrc, int n, int H, int C, int n_edge,
                  float slope, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0)
    gat_sender_kernel<T, J, VEC><<<blocks, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(h), asrc, adst, alpha, S, static_cast<const T*>(dout), receivers,
        row_ptr, dh, dasrc, n, H, C, P, n_edge, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dadst (n, H) f32 over the receiver CSR (senders in receiver-sorted order).
// h and dout (n, H*C) of one dtype; asrc, adst, alpha, S (n, H) f32.
// scratch: f32 device memory of ceil(n_edge / 64) * (2*H + 1) values. Any
// C >= 1 with H * P <= 256 slots (gat_common.cuh).
extern "C" int gat_dadst(const void* h, const float* asrc, const float* adst, const float* alpha,
                         const float* S, const void* dout, const int* senders,
                         const int* row_ptr, float* dadst, float* scratch, int n, int H, int C,
                         int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GAT_DISPATCH(dtype, H, C, launch_dadst, h, asrc, adst, alpha, S, dout, senders, row_ptr,
               dadst, scratch, n, H, C, n_edge, slope, s);
}

// dh (n, H*C) f32 and dasrc (n, H) f32 over the sender CSR (receivers in
// sender-sorted order, i.e. receivers_by_sender).
extern "C" int gat_sender(const void* h, const float* asrc, const float* adst, const float* alpha,
                          const float* S, const void* dout, const int* receivers,
                          const int* row_ptr, float* dh, float* dasrc, int n, int H, int C,
                          int n_edge, float slope, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GAT_DISPATCH(dtype, H, C, launch_sender, h, asrc, adst, alpha, S, dout, receivers, row_ptr,
               dh, dasrc, n, H, C, n_edge, slope, s);
}
