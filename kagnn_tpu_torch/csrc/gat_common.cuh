// Shared device code of the GAT kernels (gat_fused.cu, gat_bwd.cu): the
// leaky ReLU and its derivative, 8-column row loads and stores, the slot
// layout of a row, the per-head reduction, the valid edges of a row and
// the row of an edge (for the split of heavy receiver rows, kPiece).
//
// Layout: one warp owns one node row of H*C columns, the C columns of head h
// contiguous at h*C (the JAX layout). A head's columns are cut into
// L = ceil(C / 8) packs of 8, the last masked past C, and the head gets P
// slots, P the power of two >= L. The warp holds J passes of 32 slots
// (J = ceil(H*P / 32), 1, 2, 4 or 8): slot v = j*32 + lane holds pack v % P
// of head v / P, so each lane computes the logit, weight and softmax state
// of its slots' own heads, as do the other slots of those heads, and the
// forward needs no traffic between lanes. A per-head dot product is a
// butterfly over the head's P slots: an aligned group of P lanes when
// P <= 32, else all 32 lanes and the P / 32 passes of the head. Slots past
// a head's L packs or past the H heads hold no columns (their values are
// 0), so they add nothing to a head's sum. When C is a multiple of 8 a pack
// is one 16-byte load in bf16 (two in f32); otherwise the packs load
// value by value. The main path (H = 4, C = 64) is one pass of 32 slots,
// 8 a head.
#pragma once

#include <cmath>

#include "kan_common.cuh"

namespace gat {

using kan::from_f;
using kan::to_f;

constexpr int kWarps = 8;       // rows (one warp each) per block
constexpr int kCols = 8;        // columns per slot
constexpr float kClamp = 80.f;  // the JAX backward's clamp of the exp argument
// edges a chunk of the receiver CSR's piece schedule (kan_common.cuh): a
// row of more valid edges is split into pieces that chunk warps walk in
// parallel
constexpr int kPiece = 64;
// The row kernels (gat_fwd_kernel, gat_dadst_kernel) ask the compiler, by
// __launch_bounds__, to fit a number of blocks an SM in registers at one
// pass a row (J = 1: the main path's H = 4, C = 64): a light row is a short
// chain of dependent gathers, so the launch is bound by the warps an SM
// holds in flight. Wider rows keep the registers they need. Each kernel's
// count is the fastest of 1, 4, 5, 6 and 8 on the H100 (PERF.md §6).

// edges whose rows a warp has in flight at once, by passes a row
template <int J> __host__ __device__ constexpr int unroll() {
  return J <= 2 ? 4 : (J == 4 ? 2 : 1);
}

__device__ __forceinline__ float leaky(float z, float slope) { return z >= 0.f ? z : slope * z; }
__device__ __forceinline__ float dleaky(float z, float slope) { return z >= 0.f ? 1.f : slope; }

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[kCols]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float (&v)[kCols]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kCols]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kCols]) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One slot's place in a row of H*C columns.
struct Slot {
  int col;      // the first of its columns (0 for a slot without columns)
  int cnt;      // its columns: 8, fewer for a head's last pack, 0 for none
  int head;     // its head (0 for a slot past the H heads)
  bool leader;  // the head's first pack: it writes the head's values
};

// slot j of this lane (pass j of the row), with P slots a head
__device__ __forceinline__ Slot slot_of(int j, int H, int C, int P) {
  const int v = j * 32 + threadIdx.x % 32;
  const int head = v / P, q = v % P;
  const bool active = head < H && q * kCols < C;
  Slot s;
  s.head = head < H ? head : 0;
  s.col = active ? head * C + q * kCols : 0;
  s.cnt = active ? min(kCols, C - q * kCols) : 0;
  s.leader = active && q == 0;
  return s;
}

// the slot's columns of a row (zeros past cnt). With VEC (cnt 8 or 0) the
// pack is loaded unconditionally (a slot without columns reads column 0 of
// the row, a valid address) and zeroed by a select: no branch, so the loads
// of the edges a warp unrolls stay in flight together.
template <bool VEC, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ row, const Slot& s,
                                          float (&v)[kCols]) {
  if constexpr (VEC) {
    load8(row + s.col, v);
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = s.cnt > 0 ? v[k] : 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[k] = k < s.cnt ? to_f(row[s.col + k]) : 0.f;
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_cols(T* row, const Slot& s, const float (&v)[kCols]) {
  if constexpr (VEC) {
    if (s.cnt > 0) store8(row + s.col, v);
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (k < s.cnt) row[s.col + k] = from_f<T>(v[k]);
  }
}

// p[j] <- the sum of p over the slots of slot j's head, the same value in
// each of them. Every lane of the warp must call it.
template <int J>
__device__ __forceinline__ void head_sum(float (&p)[J], int P) {
  const int span = P < 32 ? P : 32;  // lanes of a head within one pass
#pragma unroll
  for (int j = 0; j < J; ++j)
    for (int off = span / 2; off > 0; off >>= 1) p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);
  if (P > 32) {  // a head spans P / 32 passes of this lane
    const int per = P / 32;
    float q[J];
#pragma unroll
    for (int j = 0; j < J; ++j) q[j] = p[j];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < J; ++i)
        if (i / per == j / per) s += q[i];
      p[j] = s;
    }
  }
}

// [e0, e1): the valid edges of CSR row `row`. Padded edges are the tail
// [n_edge, E) of both the receiver and the sender order, so each row end is
// clipped there and the pad row's softmax holds only its self-loop.
__device__ __forceinline__ void row_edges(const int* __restrict__ row_ptr, int row, int n_edge,
                                          int& e0, int& e1) {
  e0 = min(row_ptr[row], n_edge);
  e1 = min(row_ptr[row + 1], n_edge);
}

// The row of edge e of a CSR of n rows (the last row r with row_ptr[r] <=
// e; 0 <= e < row_ptr[n]), found by the whole warp: each round its 32
// lanes probe 32 points of the range left, so 4 rounds cover a million
// rows. The GAT wrappers take no `receivers`, so the chunk warps find their
// rows here. Every lane of the warp must call it with the same e.
__device__ __forceinline__ int row_of_edge(const int* __restrict__ row_ptr, int n, int e) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = n;  // the row is in [lo, hi) and row_ptr[lo] <= e
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned ok = __ballot_sync(0xffffffffu, q < hi && __ldg(row_ptr + q) <= e);
    lo += (31 - __clz(ok)) * step;  // lane 0 probes lo itself, so ok != 0
    hi = min(hi, lo + step);
  }
  return lo;
}

// slots a head and passes a row for heads of C columns: P = the power of
// two >= ceil(C / 8), J = the power of two >= H*P / 32; false past 8 passes
inline bool plan(int H, int C, int& P, int& J) {
  const int L = (C + kCols - 1) / kCols;
  for (P = 1; P < L; P *= 2) {
  }
  const int need = (H * P + 31) / 32;
  for (J = 1; J < need; J *= 2) {
  }
  return H >= 1 && C >= 1 && J <= 8;
}

}  // namespace gat

// Calls FN<T, J, VEC>(args...) for the dtype (f32 or bf16), the passes a row
// J in {1, 2, 4, 8} and VEC = whether C is a multiple of 8; returns
// cudaErrorInvalidValue otherwise.
#define GAT_DISPATCH_J(T, J_, VEC_, FN, ...)                                   \
  switch (J_) {                                                                \
    case 1: return VEC_ ? FN<T, 1, true>(__VA_ARGS__) : FN<T, 1, false>(__VA_ARGS__); \
    case 2: return VEC_ ? FN<T, 2, true>(__VA_ARGS__) : FN<T, 2, false>(__VA_ARGS__); \
    case 4: return VEC_ ? FN<T, 4, true>(__VA_ARGS__) : FN<T, 4, false>(__VA_ARGS__); \
    case 8: return VEC_ ? FN<T, 8, true>(__VA_ARGS__) : FN<T, 8, false>(__VA_ARGS__); \
    default: return (int)cudaErrorInvalidValue;                                \
  }

#define GAT_DISPATCH(dtype, H_, C_, FN, ...)                                   \
  do {                                                                         \
    int P_, J_;                                                                \
    if (!gat::plan(H_, C_, P_, J_)) return (int)cudaErrorInvalidValue;         \
    const bool VEC_ = C_ % gat::kCols == 0;                                    \
    if (dtype == kan::kF32) { GAT_DISPATCH_J(float, J_, VEC_, FN, P_, __VA_ARGS__) } \
    if (dtype == kan::kBF16) {                                                 \
      GAT_DISPATCH_J(__nv_bfloat16, J_, VEC_, FN, P_, __VA_ARGS__)             \
    }                                                                          \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)
