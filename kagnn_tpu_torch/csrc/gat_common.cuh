// Shared device code of the GAT kernels (gat_fused.cu, gat_bwd.cu): the
// leaky ReLU and its derivative, 8-column row loads and stores, the lane
// layout of a row, the per-head reduction and the valid edges of a row.
//
// Layout: one warp owns one node row of H*C <= 256 columns; lane l holds the
// 8 consecutive columns 8l .. 8l+7 (one 16-byte load in bf16, two in f32),
// all of them in head 8l / C since C is a multiple of 8. A lane computes the
// logit, weight and softmax state of its own head, as do the other C/8
// lanes of that head, so the forward needs no traffic between lanes; a
// per-head dot product is a butterfly over the C/8 lanes of the head (C/8 a
// power of two: the lanes of a head are an aligned group). Lanes past H*C
// (H*C < 256) read column 0 of the row and store nothing; they form groups
// of their own, so they never mix into an active head's sum.
#pragma once

#include <cmath>

#include "kan_common.cuh"

namespace gat {

using kan::from_f;
using kan::to_f;

constexpr int kWarps = 8;       // rows (one warp each) per block
constexpr int kCols = 8;        // columns per lane
constexpr int kUnroll = 4;      // edges whose rows a warp has in flight at once
constexpr float kClamp = 80.f;  // the JAX backward's clamp of the exp argument

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

// The lane's place in a row of H*C columns.
struct Lane {
  int col;      // the first of its 8 columns (0 for a lane past H*C)
  int head;     // the head of those columns
  bool active;  // whether the lane holds columns of the row
  bool leader;  // the first lane of its head: it writes the head's values
};

__device__ __forceinline__ Lane lane_of(int H, int C) {
  Lane l;
  const int c = (threadIdx.x % 32) * kCols;
  l.active = c < H * C;
  l.col = l.active ? c : 0;
  l.head = l.col / C;
  l.leader = l.active && c % C == 0;
  return l;
}

// The sum of v over the C/8 lanes of this lane's head, the same value in
// each of them. Every lane of the warp must call it.
__device__ __forceinline__ float head_sum(float v, int C) {
  for (int off = C / (2 * kCols); off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// [e0, e1): the valid edges of CSR row `row`. Padded edges are the tail
// [n_edge, E) of both the receiver and the sender order, so each row end is
// clipped there and the pad row's softmax holds only its self-loop.
__device__ __forceinline__ void row_edges(const int* __restrict__ row_ptr, int row, int n_edge,
                                          int& e0, int& e1) {
  e0 = min(row_ptr[row], n_edge);
  e1 = min(row_ptr[row + 1], n_edge);
}

}  // namespace gat
