// Masked BatchNorm for Hopper (sm_90a): the training forward and its
// backward of kagnn_tpu_torch/ops/norm.py::MaskedBatchNorm.
//
// Replaces no TPU kernel: on the TPU XLA fuses the JAX layer
// (kagnn_tpu/ops/norm.py) into a few passes, while PyTorch's eager path runs
// about 11 full-size operations forward and 19 backward, each a pass over the
// (N, C) tensor in f32. Per column c, over the rows where mask is set (all
// rows without a mask), with n = max(count, 1):
//   mean, var = the f32 mean and biased variance of x,
//   a = w * rsqrt(var + eps), b = bias - mean * a,
//   y = x * a + b in x's dtype (zero on masked rows),
// and the running buffers updated as the module does: r = r * (1 - momentum),
// then r = r + momentum * stat, the variance's stat var * n / max(n - 1, 1).
// Backward, with g = m * dy, rstd = rsqrt(var + eps), xh = (x - mean) * rstd:
//   dbias = sum g, dw = sum g * xh,
//   dx = m * w * rstd * (g - dbias / n - xh * dw / n), rounded once.
//
// Bound on the H100: device-memory bytes. The forward reads x for the
// statistics and again to write y; the backward reads x and dy for the two
// column sums and again to write dx. Design:
//   * one pass for the statistics: each thread keeps a running (count, mean,
//     M2) of its rows (Welford), a block merges its threads' triples in a
//     fixed tree (Chan et al.'s pairwise update) and writes one partial a
//     row block; never E[x^2] - mean^2, and no f32 copy of x;
//   * a block of 256 threads: cb lanes along the columns, each loading 16
//     bytes (4 f32 or 8 bf16 columns; one value where C or an address does
//     not allow it), and 256 / cb lanes along the rows, each with 4 rows in
//     flight; the row blocks are sized from (N, C) and the SM count: 4
//     blocks an SM, but at least 64 KB of x a block, so a small x takes a
//     single row block;
//   * the row blocks' partials are merged by a second small kernel in a
//     fixed order (32 lanes a column, then a tree), which also writes a, b,
//     mean and rstd and updates the running buffers: no float atomics, two
//     runs give the same bits;
//   * a third kernel writes y (or dx). The apply keeps the module's rounding
//     points: a and b rounded to x's dtype, the product rounded, then the
//     sum (__fmul_rn / __fadd_rn, so no FMA contracts them).
// The scratch and outputs come from the caller (torch.empty on the current
// stream): no allocation, no host sync, so a CUDA graph captures the launches
// as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// dtype codes passed from Python (kernels/_common.py DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int kThreads = 256;        // threads a block of the row passes
constexpr int kUnroll = 4;           // rows in flight a thread
constexpr int kBlocksPerSm = 4;      // row-pass blocks the grid aims at, an SM
constexpr int kMinBlockBytes = 1 << 16;  // least bytes of x a row block
constexpr int kFinalCols = 8;        // columns a block of the finishing kernels
constexpr int kFinalLanes = 32;      // partial lanes a column there

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: PyTorch's rounding of a result in x's dtype
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// V values of T at p: 16 bytes at once, or one value (V == 1)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f(t[j]);
  }
}

// v, already representable in T, stored as T
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// per-column (count, mean, M2) of V columns; the count is shared
template <int V>
struct Moments {
  float n = 0.f;
  float mean[V];
  float m2[V];

  __device__ __forceinline__ Moments() {
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  }

  // Welford's update by one row
  __device__ __forceinline__ void push(const float (&v)[V]) {
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean[j];
      mean[j] = fmaf(d, inv, mean[j]);
      m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
    }
  }

  // Chan et al.'s merge of another set of rows (count bn, means bm, M2s bq)
  __device__ __forceinline__ void merge(float bn, const float* bm, const float* bq) {
    if (bn == 0.f) return;
    const float total = n + bn;
    const float f = bn / total;
    const float cross = n * f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = bm[j] - mean[j];
      mean[j] = fmaf(d, f, mean[j]);
      m2[j] = m2[j] + bq[j] + d * d * cross;
    }
    n = total;
  }
};

// The row passes' block: threadIdx.x a 16-byte column vector of the block's
// slab (blockIdx.y), threadIdx.y a lane of rows [r0, r1) strided by
// blockDim.y, blockIdx.x the row block.
struct Rows {
  int vec, r0, r1;
  bool active;
};

template <int V>
__device__ __forceinline__ Rows block_rows(int n, int c, int rows_per_block) {
  Rows b;
  b.vec = blockIdx.y * blockDim.x + threadIdx.x;
  b.active = b.vec * V < c;
  b.r0 = blockIdx.x * rows_per_block + threadIdx.y;
  b.r1 = min(n, (blockIdx.x + 1) * rows_per_block);
  return b;
}

__device__ __forceinline__ bool kept(const uint8_t* mask, int r) { return !mask || mask[r]; }

// Pass 1 forward: one (count, mean, M2) partial of each column a row block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    masked_bn_stats_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, int n,
                           int c, int rows_per_block, float* __restrict__ part_mean,
                           float* __restrict__ part_m2, float* __restrict__ part_n) {
  __shared__ float s_mean[kThreads * 8], s_m2[kThreads * 8], s_n[kThreads];
  const Rows b = block_rows<V>(n, c, rows_per_block);
  const int tr = blockDim.y;
  Moments<V> acc;
  if (b.active) {
    const T* xp = x + (size_t)b.vec * V;
    int r = b.r0;
    for (; r + (kUnroll - 1) * tr < b.r1; r += kUnroll * tr) {
      float v[kUnroll][V];
      bool keep[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        keep[u] = kept(mask, r + u * tr);
        load_vec<T, V>(xp + (size_t)(r + u * tr) * c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (keep[u]) acc.push(v[u]);
    }
    for (; r < b.r1; r += tr) {
      float v[V];
      load_vec<T, V>(xp + (size_t)r * c, v);
      if (kept(mask, r)) acc.push(v);
    }
  }
  // the block's lanes of rows merged in a fixed tree
  const int slot = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[slot * V + j] = acc.mean[j];
    s_m2[slot * V + j] = acc.m2[j];
  }
  s_n[slot] = acc.n;
  __syncthreads();
  for (int s = 1; s < tr; s <<= 1) {
    if (threadIdx.y % (2 * s) == 0 && threadIdx.y + s < tr) {
      const int o = slot + s * blockDim.x;
      acc.merge(s_n[o], s_mean + o * V, s_m2 + o * V);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_mean[slot * V + j] = acc.mean[j];
        s_m2[slot * V + j] = acc.m2[j];
      }
      s_n[slot] = acc.n;
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && b.active) {
    const size_t at = (size_t)blockIdx.x * c + (size_t)b.vec * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part_mean[at + j] = acc.mean[j];
      part_m2[at + j] = acc.m2[j];
    }
    if (threadIdx.x == 0 && blockIdx.y == 0) part_n[blockIdx.x] = acc.n;
  }
}

// Pass 2 forward: the partials merged in a fixed order; the affine (a, b),
// mean, rstd and the clamped count; the running buffers updated in place.
__global__ void __launch_bounds__(kFinalCols* kFinalLanes)
    masked_bn_stats_final_kernel(const float* __restrict__ part_mean,
                                 const float* __restrict__ part_m2,
                                 const float* __restrict__ part_n, int row_blocks, int c,
                                 const float* __restrict__ weight, const float* __restrict__ bias,
                                 float* running_mean, float* running_var, float keep,
                                 float momentum, float eps, float* __restrict__ stats) {
  __shared__ float s_mean[kFinalLanes][kFinalCols], s_m2[kFinalLanes][kFinalCols],
      s_n[kFinalLanes][kFinalCols];
  const int tx = threadIdx.x, g = threadIdx.y;
  const int col = blockIdx.x * kFinalCols + tx;
  Moments<1> acc;
  if (col < c) {
#pragma unroll 4
    for (int rb = g; rb < row_blocks; rb += kFinalLanes)
      acc.merge(part_n[rb], part_mean + (size_t)rb * c + col, part_m2 + (size_t)rb * c + col);
  }
  s_mean[g][tx] = acc.mean[0];
  s_m2[g][tx] = acc.m2[0];
  s_n[g][tx] = acc.n;
  __syncthreads();
  for (int s = 1; s < kFinalLanes; s <<= 1) {
    if (g % (2 * s) == 0) {
      acc.merge(s_n[g + s][tx], &s_mean[g + s][tx], &s_m2[g + s][tx]);
      s_mean[g][tx] = acc.mean[0];
      s_m2[g][tx] = acc.m2[0];
      s_n[g][tx] = acc.n;
    }
    __syncthreads();
  }
  if (g != 0 || col >= c) return;
  const float cnt = fmaxf(acc.n, 1.f);
  const float mean = acc.mean[0];
  const float var = __fdiv_rn(acc.m2[0], cnt);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float a = __fmul_rn(weight[col], rstd);
  stats[col] = a;
  stats[c + col] = __fsub_rn(bias[col], __fmul_rn(mean, a));
  stats[2 * c + col] = mean;
  stats[3 * c + col] = rstd;
  if (col == 0) stats[4 * c] = cnt;
  const float unbiased = __fdiv_rn(__fmul_rn(var, cnt), fmaxf(__fsub_rn(cnt, 1.f), 1.f));
  running_mean[col] = __fadd_rn(__fmul_rn(running_mean[col], keep), __fmul_rn(momentum, mean));
  running_var[col] = __fadd_rn(__fmul_rn(running_var[col], keep), __fmul_rn(momentum, unbiased));
}

// y = x * a + b in T with the module's rounding points; zero on masked rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    masked_bn_apply_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                           const float* __restrict__ a, const float* __restrict__ bb, T* __restrict__ y,
                           int n, int c, int rows_per_block) {
  const Rows b = block_rows<V>(n, c, rows_per_block);
  if (!b.active) return;
  const int tr = blockDim.y;
  float av[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    av[j] = round_t<T>(a[b.vec * V + j]);
    bv[j] = round_t<T>(bb[b.vec * V + j]);
  }
  const T* xp = x + (size_t)b.vec * V;
  T* yp = y + (size_t)b.vec * V;
  auto row = [&](const float (&v)[V], bool keep, int r) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = keep ? round_t<T>(__fadd_rn(round_t<T>(__fmul_rn(v[j], av[j])), bv[j])) : 0.f;
    store_vec<T, V>(yp + (size_t)r * c, o);
  };
  int r = b.r0;
  for (; r + (kUnroll - 1) * tr < b.r1; r += kUnroll * tr) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec<T, V>(xp + (size_t)(r + u * tr) * c, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row(v[u], kept(mask, r + u * tr), r + u * tr);
  }
  for (; r < b.r1; r += tr) {
    float v[V];
    load_vec<T, V>(xp + (size_t)r * c, v);
    row(v, kept(mask, r), r);
  }
}

// Pass 1 backward: the partial sums of g and of g * (x - mean) of each column
// a row block, the block's lanes added in a fixed tree.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    masked_bn_grad_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ stats, int n, int c,
                                int rows_per_block, float* __restrict__ part_g,
                                float* __restrict__ part_gx) {
  __shared__ float s_g[kThreads * 8], s_gx[kThreads * 8];
  const Rows b = block_rows<V>(n, c, rows_per_block);
  const int tr = blockDim.y;
  float sg[V], sgx[V], mean[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = 0.f;
  if (b.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = stats[2 * c + b.vec * V + j];
    const T* xp = x + (size_t)b.vec * V;
    const T* dp = dy + (size_t)b.vec * V;
    auto add = [&](const float (&v)[V], const float (&d)[V]) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] += d[j];
        sgx[j] = fmaf(d[j], v[j] - mean[j], sgx[j]);
      }
    };
    int r = b.r0;
    for (; r + (kUnroll - 1) * tr < b.r1; r += kUnroll * tr) {
      float v[kUnroll][V], d[kUnroll][V];
      bool keep[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        keep[u] = kept(mask, r + u * tr);
        load_vec<T, V>(xp + (size_t)(r + u * tr) * c, v[u]);
        load_vec<T, V>(dp + (size_t)(r + u * tr) * c, d[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (keep[u]) add(v[u], d[u]);
    }
    for (; r < b.r1; r += tr) {
      float v[V], d[V];
      load_vec<T, V>(xp + (size_t)r * c, v);
      load_vec<T, V>(dp + (size_t)r * c, d);
      if (kept(mask, r)) add(v, d);
    }
  }
  const int slot = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_g[slot * V + j] = sg[j];
    s_gx[slot * V + j] = sgx[j];
  }
  __syncthreads();
  for (int s = 1; s < tr; s <<= 1) {
    if (threadIdx.y % (2 * s) == 0 && threadIdx.y + s < tr) {
      const int o = (slot + s * blockDim.x) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] += s_g[o + j];
        sgx[j] += s_gx[o + j];
        s_g[slot * V + j] = sg[j];
        s_gx[slot * V + j] = sgx[j];
      }
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && b.active) {
    const size_t at = (size_t)blockIdx.x * c + (size_t)b.vec * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part_g[at + j] = sg[j];
      part_gx[at + j] = sgx[j];
    }
  }
}

// Pass 2 backward: the partials added in a fixed order; dweight, dbias and
// the coefficients of dx (w * rstd, dbias / n, dweight / n).
__global__ void __launch_bounds__(kFinalCols* kFinalLanes)
    masked_bn_grad_final_kernel(const float* __restrict__ part_g,
                                const float* __restrict__ part_gx, int row_blocks, int c,
                                const float* __restrict__ weight,
                                const float* __restrict__ stats, float* __restrict__ dweight,
                                float* __restrict__ dbias, float* __restrict__ coef) {
  __shared__ float s_g[kFinalLanes][kFinalCols], s_gx[kFinalLanes][kFinalCols];
  const int tx = threadIdx.x, g = threadIdx.y;
  const int col = blockIdx.x * kFinalCols + tx;
  float sg = 0.f, sgx = 0.f;
  if (col < c) {
#pragma unroll 4
    for (int rb = g; rb < row_blocks; rb += kFinalLanes) {
      sg += part_g[(size_t)rb * c + col];
      sgx += part_gx[(size_t)rb * c + col];
    }
  }
  s_g[g][tx] = sg;
  s_gx[g][tx] = sgx;
  __syncthreads();
  for (int s = 1; s < kFinalLanes; s <<= 1) {
    if (g % (2 * s) == 0) {
      sg += s_g[g + s][tx];
      sgx += s_gx[g + s][tx];
      s_g[g][tx] = sg;
      s_gx[g][tx] = sgx;
    }
    __syncthreads();
  }
  if (g != 0 || col >= c) return;
  const float rstd = stats[3 * c + col], cnt = stats[4 * c];
  const float dw = sgx * rstd;
  dweight[col] = dw;
  dbias[col] = sg;
  coef[col] = weight[col] * rstd;
  coef[c + col] = sg / cnt;
  coef[2 * c + col] = dw / cnt;
}

// dx = m * w * rstd * (g - dbias / n - xh * dweight / n), rounded once to T.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    masked_bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const uint8_t* __restrict__ mask, const float* __restrict__ stats,
                        const float* __restrict__ coef, T* __restrict__ dx, int n, int c,
                        int rows_per_block) {
  const Rows b = block_rows<V>(n, c, rows_per_block);
  if (!b.active) return;
  const int tr = blockDim.y;
  float mean[V], rstd[V], k[V], c1[V], c2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int col = b.vec * V + j;
    mean[j] = stats[2 * c + col];
    rstd[j] = stats[3 * c + col];
    k[j] = coef[col];
    c1[j] = coef[c + col];
    c2[j] = coef[2 * c + col];
  }
  const T* xp = x + (size_t)b.vec * V;
  const T* dp = dy + (size_t)b.vec * V;
  T* op = dx + (size_t)b.vec * V;
  auto row = [&](const float (&v)[V], const float (&d)[V], bool keep, int r) {
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = keep ? round_t<T>(k[j] * (d[j] - c1[j] - (v[j] - mean[j]) * rstd[j] * c2[j])) : 0.f;
    store_vec<T, V>(op + (size_t)r * c, o);
  };
  int r = b.r0;
  for (; r + (kUnroll - 1) * tr < b.r1; r += kUnroll * tr) {
    float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<T, V>(xp + (size_t)(r + u * tr) * c, v[u]);
      load_vec<T, V>(dp + (size_t)(r + u * tr) * c, d[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) row(v[u], d[u], kept(mask, r + u * tr), r + u * tr);
  }
  for (; r < b.r1; r += tr) {
    float v[V], d[V];
    load_vec<T, V>(xp + (size_t)r * c, v);
    load_vec<T, V>(dp + (size_t)r * c, d);
    row(v, d, kept(mask, r), r);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

int elem_bytes(int dtype) { return dtype == kBF16 ? 2 : 4; }

// Row blocks of the row passes: kBlocksPerSm blocks an SM over the column
// slabs (512 bytes of a row each), but at least kMinBlockBytes of x a block.
int row_blocks_of(int n, int c, int dtype) {
  const long long row_bytes = (long long)c * elem_bytes(dtype);
  const long long slabs = (row_bytes + 511) / 512;
  const long long by_sms = (kBlocksPerSm * (long long)sm_count() + slabs - 1) / slabs;
  const long long by_bytes = ((long long)n * row_bytes / slabs + kMinBlockBytes - 1) / kMinBlockBytes;
  const long long rb = by_sms < by_bytes ? by_sms : by_bytes;
  return rb < 1 ? 1 : (int)rb;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the row passes' launch shape for V columns a thread
struct Launch {
  dim3 grid, block;
  int rows_per_block;
};

template <int V>
Launch launch_of(int n, int c, int row_blocks) {
  const int nvec = (c + V - 1) / V;
  const int cb = nvec < 32 ? nvec : 32;
  const int tr = kThreads / cb;
  Launch l;
  l.block = dim3(cb, tr);
  l.grid = dim3(row_blocks, (nvec + cb - 1) / cb);
  l.rows_per_block = (n + row_blocks - 1) / row_blocks;
  return l;
}

template <typename T, int V>
int forward(const T* x, const uint8_t* mask, const float* weight, const float* bias,
            float* running_mean, float* running_var, float keep, float momentum, float eps,
            float* scratch, float* stats, T* y, int n, int c, int row_blocks, cudaStream_t s) {
  const Launch l = launch_of<V>(n, c, row_blocks);
  float* part_mean = scratch;
  float* part_m2 = scratch + (size_t)row_blocks * c;
  float* part_n = scratch + 2 * (size_t)row_blocks * c;
  masked_bn_stats_kernel<T, V><<<l.grid, l.block, 0, s>>>(x, mask, n, c, l.rows_per_block,
                                                          part_mean, part_m2, part_n);
  if (int e = (int)cudaGetLastError()) return e;
  masked_bn_stats_final_kernel<<<(c + kFinalCols - 1) / kFinalCols, dim3(kFinalCols, kFinalLanes),
                                 0, s>>>(part_mean, part_m2, part_n, row_blocks, c, weight, bias,
                                         running_mean, running_var, keep, momentum, eps, stats);
  if (int e = (int)cudaGetLastError()) return e;
  masked_bn_apply_kernel<T, V><<<l.grid, l.block, 0, s>>>(x, mask, stats, stats + c, y, n, c,
                                                          l.rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int backward(const T* x, const T* dy, const uint8_t* mask, const float* weight,
             const float* stats, float* scratch, float* dweight, float* dbias, T* dx, int n,
             int c, int row_blocks, cudaStream_t s) {
  const Launch l = launch_of<V>(n, c, row_blocks);
  float* part_g = scratch;
  float* part_gx = scratch + (size_t)row_blocks * c;
  float* coef = scratch + 2 * (size_t)row_blocks * c;
  masked_bn_grad_stats_kernel<T, V><<<l.grid, l.block, 0, s>>>(x, dy, mask, stats, n, c,
                                                               l.rows_per_block, part_g, part_gx);
  if (int e = (int)cudaGetLastError()) return e;
  masked_bn_grad_final_kernel<<<(c + kFinalCols - 1) / kFinalCols, dim3(kFinalCols, kFinalLanes),
                                0, s>>>(part_g, part_gx, row_blocks, c, weight, stats, dweight,
                                        dbias, coef);
  if (int e = (int)cudaGetLastError()) return e;
  masked_bn_dx_kernel<T, V><<<l.grid, l.block, 0, s>>>(x, dy, mask, stats, coef, dx, n, c,
                                                       l.rows_per_block);
  return (int)cudaGetLastError();
}

// 16-byte vectors when C fills them and every row tensor is 16-byte aligned
template <typename T>
bool wide(int c, std::initializer_list<const void*> ps) {
  if (c % (16 / (int)sizeof(T)) != 0) return false;
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  return true;
}

// x's dtype T and the columns V a thread loads at once, as a type
template <typename T, int V>
struct Vec {
  using type = T;
  static constexpr int width = V;
};

// fn(Vec<T, V>{}) at x's dtype, with 16-byte vectors where `wide` allows
template <typename Fn>
int dispatch(int dtype, int c, std::initializer_list<const void*> rows, Fn fn) {
  if (dtype == kF32) return wide<float>(c, rows) ? fn(Vec<float, 4>{}) : fn(Vec<float, 1>{});
  if (dtype == kBF16)
    return wide<__nv_bfloat16>(c, rows) ? fn(Vec<__nv_bfloat16, 8>{})
                                        : fn(Vec<__nv_bfloat16, 1>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Row blocks of the row passes for x (n, c) of `dtype`: the scratch of
// masked_bn_fwd holds (2 * c + 1) * row_blocks floats, of masked_bn_bwd
// 2 * row_blocks * c + 3 * c.
extern "C" int masked_bn_row_blocks(int n, int c, int dtype) { return row_blocks_of(n, c, dtype); }

// The training forward: x (n, c) f32/bf16, mask (n,) bool or null, weight
// and bias (c,) f32, the running buffers (c,) f32 updated in place; stats
// (4 * c + 1,) f32 receives a, b, mean, rstd and the clamped count; y (n, c)
// in x's dtype.
extern "C" int masked_bn_fwd(const void* x, const uint8_t* mask, const float* weight,
                             const float* bias, float* running_mean, float* running_var,
                             float keep, float momentum, float eps, float* scratch, float* stats,
                             void* y, int n, int c, int dtype, void* stream) {
  const int rb = row_blocks_of(n, c, dtype);
  return dispatch(dtype, c, {x, y}, [&](auto vec) {
    using T = typename decltype(vec)::type;
    return forward<T, decltype(vec)::width>(
        static_cast<const T*>(x), mask, weight, bias, running_mean, running_var, keep, momentum,
        eps, scratch, stats, static_cast<T*>(y), n, c, rb, static_cast<cudaStream_t>(stream));
  });
}

// The backward: x, dy (n, c) in x's dtype, mask as the forward's, weight
// (c,) f32, stats the forward's; dweight, dbias (c,) f32; dx (n, c) in x's
// dtype.
extern "C" int masked_bn_bwd(const void* x, const void* dy, const uint8_t* mask,
                             const float* weight, const float* stats, float* scratch,
                             float* dweight, float* dbias, void* dx, int n, int c, int dtype,
                             void* stream) {
  const int rb = row_blocks_of(n, c, dtype);
  return dispatch(dtype, c, {x, dy, dx}, [&](auto vec) {
    using T = typename decltype(vec)::type;
    return backward<T, decltype(vec)::width>(
        static_cast<const T*>(x), static_cast<const T*>(dy), mask, weight, stats, scratch,
        dweight, dbias, static_cast<T*>(dx), n, c, rb, static_cast<cudaStream_t>(stream));
  });
}
