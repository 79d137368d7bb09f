// Shared device code of the tensor-core layer backwards (bspline_fused.cu,
// fastkan_layer.cu): ldmatrix, mma.sync.m16n8k16 with bf16 operands and f32
// accumulators, 16-byte cp.async copies with commit/wait groups, and the
// staging of row tiles into shared memory.
#pragma once

#include "kan_common.cuh"

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

// blocks of `kernel` (kThreads threads, `smem` bytes) resident on one SM,
// and the number of SMs
template <typename K>
void occupancy(K kernel, size_t smem, int& per_sm, int& sms) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  per_sm = per_sm < 1 ? 1 : per_sm;
}

}  // namespace kan
