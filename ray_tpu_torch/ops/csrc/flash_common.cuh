// Device helpers shared by the flash-attention kernels: cp.async tile
// loads, mma.sync m16n8k16 bf16 with f32 accumulation and ldmatrix.trans
// (flash_fwd.cu), bf16 packing and the accumulator-to-A-fragment layout
// (both kernels; flash_bwd.cu through flash_sm90.cuh).  Each kernel source
// is its own shared library, so each gets its own copy of
// `rtt_cuda_error_string`, which the ctypes loader (ops/_build.py) binds in
// every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed cp.async groups of this thread are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// c += a * b for one m16n8k16 tile: a row-major 16x16 bf16, b col-major
// 16x8 bf16, c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS x D tile from global (row stride `ld` elements) into shared memory
// (row stride D + PAD), 16 bytes per cp.async.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int tid) {
  constexpr int CHUNKS = D / 8;
  static_assert((ROWS * CHUNKS) % NT == 0, "tile must split evenly over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16(dst + r * (D + PAD) + col, src + r * ld + col);
  }
}

// The S accumulators of two neighbouring 16x8 tiles, rounded to bf16, as the
// A fragment of one 16x16 tile: a product's output feeds the next product
// without leaving registers.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace

extern "C" const char* rtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
