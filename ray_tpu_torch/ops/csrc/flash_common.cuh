// Device helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu, both through flash_sm90.cuh): bf16 packing and the
// accumulator-to-A-fragment layout.  Each kernel source is its own shared
// library, so each gets its own copy of `rtt_cuda_error_string`, which the
// ctypes loader (ops/_build.py) binds in every library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
