// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): the work split they share (two consumer
// warpgroups of 64 rows, a producer warpgroup, 128-row blocks grouped by
// (batch, head) and ordered longest first), mbarriers, TMA tile loads,
// wgmma descriptors and instructions, the two products every kernel runs,
// register reallocation, and the host-side construction of TMA tensor maps.
//
// Shared-memory tiles are bf16 with TMA's 128-byte swizzle: a [rows, D]
// tile is stored as D/64 sub-tiles of [rows, 64] (one 128-byte row each),
// every sub-tile 1024-byte aligned.  The wgmma descriptors below describe
// exactly that layout, so TMA's swizzle and wgmma's agree.
//
// cuTensorMapEncodeTiled belongs to the CUDA driver API (libcuda); it is
// fetched at run time through the runtime's cudaGetDriverEntryPoint, so
// nothing links against libcuda.

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The work split

constexpr int WG_ROWS = 64;                        // rows a consumer warpgroup owns
constexpr int CONSUMERS = 2;                       // consumer warpgroups a block
constexpr int BLOCK_ROWS = WG_ROWS * CONSUMERS;    // resident rows of a block
constexpr int THREADS = 128 * (1 + CONSUMERS);     // producer warpgroup first
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// The (batch, head) pair and the rank of this block's 128-row tile among
// the pair's n_tiles, rank 0 first.  Pairs go in groups of `group`, whose
// blocks run together so that the tiles they all stream stay in L2; within
// a group the ranks go in turn, so that the kernel can run its longest
// tiles first and let short blocks fill the tail.
struct BlockPlace {
  int bh, rank;
};

__device__ __forceinline__ BlockPlace block_place(int n_tiles, int group) {
  const int n_bh = gridDim.x / n_tiles;
  const int g0 = blockIdx.x / (group * n_tiles) * group;
  const int g_size = min(group, n_bh - g0);
  const int in_group = blockIdx.x - g0 * n_tiles;
  return {g0 + in_group % g_size, in_group / g_size};
}

// Host: the pairs of a group, so that `tensors` [S, D] bf16 tensors of
// each (those it streams and those it keeps or writes) fill about 16 MB of
// the 50 MB L2 together.
inline int l2_group(int n_bh, int S, int D, int tensors) {
  const long long fit = (16LL << 20) / (static_cast<long long>(tensors) * S * D * sizeof(bf16));
  return fit < 1 ? 1 : (fit > n_bh ? n_bh : static_cast<int>(fit));
}

// 128-row blocks of a sequence of S rows, the last maybe ragged.
__host__ __device__ inline int block_tiles(int S) { return (S + BLOCK_ROWS - 1) / BLOCK_ROWS; }

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barrier initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of transactions (the TMA loads).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of transactions on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Register reallocation between warpgroups

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 2^x in one MUFU instruction (results below 2^-126 flush to zero, far
// below the bf16 rounding of P), without exp2f's range handling, which
// lengthened the exposed elementwise work (PERF.md).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma

constexpr int SW = 64;            // bf16 elements in a 128-byte swizzled row
constexpr int SW_ATOM = 8 * 128;  // bytes of one swizzle atom (8 rows)

// Descriptor of a 128-byte-swizzled operand at `p`.  K-major (the
// reduction dimension contiguous): `sbo` is the byte stride between groups
// of 8 rows; the leading offset is unused.  MN-major (transposed, the
// output dimension contiguous): `sbo` is the byte stride between groups of
// 8 reduction rows, and `lbo` between 64-wide column blocks (unused for an
// N of 64, one column block).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Offset a descriptor's start address by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// this point (the hardware reads and writes them asynchronously).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define RTT_WGMMA_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RTT_WGMMA_OUT32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B both K-major in shared
// memory; `accumulate` 0 overwrites d.  Per thread of the warpgroup, d[4j
// + e] holds row 16*warp + lane/4 + 8*(e/2), column 8j + 2*(lane%4) + e%2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RTT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (the m16n8k16
// A-fragment layout per warp, see acc_to_a) and B in shared memory:
// K-major (TRANS_B 0) or MN-major (TRANS_B 1, wgmma's transpose bit: B's
// rows are stored as rows, no transpose through shared memory).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : RTT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

#undef RTT_WGMMA_D32
#undef RTT_WGMMA_OUT32

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A fragments (all D/16 k-steps) of a warp's 16 rows, from `row` on,
// of a swizzled [rows, D] tile whose 64-column sub-tiles are SUB bytes
// apart.
template <int D, int SUB>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const unsigned char* tile,
                                             int row, int lane) {
  const int r = row + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = (kk % 4) * 2 + (lane >> 4);  // 16-byte chunk of the 128-byte row
    ldmatrix_x4(a[kk], tile + (kk / 4) * SUB + r * 128 + ((chunk ^ (r % 8)) * 16));
  }
}

// s[64 x 64] = A B^T over the head dim: A in registers (`a`, all D/16
// k-steps of this warpgroup's rows, see load_a_frags), B the 64-row
// streamed tile (`db`), K-major.  Within a 128-byte row a 16-column step
// is 32 bytes; every 64 columns the next sub-tile (B_SUB bytes on) starts.
template <int D, int B_SUB>
__device__ __forceinline__ void mma_rows_t(float (&s)[32], uint32_t (&a)[D / 16][4], uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs<0>(s, a[kk], desc_add(db, (kk / 4) * B_SUB + (kk % 4) * 32), kk > 0);
}

// acc[64 x D] += A X, A the [64 x 64] fragments `a` (k-steps of 16 along
// the streamed rows), X the streamed [64, D] tile read MN-major (`dx`):
// each 16-row step is 16 * 128 bytes on, each 64-column block a sub-tile.
template <int D, int X_SUB>
__device__ __forceinline__ void mma_frag_x(float (&acc)[D / SW][32], uint32_t (&a)[4][4],
                                           uint64_t dx) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < D / SW; ++c) wgmma_rs<1>(acc[c], a[kk], desc_add(dx, c * X_SUB + kk * 2048), 1);
}

// The 1024-byte aligned start of dynamic shared memory (the launch asks
// for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// Host: tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Element strides (batch, head, row) of one [B, H, S, D] view.
struct View {
  const void* ptr;
  long long sb, sh, ss;
};

// Tensor map of a bf16 [B, H, S, D] view with a contiguous head
// dimension, as dims (D, S, H, B), loaded in boxes of [rows, 64] with the
// 128-byte swizzle.  Rows past S read as zeros.
bool make_tile_map(CUtensorMap* map, const View& view, int B, int H, int S, int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const long long el[3] = {view.ss, view.sh, view.sb};
  cuuint64_t strides[3];
  cuuint64_t span = static_cast<cuuint64_t>(D) * sizeof(bf16);
  for (int i = 0; i < 3; ++i) {
    if (el[i] <= 0 && dims[i + 1] > 1) return false;
    // A dimension of one is never stepped: give it a stride TMA accepts.
    cuuint64_t st = static_cast<cuuint64_t>(el[i]) * sizeof(bf16);
    if (dims[i + 1] == 1) st = span;
    strides[i] = st;
    if (st * dims[i + 1] > span) span = st * dims[i + 1];
  }
  const cuuint32_t box[4] = {SW, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(view.ptr), dims,
                strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
