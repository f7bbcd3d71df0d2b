// Causal flash-attention forward for Hopper (sm_90a): bf16 q/k/v/out,
// f32 softmax state, f32 log-sum-exp.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py (called from `_flash_fwd` there).  It
// computes the same function: for each query row i,
//   s_ij = scale * q_i . k_j  (j <= i),  out_i = sum_j softmax(s_i)_j v_j,
//   lse_i = log sum_j exp(s_ij),
// with an online softmax (running max m, running sum l, accumulator acc,
// all f32), P rounded to bf16 before the P.V product as the TPU kernel does
// (`p.astype(v.dtype)`; l sums the unrounded P), out = acc / l in bf16.
//
// Bound on an H100: with n = B*H*S(S+1)/2 visible (query, key) pairs, one
// launch does 4*Dh*n tensor-core FLOP (S = QK^T and PV).  At the serving
// forward's shape (B=2, H=16, S=4096, Dh=128) that is 1.37e11 FLOP (0.139 ms
// at 989 TFLOP/s bf16) against 134.7 MB of q, k, v, out and lse moved once
// (0.040 ms at 3.35 TB/s); at the training path's (B=8) four times both:
// the kernel is bound by operations (PERF.md, section 6).
//
// The kernel is built on the skeleton of flash_bwd.cu's dq kernel, whose
// shape it has (resident query rows, streamed K_j and V_j up to the causal
// frontier), from the helpers in flash_sm90.cuh:
//   * Only wgmma reaches Hopper's full tensor-core rate: both products are
//     wgmma m64n64k16, bf16 in, f32 accumulate.  Two consumer warpgroups
//     own 64 query rows each, so a block keeps 128 rows; setmaxnreg gives
//     them 240 registers (the O accumulator, S and Q's A fragments) and
//     drops the producer warpgroup to 24.
//   * One producer thread issues every copy: the block's Q tile once, then
//     128-row K_j, V_j tiles through TMA into a two-stage ring with
//     full/empty mbarrier pairs, so the next tile lands while the current
//     one is computed.  Tiles use TMA's 128-byte swizzle, the layout the
//     wgmma descriptors read without bank conflicts.
//   * No transposes and no trip through shared memory for S or P.  Q stays
//     in registers as A fragments; S = Q K_j^T reads K_j K-major, 64 keys
//     (N = 64) at a time.  S's f32 accumulator, turned into P and rounded
//     to bf16, is already the register A operand of acc += P V_j, which
//     reads V_j MN-major through wgmma's transpose bit.
//   * The tensor work and the softmax of a tile run one after the other
//     within a warpgroup; the other warpgroup's products fill the gaps.
//     exp2 is one MUFU `ex2.approx.ftz`; row max and row sum reduce across
//     the 4 lanes that share a row.  128-key tiles halve the per-tile
//     work of 64-key ones (barriers, row reductions, the rescaling of acc).
//     Issuing S_{j+1} under the softmax of S_j, the two warpgroups taking
//     turns through named barriers, Q read from shared memory, and 64-key
//     tiles in a deeper ring all timed slower on an H100 (PERF.md).
//   * Causal work only: a warpgroup stops at the diagonal tile and masks
//     only that one; there the first warpgroup's rows see only the tile's
//     first 64 keys, so it computes that half alone.  A 128-row tile past
//     a sequence of odd 64-row length is ragged: TMA fills its missing
//     rows with zeros (masked as keys past every row), and the warpgroup
//     that owns the missing query rows computes and stores nothing.
//   * Blocks of a few (batch, head) pairs run together, so that the K and V
//     tiles they stream come from L2 after the first read; within each
//     group the last q tiles, the longest, run first.
//   * No atomics: each output row is written by exactly one block, so two
//     calls give bit-identical results.
//
// Inputs may be strided views (the model hands it slices of its fused qkv
// projection): the tensor maps are built per call from each view's
// strides, which must be positive multiples of 16 bytes, with a contiguous
// head dimension (the wrapper copies any other layout first).

#include "flash_sm90.cuh"

namespace {

constexpr int KV_ROWS = 128;  // rows of a streamed K or V tile
constexpr int HALVES = KV_ROWS / 64;  // its N = 64 column blocks of S
constexpr int STAGES = 2;  // depth of the streamed ring

// Shared memory in bytes: the resident Q tile, STAGES K tiles, STAGES V
// tiles, then the barriers.  Each tile is D/64 swizzled sub-tiles of
// [rows, 64].
template <int D>
struct Smem {
  static constexpr int RES_SUB = BLOCK_ROWS * 128;  // a sub-tile of Q
  static constexpr int STR_SUB = KV_ROWS * 128;     // a sub-tile of K_j or V_j
  static constexpr int RES = RES_SUB * (D / SW);
  static constexpr int STR = STR_SUB * (D / SW);
  static constexpr int Q = 0, K = RES, V = K + STAGES * STR;
  static constexpr int BARS = V + STAGES * STR;  // full[STAGES], empty[STAGES], resident
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// The online softmax of NH * 64 columns of one S tile for this thread's
// two rows (s[h][4j + 2r + e] is row row0 + 8r, column c0 + 64h + 8j +
// 2*t4 + e): on the tile that straddles the diagonal (DIAG) mask the
// columns past the row, raise the running max m (raw scores) over the 4
// lanes of each row, turn s into P = 2^(s*scale_log2 - m*scale_log2) in
// place, add P's row sums to this thread's part of l, and return alpha =
// 2^((m_old - m)*scale_log2), the factor acc and l are rescaled by.  Tile
// 0 holds key 0, which every row sees, so m is finite from the first tile
// on and no row meets -inf - -inf.
template <int NH, bool DIAG>
__device__ __forceinline__ void online_softmax(float (&s)[NH][32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int row0, int c0, int t4,
                                               float scale_log2) {
  if (DIAG) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 64 * h + 8 * j + 2 * t4 + (e & 1) > row0 + 8 * (e >> 1))
            s[h][4 * j + e] = -CUDART_INF_F;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[h][4 * j + 2 * r], s[h][4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mxs = mx * scale_log2;
    alpha[r] = ex2_ftz(m[r] * scale_log2 - mxs);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2_ftz(fmaf(s[h][4 * j + 2 * r + e], scale_log2, -mxs));
          s[h][4 * j + 2 * r + e] = p;
          sum += p;
        }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// One streamed tile, each product waited for before the next step: S =
// Q K_j^T over the tile's first NH * 64 keys, the online softmax, acc
// rescaled by alpha, acc += P V_j.  dk and dv describe the tile's K and V.
template <int D, int NH, bool DIAG>
__device__ __forceinline__ void tile_step(float (&acc)[D / SW][32], uint32_t (&fq)[D / 16][4],
                                          float (&m)[2], float (&l)[2], uint64_t dk,
                                          uint64_t dv, int row0, int c0, int t4,
                                          float scale_log2) {
  constexpr int STR_SUB = Smem<D>::STR_SUB;
  float s[NH][32], alpha[2];
  uint32_t a[NH][4][4];  // P in bf16, the A fragments of P V_j
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NH; ++h) mma_rows_t<D, STR_SUB>(s[h], fq, desc_add(dk, h * 64 * 128));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(s[h]);

  online_softmax<NH, DIAG>(s, m, l, alpha, row0, c0, t4, scale_log2);
#pragma unroll
  for (int c = 0; c < D / SW; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(a[h][kk], &s[h][8 * kk], &s[h][8 * kk + 4]);

  // The writes to acc and a stay ahead of the fence; no read of acc moves
  // ahead of the wait (the hardware reads and writes them asynchronously).
  auto pin = [&] {
#pragma unroll
    for (int c = 0; c < D / SW; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(a[h][kk]);
  };
  pin();
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NH; ++h) mma_frag_x<D, STR_SUB>(acc, a[h], desc_add(dv, h * 64 * 128));
  wgmma_commit();
  wgmma_wait<0>();
  pin();
}

// One block: the 128 query rows r0 .. r0 + 127 of one (batch, head) pair.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                     float* __restrict__ lse, int H, int S, float scale_log2, long long ob,
                     long long oh, long long os, int group) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  // Longest blocks first: the last q tiles.
  const int n_tiles = block_tiles(S);
  const BlockPlace place = block_place(n_tiles, group);
  const int bh = place.bh, b = bh / H, h = bh % H;
  const int r0 = (n_tiles - 1 - place.rank) * BLOCK_ROWS;
  const int t_end = r0 / KV_ROWS + 1;  // K/V tiles the block sees, the last on the diagonal

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * CONSUMERS);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy.
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(resident, L::RES);
#pragma unroll
      for (int c = 0; c < D / SW; ++c)
        tma_load_4d(smem + L::Q + c * L::RES_SUB, &qmap, resident, c * SW, r0, h, b);
      int stage = 0, phase = 0;
      for (int t = 0; t < t_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * L::STR);
#pragma unroll
        for (int c = 0; c < D / SW; ++c) {
          tma_load_4d(smem + L::K + stage * L::STR + c * L::STR_SUB, &kmap, &full[stage],
                      c * SW, t * KV_ROWS, h, b);
          tma_load_4d(smem + L::V + stage * L::STR + c * L::STR_SUB, &vmap, &full[stage],
                      c * SW, t * KV_ROWS, h, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows w0 .. w0 + 63 and computes
    // every K/V tile of the block, the last (the diagonal) masked.
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
    const int w0 = r0 + cw * WG_ROWS;
    const int row0 = w0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
    const bool active = w0 < S;                  // false for the empty half of a ragged tile

    float acc[D / SW][32];
#pragma unroll
    for (int c = 0; c < D / SW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of the raw scores
    float l[2] = {0.f, 0.f};                      // this thread's part of the running sum

    mbar_wait(resident, 0);
    uint32_t fq[D / 16][4];
    load_a_frags<D, L::RES_SUB>(fq, smem + L::Q, cw * WG_ROWS + warp * 16, lane);

    int stage = 0, phase = 0;
    for (int t = 0; t < t_end; ++t) {
      mbar_wait(&full[stage], phase);
      const uint64_t dk = desc_sw128(smem + L::K + stage * L::STR, 16, SW_ATOM);
      const uint64_t dv = desc_sw128(smem + L::V + stage * L::STR, L::STR_SUB, SW_ATOM);
      const int c0 = t * KV_ROWS;
      if (active) {
        if (t < t_end - 1)
          tile_step<D, HALVES, false>(acc, fq, m, l, dk, dv, row0, c0, t4, scale_log2);
        else if (cw == 0)  // the diagonal tile's keys r0 .. r0 + 63, all these rows see
          tile_step<D, 1, true>(acc, fq, m, l, dk, dv, row0, c0, t4, scale_log2);
        else
          tile_step<D, HALVES, true>(acc, fq, m, l, dk, dv, row0, c0, t4, scale_log2);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const float inv = 1.f / lr;
        const int row = row0 + 8 * r;
        const long long off = b * ob + h * oh + static_cast<long long>(row) * os + 2 * t4;
#pragma unroll
        for (int c = 0; c < D / SW; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(out + off + c * SW + 8 * j) =
                pack_bf16(acc[c][4 * j + 2 * r] * inv, acc[c][4 * j + 2 * r + 1] * inv);
        if (t4 == 0)
          lse[static_cast<long long>(bh) * S + row] =
              (m[r] * scale_log2 + log2f(lr)) * 0.6931471805599453f;
      }
    }
  }
}

// Build the three tensor maps (Q in 128-row tiles, K and V in KV_ROWS-row
// tiles) and launch; cudaErrorInvalidValue if a map is refused.
template <int D>
cudaError_t launch(View q, View k, View v, void* o, void* lse, int B, int H, int S, float scale,
                   long long ob, long long oh, long long os, cudaStream_t stream) {
  CUtensorMap m[3];
  const View views[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_tile_map(&m[i], views[i], B, H, S, D, i == 0 ? BLOCK_ROWS : KV_ROWS))
      return cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::BYTES;
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Grouped by the four [S, D] tensors of each pair (q, k, v and out).
  const int group = l2_group(B * H, S, D, 4);
  kern<<<B * H * block_tiles(S), THREADS, smem, stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(o), static_cast<float*>(lse), H, S, scale * LOG2E,
      ob, oh, os, group);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, S, D] bf16 views with the given element strides
// (batch, head, row; the head dimension is contiguous).  lse: [B, H, S]
// f32, contiguous.  Returns a cudaError_t: cudaErrorInvalidValue for a
// shape or layout the kernel does not take, else the launch's
// cudaGetLastError().
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int S, int D, float scale, long long qb,
                              long long qh, long long qs, long long kb, long long kh,
                              long long ks, long long vb, long long vh, long long vs,
                              long long ob, long long oh, long long os, void* stream) {
  // Each warpgroup's 64 rows lie wholly inside or outside the sequence.
  if (B < 1 || H < 1 || S < WG_ROWS || S % WG_ROWS != 0) return cudaErrorInvalidValue;
  const View Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(Q, K, V, o, lse, B, H, S, scale, ob, oh, os, s);
  if (D == 64) return launch<64>(Q, K, V, o, lse, B, H, S, scale, ob, oh, os, s);
  return cudaErrorInvalidValue;
}

// cudaFuncGetAttributes of the forward kernel for head dim D, into
// out[5]: registers a thread at launch (before setmaxnreg), static shared
// memory bytes a block, local (spill) bytes a thread, the most threads a
// block may have, and the most dynamic shared memory a block may have,
// which after a launch is what launch() set for it.
extern "C" int flash_fwd_attributes(int D, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128) err = cudaFuncGetAttributes(&a, flash_fwd_kernel<128>);
  else if (D == 64) err = cudaFuncGetAttributes(&a, flash_fwd_kernel<64>);
  if (err != cudaSuccess) return err;
  const int vals[5] = {a.numRegs, static_cast<int>(a.sharedSizeBytes),
                       static_cast<int>(a.localSizeBytes), a.maxThreadsPerBlock,
                       a.maxDynamicSharedSizeBytes};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return cudaSuccess;
}
