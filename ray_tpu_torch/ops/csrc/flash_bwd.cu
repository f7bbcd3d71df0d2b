// Causal flash-attention backward for Hopper (sm_90a): two kernels, bf16
// q/k/v/dO in, bf16 dq/dk/dv out, f32 lse and delta = rowsum(dO * out)
// computed by the caller.
//
// `flash_dq_bf16` replaces the Pallas TPU kernel `_dq_kernel` and
// `flash_dkdv_bf16` replaces `_dkdv_kernel`, both in
// ray_tpu/ops/flash_attention.py (launched from `_flash_bwd_pallas` there).
// They compute the same functions, with P recomputed from the forward's lse
// instead of being stored:
//   P_ij  = exp(scale * q_i . k_j - lse_i)  (j <= i, else 0),
//   dP_ij = dO_i . v_j,   dS_ij = P_ij (dP_ij - delta_i),
//   dq_i  = scale * sum_j dS_ij k_j,
//   dk_j  = scale * sum_i dS_ij q_i,   dv_j = sum_i P_ij dO_i,
// with P and dS rounded to bf16 before the products that consume them, as
// the TPU kernels do (`.astype(kb.dtype)`, `p.astype(gb.dtype)`), and every
// product accumulated in f32.
//
// Bound on an H100: with n = B*H*S(S+1)/2 visible (query, key) pairs, dq
// does 6*Dh*n tensor-core FLOP (S = QK^T, dP = dO V^T, dS K) and dk/dv
// 8*Dh*n (S^T = K Q^T, dP^T = V dO^T, P^T dO, dS^T Q).  At the training
// path's shape (B=8, H=16, S=4096, Dh=128) that is 8.25e11 FLOP (0.834 ms at
// 989 TFLOP/s bf16) against 675 MB moved once (0.202 ms at 3.35 TB/s) for
// dq, and 1.10e12 FLOP (1.112 ms) against 810 MB (0.242 ms) for dk/dv: both
// are bound by operations (PERF.md, section 6).
//
// What limits a flash backward on this card, and what this design does
// about each:
//   * Only wgmma reaches Hopper's full tensor-core rate (mma.sync does
//     not): the products are wgmma m64n64k16, bf16 in, f32 accumulate.
//     Two consumer warpgroups own 64 resident rows each, so a block keeps
//     128 rows.
//   * Loads issued by the computing threads cost them instructions and
//     registers and hide little: copies go through TMA into a three-stage
//     ring with full/empty mbarrier pairs, issued by one producer thread,
//     so the next tiles land while the current one is computed.  Tiles use
//     TMA's 128-byte swizzle, the layout wgmma's descriptors read without
//     bank conflicts.
//   * Registers: dk/dv holds two 64 x Dh f32 accumulators beside a 64-row
//     streamed tile's S^T and dP^T.  setmaxnreg gives the consumers 240
//     registers and drops the producer warpgroup to 24.
//   * No transposes through shared memory.  S^T = K_j Q_i^T and
//     dP^T = V_j dO_i^T (dk/dv), or S = Q K_j^T and dP = dO V_j^T (dq),
//     read the streamed tile K-major.  Their f32 accumulators, turned into
//     P and dS and rounded to bf16, are already in the register A-operand
//     layout of the second products (dV += P^T dO_i, dK += dS^T Q_i;
//     dQ += dS K_j), whose B operand is the same streamed tile read
//     MN-major through wgmma's transpose bit.
//   * Shared-memory bandwidth: a 64x64x16 wgmma with both operands in
//     shared memory reads 4 KB in its 32 cycles, the SM's whole 128 bytes
//     a cycle.  dq keeps its resident Q and dO rows in registers as A
//     fragments, which halves that.  dk/dv keeps K and V in shared memory:
//     beside its two accumulators it has no registers left for them.
//   * Blocks of a few (batch, head) pairs run together, so that the tiles
//     they stream come from L2 after the first read.
//
// Layout of the work, unlike the TPU grid (which keeps whole K/V or Q/dO
// rows in VMEM and walks blocks in order on one core):
//   * dq: one block per (batch*head, 128-row q tile).  Q, dO, lse and delta
//     stay resident; 64-row K_j, V_j tiles stream up to the causal frontier.
//   * dk/dv: one block per (batch*head, 128-row k/v tile).  K_j, V_j stay
//     resident; 64-row Q_i, dO_i tiles and their lse and delta stream from
//     the diagonal to the end.
//   * Causal work only: a warpgroup skips the streamed tiles that lie wholly
//     outside its causal half, and masks only those that straddle the
//     diagonal.  A 128-row tile past a sequence of odd 64-row length is
//     ragged: TMA fills its missing rows with zeros, and the warpgroup that
//     owns them computes and stores nothing.
//   * Longest blocks first within each group of pairs, so that short
//     blocks fill the tail.
//   * No atomics: each output row is written by exactly one block, so two
//     calls give bit-identical results.  A fused backward would sum dq
//     across the k/v blocks with atomics, so dq stays a kernel of its own.
//
// Inputs may be strided views (the model hands it slices of its fused qkv
// projection, and dO in [B, S, H, D] order): the tensor maps are built per
// call from each view's strides, which must be positive multiples of 16
// bytes, with a contiguous head dimension.
//
// The work split (warpgroups, register split, block order and grouping),
// the register-A products both kernels share with the forward (S from
// resident fragments, the second product through the transpose bit) and
// exp2 live in flash_sm90.cuh; flash_fwd.cu is built on dq's skeleton.

#include "flash_sm90.cuh"

namespace {

constexpr int STREAM_ROWS = 64;  // rows of a streamed tile
constexpr int STAGES = 3;        // depth of the streamed ring

// Shared memory in bytes: two resident tiles, STAGES pairs of streamed
// tiles, STAGES pairs of streamed lse/delta rows (dk/dv), then the
// barriers.  Each tile is D/64 swizzled sub-tiles of [rows, 64].
template <int D>
struct Smem {
  static constexpr int RES_SUB = BLOCK_ROWS * 128;  // a resident sub-tile
  static constexpr int STR_SUB = STREAM_ROWS * 128;  // a streamed sub-tile
  static constexpr int RES = RES_SUB * (D / SW);
  static constexpr int STR = STR_SUB * (D / SW);
  static constexpr int ROWV = STREAM_ROWS * 4;  // lse or delta of a streamed tile
  static constexpr int RES1 = 0, RES2 = RES;
  static constexpr int STR1 = 2 * RES, STR2 = STR1 + STAGES * STR;
  static constexpr int LSE = STR2 + STAGES * STR, DELTA = LSE + STAGES * ROWV;
  static constexpr int BARS = DELTA + STAGES * ROWV;  // full[STAGES], empty[STAGES], resident
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// s[64 x 64] = A B^T over the head dim, as the register-A mma_rows_t of
// flash_sm90.cuh, with A this warpgroup's 64 rows of a resident tile in
// shared memory (descriptor `da`, K-major).
template <int D, int A_SUB, int B_SUB>
__device__ __forceinline__ void mma_rows_t(float (&s)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(s, desc_add(da, (kk / 4) * A_SUB + (kk % 4) * 32),
             desc_add(db, (kk / 4) * B_SUB + (kk % 4) * 32), kk > 0);
  }
}

// DQ: dq block.  Resident (res1, res2) = (Q, dO), streamed (str1, str2) =
// (K, V); out1 = dq.  Else dk/dv block: resident (K, V), streamed (Q, dO)
// with their lse and delta; out1 = dk, out2 = dv.  A warpgroup's rows are
// the products' rows (queries for dq, keys for dk/dv), a streamed tile's
// rows their columns.
template <int D, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap res1,
                     const __grid_constant__ CUtensorMap res2,
                     const __grid_constant__ CUtensorMap str1,
                     const __grid_constant__ CUtensorMap str2, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ out1,
                     bf16* __restrict__ out2, int H, int S, float scale, long long ob,
                     long long oh, long long os, int group) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  // Longest blocks first: for dq the last q tiles, for dk/dv the first
  // k/v tiles.
  const int n_tiles = block_tiles(S);
  const BlockPlace place = block_place(n_tiles, group);
  const int bh = place.bh, b = bh / H, h = bh % H;
  const int r0 = (DQ ? n_tiles - 1 - place.rank : place.rank) * BLOCK_ROWS;
  // The streamed tiles this block's rows see.
  const int t_begin = DQ ? 0 : r0 / STREAM_ROWS;
  const int t_end = DQ ? min(r0 + BLOCK_ROWS, S) / STREAM_ROWS : S / STREAM_ROWS;

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
      mbar_expect_tx(resident, 2 * L::RES);
#pragma unroll
      for (int c = 0; c < D / SW; ++c) {
        tma_load_4d(smem + L::RES1 + c * L::RES_SUB, &res1, resident, c * SW, r0, h, b);
        tma_load_4d(smem + L::RES2 + c * L::RES_SUB, &res2, resident, c * SW, r0, h, b);
      }
      int stage = 0, phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * L::STR + (DQ ? 0 : 2 * L::ROWV));
#pragma unroll
        for (int c = 0; c < D / SW; ++c) {
          tma_load_4d(smem + L::STR1 + stage * L::STR + c * L::STR_SUB, &str1, &full[stage],
                      c * SW, t * STREAM_ROWS, h, b);
          tma_load_4d(smem + L::STR2 + stage * L::STR + c * L::STR_SUB, &str2, &full[stage],
                      c * SW, t * STREAM_ROWS, h, b);
        }
        if (!DQ) {
          const long long row = (long long)bh * S + t * STREAM_ROWS;
          bulk_load(smem + L::LSE + stage * L::ROWV, lse + row, L::ROWV, &full[stage]);
          bulk_load(smem + L::DELTA + stage * L::ROWV, delta + row, L::ROWV, &full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows w0 .. w0 + 63.
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int w0 = r0 + cw * WG_ROWS;
    const int row0 = w0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const bool active = w0 < S;           // false for the empty half of a ragged tile
    const float scale_log2 = scale * LOG2E;

    float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};  // dq: per row, lse in log2 units
    if (DQ && active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse[(long long)bh * S + row0 + 8 * r] * LOG2E;
        dlt[r] = delta[(long long)bh * S + row0 + 8 * r];
      }
    }

    float acc1[D / SW][32], acc2[D / SW][32];
#pragma unroll
    for (int c = 0; c < D / SW; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[c][i] = acc2[c][i] = 0.f;

    // The resident rows enter S and dP as the A operand: dq keeps them in
    // registers (its one accumulator leaves the room), which halves the
    // shared-memory reads of those products; dk/dv, with two accumulators,
    // reads them from shared memory (K in registers spilled, PERF.md).
    const uint64_t d_res1 = desc_sw128(smem + L::RES1 + cw * WG_ROWS * 128, 16, SW_ATOM);
    const uint64_t d_res2 = desc_sw128(smem + L::RES2 + cw * WG_ROWS * 128, 16, SW_ATOM);
    mbar_wait(resident, 0);
    uint32_t f1[D / 16][4], f2[D / 16][4];
    if (DQ) {
      load_a_frags<D, L::RES_SUB>(f1, smem + L::RES1, cw * WG_ROWS + warp * 16, lane);
      load_a_frags<D, L::RES_SUB>(f2, smem + L::RES2, cw * WG_ROWS + warp * 16, lane);
    }

    int stage = 0, phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      mbar_wait(&full[stage], phase);
      const int c0 = t * STREAM_ROWS;  // first column (streamed row) of the tile
      const bool skip = !active || (DQ ? c0 > w0 + WG_ROWS - 1 : c0 + STREAM_ROWS - 1 < w0);
      if (!skip) {
        unsigned char* x1 = smem + L::STR1 + stage * L::STR;
        unsigned char* x2 = smem + L::STR2 + stage * L::STR;
        float s[32], dp[32];
        wgmma_fence();
        if (DQ) {
          mma_rows_t<D, L::STR_SUB>(s, f1, desc_sw128(x1, 16, SW_ATOM));
          mma_rows_t<D, L::STR_SUB>(dp, f2, desc_sw128(x2, 16, SW_ATOM));
        } else {
          mma_rows_t<D, L::RES_SUB, L::STR_SUB>(s, d_res1, desc_sw128(x1, 16, SW_ATOM));
          mma_rows_t<D, L::RES_SUB, L::STR_SUB>(dp, d_res2, desc_sw128(x2, 16, SW_ATOM));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (DQ) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            fence_regs(f1[kk]);
            fence_regs(f2[kk]);
          }
        }

        // P = exp(S * scale - lse) and dS = P (dP - delta), masked only on
        // the tiles that straddle the diagonal.
        const bool diag = DQ ? c0 + STREAM_ROWS - 1 > w0 : c0 < w0 + WG_ROWS - 1;
        const float* tl = reinterpret_cast<const float*>(smem + L::LSE + stage * L::ROWV);
        const float* td = reinterpret_cast<const float*>(smem + L::DELTA + stage * L::ROWV);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 lc = make_float2(0.f, 0.f), dc = lc;
          if (!DQ) {
            lc = *reinterpret_cast<const float2*>(tl + 8 * j + 2 * t4);
            dc = *reinterpret_cast<const float2*>(td + 8 * j + 2 * t4);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1), col = c0 + 8 * j + 2 * t4 + (e & 1);
            const float l2 = DQ ? lse2[e >> 1] : ((e & 1) ? lc.y : lc.x) * LOG2E;
            const float dl = DQ ? dlt[e >> 1] : ((e & 1) ? dc.y : dc.x);
            const bool off = diag && (DQ ? col > row : col < row);
            const float p = off ? 0.f : ex2_ftz(s[4 * j + e] * scale_log2 - l2);
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - dl);
          }
        }

        // acc1 += dS X1 and (dk/dv) acc2 += P X2, dS and P rounded to bf16
        // in registers as the A operand.
        uint32_t a_ds[4][4], a_p[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(a_ds[kk], &dp[8 * kk], &dp[8 * kk + 4]);
          if (!DQ) acc_to_a(a_p[kk], &s[8 * kk], &s[8 * kk + 4]);
        }
#pragma unroll
        for (int c = 0; c < D / SW; ++c) {
          fence_regs(acc1[c]);
          if (!DQ) fence_regs(acc2[c]);
        }
        wgmma_fence();
        mma_frag_x<D, L::STR_SUB>(acc1, a_ds, desc_sw128(x1, L::STR_SUB, SW_ATOM));
        if (!DQ) mma_frag_x<D, L::STR_SUB>(acc2, a_p, desc_sw128(x2, L::STR_SUB, SW_ATOM));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < D / SW; ++c) {
          fence_regs(acc1[c]);
          if (!DQ) fence_regs(acc2[c]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(a_ds[kk]);
          if (!DQ) fence_regs(a_p[kk]);
        }
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
        const long long off = b * ob + h * oh + (long long)(row0 + 8 * r) * os + 2 * t4;
#pragma unroll
        for (int c = 0; c < D / SW; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * SW + 8 * j;
            *reinterpret_cast<uint32_t*>(out1 + off + col) =
                pack_bf16(acc1[c][4 * j + 2 * r] * scale, acc1[c][4 * j + 2 * r + 1] * scale);
            if (!DQ)
              *reinterpret_cast<uint32_t*>(out2 + off + col) =
                  pack_bf16(acc2[c][4 * j + 2 * r], acc2[c][4 * j + 2 * r + 1]);
          }
      }
    }
  }
}

// Build the four tensor maps (resident tiles of 128 rows, streamed of 64)
// and launch; cudaErrorInvalidValue if a map is refused.
template <int D, bool DQ>
cudaError_t launch(View r1, View r2, View s1, View s2, const void* lse, const void* delta,
                   void* out1, void* out2, int B, int H, int S, float scale, long long ob,
                   long long oh, long long os, cudaStream_t stream) {
  CUtensorMap m[4];
  const View views[4] = {r1, r2, s1, s2};
  for (int i = 0; i < 4; ++i) {
    if (!make_tile_map(&m[i], views[i], B, H, S, D, i < 2 ? BLOCK_ROWS : STREAM_ROWS))
      return cudaErrorInvalidValue;
  }
  constexpr int smem = Smem<D>::BYTES;
  auto kern = flash_bwd_kernel<D, DQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Grouped by the four [S, D] tensors of each pair (the streamed two and
  // the resident two).
  const int group = l2_group(B * H, S, D, 4);
  kern<<<B * H * block_tiles(S), THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(out1), static_cast<bf16*>(out2), H, S, scale, ob, oh, os, group);
  return cudaGetLastError();
}

bool shape_ok(int B, int H, int S) {
  return B >= 1 && H >= 1 && S >= STREAM_ROWS && S % STREAM_ROWS == 0;
}

}  // namespace

// q, k, v, g (= dO), dq: [B, H, S, D] bf16 views with the given element
// strides (batch, head, row; the head dimension is contiguous).  lse, delta:
// [B, H, S] f32, contiguous.  Returns a cudaError_t: cudaErrorInvalidValue
// for a shape or layout the kernel does not take, else the launch's
// cudaGetLastError().
extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, void* dq, int B, int H, int S,
                             int D, float scale, long long qb, long long qh, long long qs,
                             long long kb, long long kh, long long ks, long long vb,
                             long long vh, long long vs, long long gb, long long gh,
                             long long gs, long long ob, long long oh, long long os,
                             void* stream) {
  if (!shape_ok(B, H, S)) return cudaErrorInvalidValue;
  const View Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs}, G{g, gb, gh, gs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, true>(Q, G, K, V, lse, delta, dq, nullptr, B, H, S, scale, ob, oh, os, s);
  if (D == 64)
    return launch<64, true>(Q, G, K, V, lse, delta, dq, nullptr, B, H, S, scale, ob, oh, os, s);
  return cudaErrorInvalidValue;
}

// As flash_dq_bf16, with dk and dv sharing one layout (ob, oh, os).
extern "C" int flash_dkdv_bf16(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, void* dk, void* dv, int B,
                               int H, int S, int D, float scale, long long qb, long long qh,
                               long long qs, long long kb, long long kh, long long ks,
                               long long vb, long long vh, long long vs, long long gb,
                               long long gh, long long gs, long long ob, long long oh,
                               long long os, void* stream) {
  if (!shape_ok(B, H, S)) return cudaErrorInvalidValue;
  const View Q{q, qb, qh, qs}, K{k, kb, kh, ks}, V{v, vb, vh, vs}, G{g, gb, gh, gs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, false>(K, V, Q, G, lse, delta, dk, dv, B, H, S, scale, ob, oh, os, s);
  if (D == 64)
    return launch<64, false>(K, V, Q, G, lse, delta, dk, dv, B, H, S, scale, ob, oh, os, s);
  return cudaErrorInvalidValue;
}

// cudaFuncGetAttributes of the dq (dq != 0) or dk/dv kernel for head dim
// D, into out[5]: registers a thread at launch (before setmaxnreg), static
// shared memory bytes a block, local (spill) bytes a thread, the most
// threads a block may have, and the most dynamic shared memory a block may
// have, which after a launch is what launch() set for it.
extern "C" int flash_bwd_attributes(int D, int dq, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128)
    err = dq ? cudaFuncGetAttributes(&a, flash_bwd_kernel<128, true>)
             : cudaFuncGetAttributes(&a, flash_bwd_kernel<128, false>);
  else if (D == 64)
    err = dq ? cudaFuncGetAttributes(&a, flash_bwd_kernel<64, true>)
             : cudaFuncGetAttributes(&a, flash_bwd_kernel<64, false>);
  if (err != cudaSuccess) return err;
  const int vals[5] = {a.numRegs, static_cast<int>(a.sharedSizeBytes),
                       static_cast<int>(a.localSizeBytes), a.maxThreadsPerBlock,
                       a.maxDynamicSharedSizeBytes};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return cudaSuccess;
}
