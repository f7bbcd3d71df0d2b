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
// are bound by operations.  The design therefore keeps every product on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulation), keeps S, P, dP
// and dS in registers (a product's accumulator layout is the next product's
// A-fragment layout, so none of them touches shared or device memory), and
// walks only the causal half of each row or column.
//
// Layout of the work, unlike the TPU grid (which keeps whole K/V or Q/dO
// rows in VMEM and walks blocks in order on one core):
//   * dq: one block per (batch*head, 64-row q tile), 4 warps of 16 query
//     rows.  Q, dO, lse and delta of the tile stay resident; 64-row K and V
//     tiles stream through a two-stage cp.async ring up to the causal
//     frontier, and only the diagonal tile is masked.  K enters dS K as the
//     B operand through ldmatrix.trans from the same tile that fed Q K^T.
//   * dk/dv: one block per (batch*head, 64-row k/v tile j), 4 warps of 16
//     key rows.  K_j and V_j stay resident; 32-row tiles of Q, dO, lse and
//     delta stream through a two-stage ring from the diagonal to the end,
//     and only the tiles that straddle the diagonal are masked.  Computing
//     S^T = K_j Q_i^T directly leaves P^T and dS^T in registers as the A
//     operand of dV += P^T dO_i and dK += dS^T Q_i: no transpose through
//     shared memory.
//   * Longest blocks first: the last q tiles for dq, the first k/v tiles
//     for dk/dv.
//   * No atomics: each output row is written by exactly one block, so two
//     calls give bit-identical results.
// Registers: the dk/dv kernel holds two f32 [16, Dh] accumulators a thread's
// warp owns (2 * Dh/8 * 4 = 128 floats a thread at Dh=128) besides the
// [16, BQ] S^T and dP^T tiles (2 * BQ/8 * 4 floats).  BQ = 32 keeps that
// at 160 floats and compiles without spills; BQ = 64 spilled and ran slower
// on an H100 (PERF.md).
// wgmma, TMA and warp specialisation are not used yet.
//
// Inputs may be strided views (the model hands it slices of its fused qkv
// projection); the head dimension must be contiguous, rows 16-byte aligned.

#include "flash_common.cuh"

namespace {

constexpr int BWD_TILE = 64;  // q rows of a dq block, k/v rows of a dk/dv block
constexpr int DKDV_BQ = 32;   // q rows streamed past a dk/dv block per step

// Element strides (batch, head, row) of q, k, v, dO and of the outputs
// (dq, or dk and dv, which share one layout).
struct BwdStrides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs, ob, oh, os;
};

template <int D, int BM, int BN>
__global__ void __launch_bounds__(BM / 16 * 32)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int S, float scale, BwdStrides st) {
  constexpr int NT = BM / 16 * 32;
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + BM * LD;
  bf16* sK = sG + BM * LD;  // two stages of BN rows
  bf16* sV = sK + 2 * BN * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = q_tile * BM;

  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;
  load_tile<BM, D, NT>(sQ, q + b * st.qb + h * st.qh + (long long)q0 * st.qs, st.qs, tid);
  load_tile<BM, D, NT>(sG, g + b * st.gb + h * st.gh + (long long)q0 * st.gs, st.gs, tid);
  load_tile<BN, D, NT>(sK, kp, st.ks, tid);
  load_tile<BN, D, NT>(sV, vp, st.vs, tid);
  cp_async_commit();

  const int wrow = q0 + warp * 16;  // first query row of this warp
  const int row0 = wrow + gr;       // this thread's rows: row0 and row0 + 8
  float lse2[2], dlt[2];            // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse[(long long)bh * S + row0 + 8 * r] * LOG2E;
    dlt[r] = delta[(long long)bh * S + row0 + 8 * r];
  }
  const float scale_log2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const bf16* sQw = sQ + warp * 16 * LD;
  const bf16* sGw = sG + warp * 16 * LD;
  const int n_kv = (q0 + BM - 1) / BN + 1;  // K/V tiles up to the causal frontier

  for (int j = 0; j < n_kv; ++j) {
    // Tile j+1 streams into the other stage while tile j is computed.
    if (j + 1 < n_kv) {
      const int nxt = (j + 1) & 1;
      load_tile<BN, D, NT>(sK + nxt * BN * LD, kp + (long long)(j + 1) * BN * st.ks, st.ks, tid);
      load_tile<BN, D, NT>(sV + nxt * BN * LD, vp + (long long)(j + 1) * BN * st.vs, st.vs, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and Q, dO) have landed for every thread
    const bf16* cK = sK + (j & 1) * BN * LD;
    const bf16* cV = sV + (j & 1) * BN * LD;

    // S = Q K_j^T and dP = dO V_j^T for this warp's 16 rows.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      load_a<LD>(aq, sQw, kk, gr, t4);
      load_a<LD>(ag, sGw, kk, gr, t4);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        uint32_t bk[2], bv[2];
        load_bt<LD>(bk, cK, nt * 8, kk, gr, t4);
        load_bt<LD>(bv, cV, nt * 8, kk, gr, t4);
        mma_bf16(s[nt], aq, bk);
        mma_bf16(dp[nt], ag, bv);
      }
    }

    // dS = P (dP - delta) with P = exp(S * scale - lse), masked only where
    // the tile reaches past this warp's first row (the diagonal tile).
    const int k0 = j * BN;
    const bool masked = k0 + BN - 1 > wrow;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float p = (masked && col > row0 + 8 * r)
                            ? 0.f
                            : exp2f(s[nt][e] * scale_log2 - lse2[r]);
        s[nt][e] = p * (dp[nt][e] - dlt[r]);
      }
    }

    // dQ += dS K_j, dS rounded to bf16 in registers.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_a_x<D, LD>(acc, a, cK, kk * 16, lane);
    }
    __syncthreads();  // every warp is done with stage j&1 before it is refilled
  }

  bf16* op = dq + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + row * st.os + dt * 8 + t4 * 2) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

template <int D, int BN, int BQ>
__global__ void __launch_bounds__(BN / 16 * 32)
    flash_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, float scale,
                      BwdStrides st) {
  constexpr int NT = BN / 16 * 32;
  constexpr int LD = D + PAD;
  static_assert(BN % BQ == 0 && BQ % 16 == 0, "q tiles must divide the k/v tile");
  static_assert(BQ / 4 * 2 <= NT, "one thread per 16 bytes of lse and delta");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;  // two stages of BQ rows
  bf16* sG = sQ + 2 * BQ * LD;
  float* sL = reinterpret_cast<float*>(sG + 2 * BQ * LD);  // two stages of BQ
  float* sD = sL + 2 * BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;
  const int k_tile = blockIdx.x;  // the first k/v tiles see the most q tiles
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = k_tile * BN;

  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* gp = g + b * st.gb + h * st.gh;
  const float* lp = lse + (long long)bh * S;
  const float* dlp = delta + (long long)bh * S;

  // Q, dO, lse and delta of q tile i into stage `stage`.
  auto load_q_tile = [&](int i, int stage) {
    const long long r0 = (long long)i * BQ;
    load_tile<BQ, D, NT>(sQ + stage * BQ * LD, qp + r0 * st.qs, st.qs, tid);
    load_tile<BQ, D, NT>(sG + stage * BQ * LD, gp + r0 * st.gs, st.gs, tid);
    if (tid < BQ / 4) {
      cp_async16(sL + stage * BQ + tid * 4, lp + r0 + tid * 4);
    } else if (tid < BQ / 2) {
      cp_async16(sD + stage * BQ + (tid - BQ / 4) * 4, dlp + r0 + (tid - BQ / 4) * 4);
    }
  };

  load_tile<BN, D, NT>(sK, k + b * st.kb + h * st.kh + (long long)k0 * st.ks, st.ks, tid);
  load_tile<BN, D, NT>(sV, v + b * st.vb + h * st.vh + (long long)k0 * st.vs, st.vs, tid);
  const int i0 = k0 / BQ, n_q = S / BQ;  // q tiles i0.. see these keys
  load_q_tile(i0, 0);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  const int wkey = k0 + warp * 16;  // first key row of this warp
  const int key0 = wkey + gr;       // this thread's keys: key0 and key0 + 8
  const bf16* sKw = sK + warp * 16 * LD;
  const bf16* sVw = sV + warp * 16 * LD;
  const float scale_log2 = scale * LOG2E;

  for (int i = i0; i < n_q; ++i) {
    const int stage = (i - i0) & 1;
    if (i + 1 < n_q) {
      load_q_tile(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and K_j, V_j) have landed for every thread
    const bf16* cQ = sQ + stage * BQ * LD;
    const bf16* cG = sG + stage * BQ * LD;
    const float* cL = sL + stage * BQ;
    const float* cD = sD + stage * BQ;

    // S^T = K_j Q_i^T and dP^T = V_j dO_i^T for this warp's 16 keys.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a<LD>(ak, sKw, kk, gr, t4);
      load_a<LD>(av, sVw, kk, gr, t4);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t bq[2], bg[2];
        load_bt<LD>(bq, cQ, nt * 8, kk, gr, t4);
        load_bt<LD>(bg, cG, nt * 8, kk, gr, t4);
        mma_bf16(s[nt], ak, bq);
        mma_bf16(dp[nt], av, bg);
      }
    }

    // P^T and dS^T; masked only where some query of the tile precedes some
    // key of this warp (the tiles that straddle the diagonal).
    const int q0 = i * BQ;
    const bool masked = q0 < wkey + 15;
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + t4 * 2 + (e & 1);  // query within the tile
        const float p = (masked && q0 + c < key0 + 8 * (e >> 1))
                            ? 0.f
                            : exp2f(s[nt][e] * scale_log2 - cL[c] * LOG2E);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - cD[c]);
      }
    }

    // dV += P^T dO_i and dK += dS^T Q_i, P^T and dS^T rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_a_x<D, LD>(acc_v, a, cG, kk * 16, lane);
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
      mma_a_x<D, LD>(acc_k, a, cQ, kk * 16, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* kout = dk + b * st.ob + h * st.oh;
  bf16* vout = dv + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = (long long)(key0 + r * 8) * st.os + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(kout + off + dt * 8) =
          pack_bf16(acc_k[dt][2 * r] * scale, acc_k[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vout + off + dt * 8) =
          pack_bf16(acc_v[dt][2 * r], acc_v[dt][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g,
                      const void* lse, const void* delta, void* dq, int B, int H, int S,
                      float scale, const BwdStrides& st, cudaStream_t stream) {
  constexpr int BM = BWD_TILE, BN = BWD_TILE;
  constexpr int smem = (2 * BM + 4 * BN) * (D + PAD) * sizeof(bf16);
  auto kern = flash_dq_kernel<D, BM, BN>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(S / BM, B * H), BM / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, S, scale, st);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                        int S, float scale, const BwdStrides& st, cudaStream_t stream) {
  constexpr int BN = BWD_TILE, BQ = DKDV_BQ;
  constexpr int smem = (2 * BN + 4 * BQ) * (D + PAD) * sizeof(bf16) + 4 * BQ * sizeof(float);
  auto kern = flash_dkdv_kernel<D, BN, BQ>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(S / BN, B * H), BN / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S,
      scale, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g (= dO), dq: [B, H, S, D] bf16 views with the given element
// strides (batch, head, row; the head dimension is contiguous).  lse, delta:
// [B, H, S] f32, contiguous.  Returns a cudaError_t: cudaErrorInvalidValue
// for a shape the kernel does not take, else the launch's cudaGetLastError().
extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v, const void* g,
                             const void* lse, const void* delta, void* dq, int B, int H, int S,
                             int D, float scale, long long qb, long long qh, long long qs,
                             long long kb, long long kh, long long ks, long long vb,
                             long long vh, long long vs, long long gb, long long gh,
                             long long gs, long long ob, long long oh, long long os,
                             void* stream) {
  if (B < 1 || H < 1 || S < 1 || S % BWD_TILE != 0) return cudaErrorInvalidValue;
  const BwdStrides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_dq<128>(q, k, v, g, lse, delta, dq, B, H, S, scale, st, s);
  if (D == 64) return launch_dq<64>(q, k, v, g, lse, delta, dq, B, H, S, scale, st, s);
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
  if (B < 1 || H < 1 || S < 1 || S % BWD_TILE != 0) return cudaErrorInvalidValue;
  const BwdStrides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_dkdv<128>(q, k, v, g, lse, delta, dk, dv, B, H, S, scale, st, s);
  if (D == 64) return launch_dkdv<64>(q, k, v, g, lse, delta, dk, dv, B, H, S, scale, st, s);
  return cudaErrorInvalidValue;
}
