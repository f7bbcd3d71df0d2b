// Causal flash-attention forward for Hopper (sm_90a): bf16 q/k/v/out,
// f32 softmax state, f32 log-sum-exp.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py (called from `_flash_fwd` there).  It
// computes the same function: for each query row i,
//   s_ij = scale * q_i . k_j  (j <= i),  out_i = sum_j softmax(s_i)_j v_j,
//   lse_i = log sum_j exp(s_ij),
// with an online softmax (running max m, running sum l, accumulator acc,
// all f32), P cast to bf16 before the P.V product as the TPU kernel does,
// out = acc / l in bf16.
//
// Bound on an H100: at the main path's shape (B=2, H=16, S=4096, Dh=128)
// one launch does 4*B*H*Dh*S*(S+1)/2 = 1.37e11 tensor-core FLOP (0.139 ms
// at 989 TFLOP/s bf16) and moves 134.7 MB of q, k, v, out and lse
// (0.040 ms at 3.35 TB/s), so the kernel is bound by operations.  The
// design therefore keeps both products on the tensor cores (mma.sync
// m16n8k16 bf16 with f32 accumulation), keeps S and P in registers (they
// never reach device or shared memory), and walks K/V tiles only up to the
// causal frontier, which halves the work of the full S x S product.
//
// Layout of the work, unlike the TPU grid (which walks q blocks in order on
// one core and keeps whole K/V rows in VMEM):
//   * one thread block per (batch*head, BM-row q tile); BM/16 warps, each
//     owning 16 query rows; q tiles are issued longest-first so the causal
//     imbalance does not leave a tail of long blocks;
//   * K and V tiles of BN rows are staged in shared memory with cp.async:
//     V_j loads while S_j = Q K_j^T is computed, K_{j+1} while P_j V_j is;
//   * rows of shared memory are padded by 8 bf16 so the 32-bit fragment
//     loads and the ldmatrix.trans loads of V hit 32 distinct banks.
// wgmma, TMA and warp specialisation are not used yet.
//
// Inputs may be strided views (the model hands it slices of its fused qkv
// projection); the head dimension must be contiguous.

#include "flash_common.cuh"

namespace {

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D, int BM, int BN>
__global__ void __launch_bounds__(BM / 16 * 32)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int S, float scale_log2, Strides st) {
  constexpr int NT = BM / 16 * 32;
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LD;
  bf16* sV = sK + BN * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = q_tile * BM;

  const bf16* qp = q + b * st.qb + h * st.qh + (long long)q0 * st.qs;
  const bf16* kp = k + b * st.kb + h * st.kh;
  const bf16* vp = v + b * st.vb + h * st.vh;

  load_tile<BM, D, NT>(sQ, qp, st.qs, tid);
  load_tile<BN, D, NT>(sK, kp, st.ks, tid);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of s, log2 units
  float l[2] = {0.f, 0.f};                      // this thread's part of the running sum

  const int wrow = q0 + warp * 16;  // first query row of this warp
  const int row0 = wrow + g;        // this thread's rows: row0 and row0 + 8
  const bf16* sQw = sQ + warp * 16 * LD;
  const int n_kv = (q0 + BM - 1) / BN + 1;  // K/V tiles up to the causal frontier

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BN;
    cp_async_wait_all();
    __syncthreads();  // K_j (and Q) have landed; every warp is done with V_{j-1}
    load_tile<BN, D, NT>(sV, vp + (long long)k0 * st.vs, st.vs, tid);
    cp_async_commit();

    // S = Q K_j^T for this warp's 16 rows: BN/8 tiles of 16x8.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = sQw + g * LD + kk * 16 + t4 * 2;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                             ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const bf16* kb = sK + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        const uint32_t bb[2] = {ld_u32(kb), ld_u32(kb + 8)};
        mma_bf16(s[nt], a, bb);
      }
    }

    // Scale into log2 units; mask keys past the query where the tile
    // reaches beyond this warp's first row.
    const bool masked = k0 + BN - 1 > wrow;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e] * scale_log2;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        s[nt][e] = (masked && col > row) ? -CUDART_INF_F : x;
      }
    }

    // Online softmax.  Tile 0 always holds key 0, which every row sees, so
    // m is finite from the first tile on and no row yields exp(-inf + inf).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - mx);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - mx);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V_j has landed; every warp is done with K_j
    if (j + 1 < n_kv) {
      load_tile<BN, D, NT>(sK, kp + (long long)(k0 + BN) * st.ks, st.ks, tid);
      cp_async_commit();
    }

    // acc += P V_j.  The S accumulator layout of two neighbouring 16x8
    // tiles is the A-fragment layout of one 16x16 tile, so P never leaves
    // registers.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3;
      const bf16* vrow = sV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vrow + dt * 16);
        mma_bf16(acc[2 * dt], a, bb);
        mma_bf16(acc[2 * dt + 1], a, bb + 2);
      }
    }
  }

  bf16* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / lr;
    const int row = row0 + r * 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(op + row * st.os + dt * 8 + t4 * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t4 == 0) lse[(long long)bh * S + row] = (m[r] + log2f(lr)) * 0.6931471805599453f;
  }
}

template <int D, int BM, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int S, float scale_log2, const Strides& st, cudaStream_t stream) {
  constexpr int smem = (BM + 2 * BN) * (D + PAD) * sizeof(bf16);
  auto kern = flash_fwd_kernel<D, BM, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BM, B * H);
  kern<<<grid, BM / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, S, scale_log2, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, S, D] bf16 views with the given element strides
// (batch, head, row; the head dimension is contiguous).  lse: [B, H, S]
// f32, contiguous.  Returns a cudaError_t: cudaErrorInvalidValue for a
// shape the kernel does not take, else the launch's cudaGetLastError().
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int S, int D, int block_m, int block_n,
                              float scale, long long qb, long long qh, long long qs,
                              long long kb, long long kh, long long ks, long long vb,
                              long long vh, long long vs, long long ob, long long oh,
                              long long os, void* stream) {
  if (B < 1 || H < 1 || S < 1 || S % block_m != 0 || S % block_n != 0)
    return cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RTT_FLASH_CASE(d, bm, bn)                                                  \
  if (D == d && block_m == bm && block_n == bn)                                    \
    return launch<d, bm, bn>(q, k, v, o, lse, B, H, S, scale_log2, st, s);
  RTT_FLASH_CASE(128, 64, 64)
  RTT_FLASH_CASE(128, 64, 128)
  RTT_FLASH_CASE(128, 128, 64)
  RTT_FLASH_CASE(128, 128, 128)
  RTT_FLASH_CASE(64, 64, 64)
  RTT_FLASH_CASE(64, 64, 128)
  RTT_FLASH_CASE(64, 128, 64)
  RTT_FLASH_CASE(64, 128, 128)
#undef RTT_FLASH_CASE
  return cudaErrorInvalidValue;
}
