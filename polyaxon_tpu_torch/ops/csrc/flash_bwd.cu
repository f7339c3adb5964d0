// Flash attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in,
// f32 accumulate.
//
// Replaces: polyaxon_tpu/ops/flash.py `_bwd_dkdv_kernel` and
// `_bwd_dq_kernel` (both launched from `_flash_bwd_pallas`), the
// FlashAttention-2 split of the backward.
//
// What bounds it on the H100: per visible (q, key) pair the backward needs
// five head_dim-long products (S, dP, dV, dK, dQ), so at training shapes
// (S in the thousands) it does ~S/2 multiply-adds per byte it must read,
// far above the ~295 FLOP/byte ridge: the bf16 tensor-core rate
// (989 TFLOP/s dense) is the bound, not HBM. The two-kernel split does
// seven products per pair (S and dP are recomputed by the dQ kernel), the
// price of writing dQ, dK and dV once each with no atomics.
//
// What the design does about it: every product runs on the tensor cores
// through `mma.sync.m16n8k16` (mma_bf16.cuh); P and dS never leave
// registers (they are recomputed from the saved lse and become the A
// operand of the next product in place); tiles wholly outside the causal
// triangle or the sliding window are never loaded. This first version
// loads each tile synchronously (no cp.async / TMA pipeline, no wgmma) and
// reads B fragments with plain shared-memory loads; those are the levers
// of a later pass.
//
// dK/dV kernel: one block of 4 warps per (64-key tile, kv head, batch row);
// each warp owns 16 keys. The block keeps its K and V tiles in shared
// memory and loops over the n_rep query heads of its GQA group and over
// their visible q tiles, so dK and dV accumulate in f32 registers across
// the whole group and are written once (what the Pallas kernel's VMEM
// scratch does across its two inner grid axes). It computes the
// transposed products S^T = K Q^T and dP^T = V dO^T, keys as rows: P^T
// and dS^T then sit in the accumulator layout that is also the A layout
// of dV += P^T dO and dK += dS^T Q.
//
// dQ kernel: one block per (64-row q tile, q head, batch row), gridded
// like the forward, looping over the visible K/V tiles and accumulating
// dQ += dS K in f32 registers. Causal q tiles are issued last-first, so
// the longest rows start earliest.
//
// Semantics follow `_flash_bwd_xla` / the Pallas kernels exactly:
// p = exp(s * scale - lse) with the mask (`_block_mask`: causal rows >=
// cols with Sq == Sk, window rows - cols < window, segment equality)
// applied AFTER the exp, so a fully masked row (lse = -1e30) gives p = 0
// and zero gradients; ds = p * (dp - delta + dlse) * scale, where the
// caller passes dd = delta - dlse (delta = rowsum(dO * O), in f32). Any
// sequence length: tail keys >= Sk and tail rows >= Sq are masked and
// never written. head_dim 64, 128 and 256.
//
// head_dim 256 (gemma_2b): the f32 dK and dV accumulators of 16 keys x
// 256 dims would take 2 x 16 x 256 / 32 = 256 registers per thread, so
// both kernels split the head dim over two blocks (SPLIT = 2): each block
// owns one 128-wide half of dK/dV (or of dQ) and recomputes S and dP over
// the full 256 from its shared-memory tiles. That doubles the S/dP
// products (9 products per pair for dK/dV and 6 for dQ instead of 4 and
// 3 at the same accumulator cost as head_dim 128) and keeps the design
// as it is; the fused backward redesign removes the recompute. The dQ
// kernel then keeps its Q and dO tiles in shared memory instead of
// registers (64 A-fragment registers each at head_dim 256). Tiles above
// 48 KB live in dynamic shared memory.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BLOCK_M = 64;  // keys (dK/dV) or q rows (dQ) per block
constexpr int THREADS = 128;

// Visibility of element (q row, key): `_block_mask` plus the ragged tails.
__device__ __forceinline__ bool visible(int qrow, int key, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = qrow < Sq && key < Sk;
  if (causal) ok = ok && qrow >= key && (window <= 0 || qrow - key < window);
  return ok;
}

template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int rows,
                                          int limit, int tid) {
  constexpr int LDS = D + 8;  // padded smem row: no bank conflicts
  for (int i = tid; i < rows * D / 8; i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      x = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = x;
  }
}

template <int D, int BQ>  // head dim, q rows per streamed tile
constexpr size_t dkdv_smem_bytes() {
  return static_cast<size_t>(2 * BLOCK_M + 2 * BQ) * (D + 8) * sizeof(bf16) +
         static_cast<size_t>(BQ) * (2 * sizeof(float) + sizeof(int));
}

template <int D, int BQ, int SPLIT>  // head dim, q rows per tile, dK/dV split
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd,
                      const int* __restrict__ qseg,
                      const int* __restrict__ kseg, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      float scale, int causal, int window) {
  constexpr int KSTEPS = D / 16;  // k-steps of the products over head dim
  constexpr int NT_Q = BQ / 8;    // 8-column tiles of S^T (q columns)
  constexpr int DO = D / SPLIT;   // dK / dV columns this block owns
  constexpr int NT_D = DO / 8;    // 8-column tiles of dK / dV
  constexpr int LDS = D + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BLOCK_M * LDS;
  bf16* Qs = Vs + BLOCK_M * LDS;
  bf16* dOs = Qs + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDS);
  float* dd_s = lse_s + BQ;
  int* seg_s = reinterpret_cast<int*>(dd_s + BQ);

  const int k0 = blockIdx.x * BLOCK_M;
  const int kvh = blockIdx.y / SPLIT;
  const int c_out = (blockIdx.y % SPLIT) * DO;  // first owned column
  const int b = blockIdx.z;
  const int n_rep = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // this warp's first key row in the tile
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = static_cast<size_t>(b) * Sk * kv_stride +
                        static_cast<size_t>(kvh) * D;
  load_rows<D>(Ks, k + kv_off, kv_stride, k0, BLOCK_M, Sk, tid);
  load_rows<D>(Vs, v + kv_off, kv_stride, k0, BLOCK_M, Sk, tid);
  int ks[2] = {0, 0};
  if (kseg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key[r] < Sk) ks[r] = kseg[static_cast<size_t>(b) * Sk + key[r]];
  }

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  // q tiles that can see a key of this tile (`_block_visible`).
  const int n_qt = (Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window > 0) qt_end = min(n_qt, (k0 + BLOCK_M - 1 + window - 1) / BQ + 1);
  }

  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = kvh * n_rep + rep;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                         static_cast<size_t>(h) * D;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous q tile is fully consumed
      load_rows<D>(Qs, q + q_off, q_stride, q0, BQ, Sq, tid);
      load_rows<D>(dOs, dout + q_off, q_stride, q0, BQ, Sq, tid);
      for (int i = tid; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        lse_s[i] = in ? lse[row_off + q0 + i] : 0.f;
        dd_s[i] = in ? dd[row_off + q0 + i] : 0.f;
        seg_s[i] = (in && qseg != nullptr)
                       ? qseg[static_cast<size_t>(b) * Sq + q0 + i] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ q rows.
      float st[NT_Q][4], dpt[NT_Q][4];
#pragma unroll
      for (int n = 0; n < NT_Q; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        smem_a(ka, Ks, LDS, r0, kk * 16, g, t4);
        smem_a(va, Vs, LDS, r0, kk * 16, g, t4);
#pragma unroll
        for (int n = 0; n < NT_Q; ++n) {
          uint32_t bq[2], bo[2];
          smem_b_nk(bq, Qs, LDS, n * 8, kk * 16, g, t4);
          smem_b_nk(bo, dOs, LDS, n * 8, kk * 16, g, t4);
          mma_16816(st[n], ka, bq);
          mma_16816(dpt[n], va, bo);
        }
      }

      // P^T = exp(S^T * scale - lse), then masked (after the exp);
      // dS^T = P^T * (dP^T - dd) * scale.
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n * 8 + t4 * 2 + (i & 1);
          bool ok = visible(q0 + col, key[i >> 1], Sq, Sk, causal, window);
          if (qseg != nullptr && ok) ok = seg_s[col] == ks[i >> 1];
          const float p = ok ? expf(st[n][i] * scale - lse_s[col]) : 0.f;
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - dd_s[col]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over this tile's BQ q rows.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NT_D; ++n) {
          uint32_t bo[2], bq[2];
          smem_b_kn(bo, dOs, LDS, kk * 16, c_out + n * 8, g, t4);
          smem_b_kn(bq, Qs, LDS, kk * 16, c_out + n * 8, g, t4);
          mma_16816(dv_acc[n], pa, bo);
          mma_16816(dk_acc[n], sa, bq);
        }
      }
    }
  }

  // Every key row < Sk is written, zero where no q row sees it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const size_t off = kv_off + static_cast<size_t>(key[r]) * kv_stride +
                       c_out + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_f32(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_f32(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D, int BN, int SPLIT>
constexpr size_t dq_smem_bytes() {  // K/V tiles, and Q/dO tiles at D > 128
  return static_cast<size_t>(2 * BN + (D > 128 ? 2 * BLOCK_M : 0)) *
         (D + 8) * sizeof(bf16);
}

template <int D, int BN, int SPLIT>  // head dim, keys per K/V tile, dQ split
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, float scale, int causal,
                    int window) {
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BN / 8;      // 8-column tiles of S (keys)
  constexpr int DO = D / SPLIT;     // dQ columns this block owns
  constexpr int NT_D = DO / 8;      // 8-column tiles of dQ
  constexpr int LDS = D + 8;
  // Q and dO A fragments: in registers for the whole kv sweep, or (at
  // D > 128, where they would take 128 registers) read from shared memory.
  constexpr bool QSMEM = D > 128;
  constexpr int KREG = QSMEM ? 1 : KSTEPS;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LDS;
  bf16* Qs = Vs + BN * LDS;           // QSMEM only
  bf16* dOs = Qs + BLOCK_M * LDS;     // QSMEM only

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_M;
  const int h = blockIdx.y / SPLIT;
  const int c_out = (blockIdx.y % SPLIT) * DO;  // first owned column
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = static_cast<size_t>(b) * Sq * q_stride +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Sk * kv_stride +
                        static_cast<size_t>(kvh) * D;

  uint32_t qf[KREG][4], of[KREG][4];
  if constexpr (QSMEM) {
    // Visible to every warp after the first tile's __syncthreads below.
    load_rows<D>(Qs, q + q_off, q_stride, q0, BLOCK_M, Sq, tid);
    load_rows<D>(dOs, dout + q_off, q_stride, q0, BLOCK_M, Sq, tid);
  } else {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + t4 * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t ql = 0, qh = 0, ol = 0, oh = 0;
        if (row[r] < Sq) {
          const size_t off = q_off + static_cast<size_t>(row[r]) * q_stride +
                             c;
          ql = *reinterpret_cast<const uint32_t*>(q + off);
          qh = *reinterpret_cast<const uint32_t*>(q + off + 8);
          ol = *reinterpret_cast<const uint32_t*>(dout + off);
          oh = *reinterpret_cast<const uint32_t*>(dout + off + 8);
        }
        qf[kk][r] = ql;
        qf[kk][r + 2] = qh;
        of[kk][r] = ol;
        of[kk][r + 2] = oh;
      }
    }
  }
  float lse_r[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
  int qs[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    const size_t i = (static_cast<size_t>(b) * H + h) * Sq + row[r];
    lse_r[r] = lse[i];
    dd_r[r] = dd[i];
    if (qseg != nullptr) qs[r] = qseg[static_cast<size_t>(b) * Sq + row[r]];
  }

  float dq_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  // K/V tiles that can hold a visible column (`_block_visible`).
  int kt_begin = 0;
  int kt_end = (Sk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(q0 + BLOCK_M, Sq) - 1;
    kt_end = min(kt_end, last_row / BN + 1);
    if (window > 0) {
      const int lo = q0 - (window - 1);
      if (lo > 0) kt_begin = lo / BN;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile is fully consumed
    load_rows<D>(Ks, k + kv_off, kv_stride, k0, BN, Sk, tid);
    load_rows<D>(Vs, v + kv_off, kv_stride, k0, BN, Sk, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BN keys, over
    // the full head dim.
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      if constexpr (QSMEM) {
        smem_a(qa, Qs, LDS, warp * 16, kk * 16, g, t4);
        smem_a(oa, dOs, LDS, warp * 16, kk * 16, g, t4);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kk][i];
          oa[i] = of[kk][i];
        }
      }
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        uint32_t bk[2], bv[2];
        smem_b_nk(bk, Ks, LDS, n * 8, kk * 16, g, t4);
        smem_b_nk(bv, Vs, LDS, n * 8, kk * 16, g, t4);
        mma_16816(s[n], qa, bk);
        mma_16816(dp[n], oa, bv);
      }
    }

    // P masked after the exp; dS = P * (dP - dd) * scale (into dp).
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int c = k0 + n * 8 + t4 * 2 + (i & 1);
        bool ok = visible(row[r], c, Sq, Sk, causal, window);
        if (qseg != nullptr && ok)
          ok = qs[r] == kseg[static_cast<size_t>(b) * Sk + c];
        const float p = ok ? expf(s[n][i] * scale - lse_r[r]) : 0.f;
        dp[n][i] = p * (dp[n][i] - dd_r[r]) * scale;
      }
    }

    // dQ += dS K over this block's columns of K.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        uint32_t bk[2];
        smem_b_kn(bk, Ks, LDS, kk * 16, c_out + n * 8, g, t4);
        mma_16816(dq_acc[n], a, bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    bf16* out = dq + q_off + static_cast<size_t>(row[r]) * q_stride +
                c_out + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8) =
          pack_f32(dq_acc[n][2 * r], dq_acc[n][2 * r + 1]);
  }
}

#define BWD_PTRS                                                          \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),        \
      static_cast<const float*>(lse), static_cast<const float*>(dd),      \
      static_cast<const int*>(qseg), static_cast<const int*>(kseg)

template <int D, int BQ, int SPLIT>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dd,
                const void* qseg, const void* kseg, void* dk, void* dv,
                int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                int window, cudaStream_t st) {
  constexpr size_t smem = dkdv_smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, BQ, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BLOCK_M - 1) / BLOCK_M, KV * SPLIT, B);
  flash_bwd_dkdv_kernel<D, BQ, SPLIT><<<grid, THREADS, smem, st>>>(
      BWD_PTRS, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
      KV, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BN, int SPLIT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, const void* qseg,
              const void* kseg, void* dq, int B, int Sq, int Sk, int H,
              int KV, float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D, BN, SPLIT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BN, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H * SPLIT, B);
  flash_bwd_dq_kernel<D, BN, SPLIT><<<grid, THREADS, smem, st>>>(
      BWD_PTRS, static_cast<bf16*>(dq), Sq, Sk, H, KV, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, dout [B, Sq, H, D], k/v [B, Sk, KV, D] bf16 contiguous; lse and
// dd = delta - dlse [B, H, Sq] f32; qseg [B, Sq] and kseg [B, Sk] int32 or
// both null; dk/dv [B, Sk, KV, D] bf16. D in {64, 128, 256}; window <= 0
// means unbounded. Returns cudaGetLastError() after launch
// (cudaErrorInvalidValue for another D).
int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        const void* qseg, const void* kseg, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int KV,
                        int D, float scale, int causal, int window,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkdv<64, 64, 1>(q, k, v, dout, lse, dd, qseg, kseg, dk, dv,
                                  B, Sq, Sk, H, KV, scale, causal, window, st);
  if (D == 128)
    return launch_dkdv<128, 32, 1>(q, k, v, dout, lse, dd, qseg, kseg, dk,
                                   dv, B, Sq, Sk, H, KV, scale, causal,
                                   window, st);
  if (D == 256)
    return launch_dkdv<256, 32, 2>(q, k, v, dout, lse, dd, qseg, kseg, dk,
                                   dv, B, Sq, Sk, H, KV, scale, causal,
                                   window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same inputs; dq [B, Sq, H, D] bf16.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      const void* qseg, const void* kseg, void* dq, int B,
                      int Sq, int Sk, int H, int KV, int D, float scale,
                      int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64, 64, 1>(q, k, v, dout, lse, dd, qseg, kseg, dq, B,
                                Sq, Sk, H, KV, scale, causal, window, st);
  if (D == 128)
    return launch_dq<128, 32, 1>(q, k, v, dout, lse, dd, qseg, kseg, dq, B,
                                 Sq, Sk, H, KV, scale, causal, window, st);
  if (D == 256)
    return launch_dq<256, 32, 2>(q, k, v, dout, lse, dd, qseg, kseg, dq, B,
                                 Sq, Sk, H, KV, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
