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
// price of writing dQ, dK and dV once each with no atomics, so all three
// are deterministic.
//
// What the design does about it: both kernels have the forward's shape
// (flash_fwd.cu, helpers and operand layouts in sm90_bf16.cuh). One
// producer thread loads the block's resident tiles once and streams the
// others by TMA through a two-stage ring with full/empty `mbarrier`s;
// two consumer warpgroups (`setmaxnreg` 240; the producer's 24) run every
// product on `wgmma`:
// - dK/dV kernel. A block owns 128 keys of one kv head (64 per consumer
//   warpgroup) and keeps K and V in shared memory; it streams the q and
//   dO tiles of its GQA group's heads. S^T = K Q^T and dP^T = V dO^T take
//   both operands from shared memory, K-major (the forward's S layout);
//   P^T and dS^T are then, in registers, the A operand of dV += P^T dO and
//   dK += dS^T Q, with dO and Q the MN-major B operand (the forward's V in
//   P V). The same swizzled Q and dO tiles serve both descriptor orders.
// - dQ kernel. A block owns 128 q rows of one head (64 per warpgroup),
//   keeps Q and dO, and streams K/V tiles: S = Q K^T and dP = dO V^T from
//   shared memory, dQ += dS K with dS from registers and K MN-major.
//   Causal q tiles are issued longest first.
// - The elementwise work (an exp, the mask, dS and two bf16 packs per
//   element) costs about as much as the products at head_dim 64. The two
//   warpgroups take turns issuing their products (named barriers), so
//   one's elementwise work runs under the other's products, and each tile
//   runs one of three specialised elementwise loops: unmasked, masked
//   (the causal diagonal, the window band, the tails: two compares against
//   per-row bounds), or masked with packed segments. P = exp2(s * scale *
//   log2 e - lse * log2 e) is one FMA and one `ex2.approx`, and the scale
//   of dS is applied to dK and dQ once, at the end.
// - Per-row data in shared memory: in S^T each column is a q row, so the
//   q tile's lse, dd and q segment ids are copied per tile by the consumer
//   threads with `cp.async` while the S^T product runs (the producer only
//   issues TMA). Key segment ids are staged once per block (dK/dV, in
//   registers) or per K/V tile (dQ, in shared memory), never read per
//   element.
// - The grid fills the card. dK/dV blocks are issued key tile by key tile
//   (the tile that the most causal q tiles see first). Where one block
//   per (key tile, kv head, batch row) would leave fewer than two blocks
//   per SM (gemma_2b: MQA, one batch row), the group's q heads are split
//   across blocks (`flash_bwd_dkdv_split`): each block writes its f32
//   partial dK/dV, and `sum_partials_kernel` adds the partials in a fixed
//   order, so the result stays deterministic. Otherwise a block loops
//   over its whole group, and dK/dV are written once in bf16.
//
// head_dim 256 (gemma_2b): f32 dK and dV for 64 keys x 256 columns would
// take 256 registers a thread, and K, V plus two stages of Q/dO over 128
// keys would not fit shared memory. So at head_dim 256 a block owns 64
// keys (or 64 q rows) and its two consumer warpgroups split the output's
// columns, 128 each: both compute S^T and dP^T (S and dP) over the full
// head dim from the same shared tiles, which is 6 products per pair for
// dK/dV and 5 for dQ instead of 4 and 3. Tiles (`BwdCfg`): dK/dV streams
// 128 q rows at head_dim 64 and 64 at 128 and 256; dQ streams 128 keys at
// head_dim 64 and 64 at 128 and 256; shared memory 103, 132 and 196 KB
// (dK/dV) and 99, 130 and 194 KB (dQ).
//
// Semantics follow `_flash_bwd_xla` / the Pallas kernels exactly:
// p = exp(s * scale - lse) with the mask (`_block_mask`: causal rows >=
// cols with Sq == Sk, window rows - cols < window, segment equality)
// applied AFTER the exp, so a fully masked row (lse = -1e30) gives p = 0
// and zero gradients; ds = p * (dp - delta + dlse) * scale, where the
// caller passes dd = delta - dlse (delta = rowsum(dO * O), in f32). Any
// sequence length: TMA zero-fills tail rows and keys, which are masked
// and never written. head_dim 64, 128 and 256; any GQA ratio.

#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sm90_bf16.cuh"

namespace {

constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;     // ring depth of the streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

// Tiles per head dim. DSPLIT: 1 = each consumer warpgroup owns 64 rows
// of the block's 128; 2 = both share the block's 64 rows and each owns
// half of the output's columns. BQ: q rows per streamed tile of the dK/dV
// kernel; BN: keys per streamed tile of the dQ kernel. Each choice keeps
// a consumer thread's accumulators (dK and dV, or dQ, plus S and dP) at
// 192 of its 240 registers or fewer, with no spills.
template <int D>
struct BwdCfg;
template <>
struct BwdCfg<64> {
  static constexpr int DSPLIT = 1, BQ = 128, BN = 128;
};
template <>
struct BwdCfg<128> {
  static constexpr int DSPLIT = 1, BQ = 64, BN = 64;
};
template <>
struct BwdCfg<256> {
  static constexpr int DSPLIT = 2, BQ = 64, BN = 64;
};

// Rows a block owns: keys (dK/dV) or q rows (dQ).
template <int D>
constexpr int block_rows() {
  return 128 / BwdCfg<D>::DSPLIT;
}

// Shared memory of the dK/dV kernel, from a 1024-byte aligned base: K and
// V (resident), STAGES x (Q, dO), each consumer warpgroup's two buffers of
// per-row data (lse * log2 e, dd, q segment id; BQ each), barriers.
template <int D>
struct DkdvSmem {
  static constexpr int ROWS = block_rows<D>();
  static constexpr int BQ = BwdCfg<D>::BQ;
  static constexpr uint32_t KV_BYTES = ROWS * D * 2;  // K or V
  static constexpr uint32_t Q_BYTES = BQ * D * 2;     // Q or dO, one stage
  static constexpr uint32_t STAGE_OFF = 2 * KV_BYTES;
  static constexpr uint32_t ROW_OFF = STAGE_OFF + STAGES * 2 * Q_BYTES;
  static constexpr uint32_t BAR_OFF = ROW_OFF + CONSUMERS * 2 * 3 * BQ * 4;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

// Shared memory of the dQ kernel: Q and dO (resident), STAGES x (K, V),
// each consumer warpgroup's two buffers of key segment ids, barriers.
template <int D>
struct DqSmem {
  static constexpr int ROWS = block_rows<D>();
  static constexpr int BN = BwdCfg<D>::BN;
  static constexpr uint32_t Q_BYTES = ROWS * D * 2;  // Q or dO
  static constexpr uint32_t KV_BYTES = BN * D * 2;   // K or V, one stage
  static constexpr uint32_t STAGE_OFF = 2 * Q_BYTES;
  static constexpr uint32_t SEG_OFF = STAGE_OFF + STAGES * 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = SEG_OFF + CONSUMERS * 2 * BN * 4;
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd,
                      const int* __restrict__ qseg,
                      const int* __restrict__ kseg, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int B, int Sq, int Sk,
                      int H, int KV, int n_split, float scale, int causal,
                      int window) {
  using L = DkdvSmem<D>;
  constexpr int ROWS = L::ROWS;
  constexpr int BQ = L::BQ;
  constexpr int DSPLIT = BwdCfg<D>::DSPLIT;
  constexpr int DO = D / DSPLIT;  // dK / dV columns a warpgroup owns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::KV_BYTES;
  auto q_tile = [&](int s) { return base + L::STAGE_OFF + s * 2 * L::Q_BYTES; };
  auto do_tile = [&](int s) { return q_tile(s) + L::Q_BYTES; };
  const uint32_t bar = base + L::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t kv_bar = bar + 8 * 2 * STAGES;

  const int n_rep = H / KV;
  const int kvh = blockIdx.x / n_split;
  const int reps = n_rep / n_split;  // this block's q heads of the group
  const int rep0 = (blockIdx.x % n_split) * reps;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * ROWS;
  const bool packed = qseg != nullptr;  // then kseg is [B, Sk] too

  // q tiles that can see a key of this block (`_block_visible`).
  const int n_qt = (Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window > 0)
      qt_end = min(n_qt, (k0 + ROWS - 1 + window - 1) / BQ + 1);
  }
  // The block's (q head, q tile) steps, head-major.
  const int n_q = qt_end - qt_begin;
  const int n_it = reps * n_q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV_BYTES);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(k_s + p * ROWS * 128, &tk, kv_bar, p * 64, kvh, k0, b);
        tma_load_4d(v_s + p * ROWS * 128, &tv, kv_bar, p * 64, kvh, k0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int h = kvh * n_rep + rep0 + it / n_q;
        const int q0 = (qt_begin + it % n_q) * BQ;
        mbar_wait(empty(stage), phase ^ 1);  // a fresh barrier passes
        mbar_expect_tx(full(stage), 2 * L::Q_BYTES);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(q_tile(stage) + p * BQ * 128, &tq, full(stage), p * 64,
                      h, q0, b);
          tma_load_4d(do_tile(stage) + p * BQ * 128, &tdo, full(stage),
                      p * 64, h, q0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128;
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    // This warpgroup's 64 keys (rows of S^T) and dK/dV columns.
    const int kw_off = DSPLIT == 1 ? wg * 64 : 0;
    const int kw0 = k0 + kw_off;
    const int c_out = DSPLIT == 1 ? 0 : wg * DO;
    const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    int ks[2] = {0, 0};
    if (packed) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key[r] < Sk) ks[r] = kseg[static_cast<size_t>(b) * Sk + key[r]];
    }
    // Two buffers of [lse, dd, q segment] x BQ for this group (shared
    // addresses), alternating by the tiles it computes.
    const uint32_t rows_s = base + L::ROW_OFF + wg * 2 * 3 * BQ * 4;

    float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    const float sl2 = scale * LOG2E;
    const uint32_t k_wg = k_s + kw_off * 128;
    const uint32_t v_wg = v_s + kw_off * 128;
    // The two warpgroups take turns issuing their products (named
    // barriers 3 and 4; warpgroup 0 first), so that one's exps and masks
    // run under the other's products.
    auto my_turn = [&]() {
      bar_sync_of<3, 4, 256>(wg == 1);
    };
    auto your_turn = [&]() {
      bar_arrive_of<4, 3, 256>(wg == 1);
    };
    if (wg == 1) your_turn();
    mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int stage = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const int h = kvh * n_rep + rep0 + it / n_q;
      const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
      const int q0 = (qt_begin + it % n_q) * BQ;
      // No key of this warpgroup visible to any row of the tile.
      const bool none =
          causal && (q0 + BQ - 1 < kw0 ||
                     (window > 0 && q0 - (kw0 + 63) >= window));
      // The tile's lse, dd and q segment ids, copied by thread i < BQ
      // for row q0 + i while the S^T product runs.
      const uint32_t lse_s = rows_s + (it & 1) * 3 * BQ * 4;
      const uint32_t dd_s = lse_s + BQ * 4, qs_s = dd_s + BQ * 4;
      if (!none && wtid < BQ) {
        const bool in = q0 + wtid < Sq;
        const int q = in ? q0 + wtid : 0;
        cp_async_4(lse_s + wtid * 4, lse + row_off + q, in);
        cp_async_4(dd_s + wtid * 4, dd + row_off + q, in);
        if (packed)
          cp_async_4(qs_s + wtid * 4,
                     qseg + static_cast<size_t>(b) * Sq + q, in);
      }
      mbar_wait(full(stage), phase);
      if (!none) {
        float st[BQ / 2], dpt[BQ / 2];
        my_turn();
        wgmma_fence();
        issue_ss<BQ, D>(st, opaque(k_wg), ROWS, opaque(q_tile(stage)));
        issue_ss<BQ, D>(dpt, opaque(v_wg), ROWS, opaque(do_tile(stage)));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs<BQ / 2>(st);
        fence_regs<BQ / 2>(dpt);
        cp_async_wait_all();
        bar_sync_of<1, 2, 128>(wg == 1);

        // P^T = exp(S^T * scale - lse), masked after the exp; dS^T =
        // P^T (dP^T - dd) (the scale is applied to dK at the end); both
        // to bf16 A fragments, 16 q rows (two column tiles) at a time.
        // On a masked tile, key row r sees the columns c with lo[r] <=
        // c - 2 t4 < hi[r] (causal, window, the q tail) of its segment;
        // keys past Sk are never written.
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
        auto tile = [&](auto masked_c, auto packed_c) {
          constexpr bool MASKED = decltype(masked_c)::value;
          constexpr bool PACKED = decltype(packed_c)::value;
          int lo[2] = {0, 0}, hi[2] = {0, 0};
          if constexpr (MASKED) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              int from = -(1 << 30), to = Sq - q0;
              if (causal) {
                from = key[r] - q0;
                if (window > 0) to = min(to, key[r] - q0 + window);
              }
              lo[r] = from - t4 * 2;
              hi[r] = to - t4 * 2;
            }
          }
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * kk + jj;
              const int c0 = j * 8 + t4 * 2;  // columns c0, c0 + 1
              const float2 lse_c = lds_f2(lse_s + c0 * 4);
              const float nl2[2] = {-lse_c.x * LOG2E, -lse_c.y * LOG2E};
              const float2 ddc = lds_f2(dd_s + c0 * 4);
              int2 qsc = {0, 0};
              if constexpr (PACKED) qsc = lds_s2(qs_s + c0 * 4);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int i = 4 * j + 2 * r + e;
                  float p = fast_exp2(fmaf(st[i], sl2, nl2[e]));
                  if constexpr (MASKED) {
                    bool ok = j * 8 + e >= lo[r] && j * 8 + e < hi[r];
                    if constexpr (PACKED)
                      ok = ok && (e ? qsc.y : qsc.x) == ks[r];
                    p = ok ? p : 0.f;
                  }
                  st[i] = p;
                  dpt[i] = p * (dpt[i] - (e ? ddc.y : ddc.x));
                }
              }
            }
            acc_to_a(pa[kk], st + 8 * kk);
            acc_to_a(sa[kk], dpt + 8 * kk);
          }
        };
        if (packed)
          tile(std::true_type{}, std::true_type{});
        else if (q0 + BQ > Sq ||
                 (causal &&
                  (q0 < kw0 + 63 ||
                   (window > 0 && q0 + BQ - 1 - kw0 >= window))))
          tile(std::true_type{}, std::false_type{});
        else
          tile(std::false_type{}, std::false_type{});

        // dV += P^T dO and dK += dS^T Q over the tile's BQ q rows.
        my_turn();
        wgmma_fence();
        issue_rs<DO, BQ>(dv_acc, pa, opaque(do_tile(stage)), c_out);
        issue_rs<DO, BQ>(dk_acc, sa, opaque(q_tile(stage)), c_out);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs<DO / 2>(dv_acc);
        fence_regs<DO / 2>(dk_acc);
        fence_regs<BQ / 4>(&pa[0][0]);
        fence_regs<BQ / 4>(&sa[0][0]);
      } else {
        my_turn();  // keep the turns in step with the other warpgroup
        your_turn();
        // Every thread is past the previous step's reads of the row
        // buffer the next step overwrites.
        bar_sync_of<1, 2, 128>(wg == 1);
        my_turn();
        your_turn();
      }
      mbar_arrive(empty(stage));
    }

    if (wg == 0) my_turn();  // the turn warpgroup 1 passed last
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) dk_acc[i] *= scale;

    // Every key row < Sk is written, zero where no q row sees it: bf16
    // dK/dV, or this block's f32 partial [split][B, Sk, KV, D].
    const size_t kv_stride = static_cast<size_t>(KV) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= Sk) continue;
      const size_t off = (static_cast<size_t>(b) * Sk + key[r]) * kv_stride +
                         static_cast<size_t>(kvh) * D + c_out + t4 * 2;
      if (dk_part != nullptr) {
        const size_t part = static_cast<size_t>(blockIdx.x % n_split) * B *
                                Sk * kv_stride + off;
#pragma unroll
        for (int j = 0; j < DO / 8; ++j) {
          *reinterpret_cast<float2*>(dk_part + part + j * 8) =
              make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_part + part + j * 8) =
              make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < DO / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
              pack_f32(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
              pack_f32(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// dk, dv = the sum of the n_split f32 partials (in order 0, 1, ...), in
// bf16; n4 = B * Sk * KV * D / 4, four elements a thread.
__global__ void sum_partials_kernel(const float* __restrict__ dk_part,
                                    const float* __restrict__ dv_part,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, size_t n4,
                                    int n_split) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* pk = reinterpret_cast<const float4*>(dk_part);
  const float4* pv = reinterpret_cast<const float4*>(dv_part);
  float4 a = pk[i], c = pv[i];
  for (int s = 1; s < n_split; ++s) {
    const float4 x = pk[s * n4 + i], y = pv[s * n4 + i];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
    c.x += y.x;
    c.y += y.y;
    c.z += y.z;
    c.w += y.w;
  }
  reinterpret_cast<uint2*>(dk)[i] =
      make_uint2(pack_f32(a.x, a.y), pack_f32(a.z, a.w));
  reinterpret_cast<uint2*>(dv)[i] =
      make_uint2(pack_f32(c.x, c.y), pack_f32(c.z, c.w));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dd,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, float scale, int causal,
                    int window) {
  using L = DqSmem<D>;
  constexpr int ROWS = L::ROWS;
  constexpr int BN = L::BN;
  constexpr int DSPLIT = BwdCfg<D>::DSPLIT;
  constexpr int DO = D / DSPLIT;  // dQ columns a warpgroup owns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base, do_s = base + L::Q_BYTES;
  auto k_tile = [&](int s) { return base + L::STAGE_OFF + s * 2 * L::KV_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::KV_BYTES; };
  const uint32_t bar = base + L::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t q_bar = bar + 8 * 2 * STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * ROWS;
  const int kvh = h / (H / KV);
  const bool packed = qseg != nullptr;

  // K/V tiles that can hold a visible column (`_block_visible`).
  int kt_begin = 0;
  int kt_end = (Sk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(q0 + ROWS, Sq) - 1;
    kt_end = min(kt_end, last_row / BN + 1);
    if (window > 0) {
      const int lo = q0 - (window - 1);
      if (lo > 0) kt_begin = lo / BN;
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * L::Q_BYTES);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(q_s + p * ROWS * 128, &tq, q_bar, p * 64, h, q0, b);
        tma_load_4d(do_s + p * ROWS * 128, &tdo, q_bar, p * 64, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);  // a fresh barrier passes
        mbar_expect_tx(full(stage), 2 * L::KV_BYTES);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(k_tile(stage) + p * BN * 128, &tk, full(stage), p * 64,
                      kvh, kt * BN, b);
          tma_load_4d(v_tile(stage) + p * BN * 128, &tv, full(stage), p * 64,
                      kvh, kt * BN, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int wg = tid / 128;
    const int wtid = tid % 128;
    const int warp = wtid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    // This warpgroup's 64 q rows and dQ columns.
    const int wq_off = DSPLIT == 1 ? wg * 64 : 0;
    const int wg_row0 = q0 + wq_off;
    const int c_out = DSPLIT == 1 ? 0 : wg * DO;
    const int row[2] = {wg_row0 + warp * 16 + g, wg_row0 + warp * 16 + g + 8};
    float l2[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
    int qs[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
      const size_t i = (static_cast<size_t>(b) * H + h) * Sq + row[r];
      l2[r] = lse[i] * LOG2E;
      dd_r[r] = dd[i];
      if (packed) qs[r] = qseg[static_cast<size_t>(b) * Sq + row[r]];
    }
    // This warpgroup's two buffers of key segment ids, alternating by the
    // tiles it computes.
    int* kseg_w = reinterpret_cast<int*>(base_ptr + L::SEG_OFF) + wg * 2 * BN;
    const int* kseg_b =
        packed ? kseg + static_cast<size_t>(b) * Sk : nullptr;

    float dq_acc[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) dq_acc[i] = 0.f;

    const float sl2 = scale * LOG2E;
    const uint32_t q_wg = q_s + wq_off * 128;
    const uint32_t do_wg = do_s + wq_off * 128;
    // Turns as in the dK/dV kernel.
    auto my_turn = [&]() {
      bar_sync_of<3, 4, 256>(wg == 1);
    };
    auto your_turn = [&]() {
      bar_arrive_of<4, 3, 256>(wg == 1);
    };
    if (wg == 1) your_turn();
    mbar_wait(q_bar, 0);

    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * BN;
      const int stage = (kt - kt_begin) % STAGES;
      const uint32_t phase = ((kt - kt_begin) / STAGES) & 1;
      // Every row of this warpgroup masked out of the whole tile.
      const bool none = causal && (k0 > wg_row0 + 63 ||
                                   (window > 0 &&
                                    wg_row0 - (k0 + BN - 1) >= window));
      int my_seg = 0;  // in flight during the S product
      if (packed && !none && wtid < BN && k0 + wtid < Sk)
        my_seg = kseg_b[k0 + wtid];
      mbar_wait(full(stage), phase);
      if (!none) {
        int* ksg = kseg_w + (kt & 1) * BN;
        float s[BN / 2], dp[BN / 2];
        my_turn();
        wgmma_fence();
        issue_ss<BN, D>(s, q_wg, ROWS, k_tile(stage));
        issue_ss<BN, D>(dp, do_wg, ROWS, v_tile(stage));
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs<BN / 2>(s);
        fence_regs<BN / 2>(dp);
        if (packed) {
          if (wtid < BN) ksg[wtid] = my_seg;
          bar_sync_of<1, 2, 128>(wg == 1);
        }

        // dS = P (dP - dd), P masked after the exp (the scale is applied
        // to dQ at the end); to bf16 A fragments, 16 keys at a time. On a
        // masked tile, row r sees the keys k0 + c with lo[r] <= c - 2 t4 <
        // hi[r] (causal, window, the key tail) of its segment; rows past Sq
        // are never written.
        uint32_t sa[BN / 16][4];
        auto tile = [&](auto masked_c, auto packed_c) {
          constexpr bool MASKED = decltype(masked_c)::value;
          constexpr bool PACKED = decltype(packed_c)::value;
          int lo[2] = {0, 0}, hi[2] = {0, 0};
          if constexpr (MASKED) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              int from = -(1 << 30), to = Sk - k0;
              if (causal) {
                to = min(to, row[r] - k0 + 1);
                if (window > 0) from = row[r] - k0 - window + 1;
              }
              lo[r] = from - t4 * 2;
              hi[r] = to - t4 * 2;
            }
          }
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * kk + jj;
              int2 ksc = {0, 0};  // keys k0 + j * 8 + 2 t4 + {0, 1}
              if constexpr (PACKED)
                ksc = *reinterpret_cast<const int2*>(ksg + j * 8 + t4 * 2);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int i = 4 * j + 2 * r + e;
                  float p = fast_exp2(fmaf(s[i], sl2, -l2[r]));
                  if constexpr (MASKED) {
                    bool ok = j * 8 + e >= lo[r] && j * 8 + e < hi[r];
                    if constexpr (PACKED)
                      ok = ok && qs[r] == (e ? ksc.y : ksc.x);
                    p = ok ? p : 0.f;
                  }
                  dp[i] = p * (dp[i] - dd_r[r]);
                }
              }
            }
            acc_to_a(sa[kk], dp + 8 * kk);
          }
        };
        if (packed)
          tile(std::true_type{}, std::true_type{});
        else if (k0 + BN > Sk ||
                 (causal && (k0 + BN - 1 > wg_row0 ||
                             (window > 0 && wg_row0 + 63 - k0 >= window))))
          tile(std::true_type{}, std::false_type{});
        else
          tile(std::false_type{}, std::false_type{});

        // dQ += dS K over the tile's BN keys.
        my_turn();
        wgmma_fence();
        issue_rs<DO, BN>(dq_acc, sa, k_tile(stage), c_out);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs<DO / 2>(dq_acc);
        fence_regs<BN / 4>(&sa[0][0]);
      } else {
        my_turn();  // keep the turns in step with the other warpgroup
        your_turn();
        // Every thread is past the previous tile's reads of the segment
        // buffer the next tile overwrites.
        if (packed) bar_sync_of<1, 2, 128>(wg == 1);
        my_turn();
        your_turn();
      }
      mbar_arrive(empty(stage));
    }

    if (wg == 0) my_turn();  // the turn warpgroup 1 passed last
    const size_t q_stride = static_cast<size_t>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
      bf16* out = dq + (static_cast<size_t>(b) * Sq + row[r]) * q_stride +
                  static_cast<size_t>(h) * D + c_out + t4 * 2;
#pragma unroll
      for (int j = 0; j < DO / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack_f32(dq_acc[4 * j + 2 * r] * scale,
                     dq_acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// Tensor maps of one call: q and dO over H heads, k and v over KV, with
// boxes of `q_rows` and `kv_rows` rows.
bool bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
              const void* dout, int D, int B, int Sq, int Sk, int H, int KV,
              int q_rows, int kv_rows) {
  const EncodeTiled enc = encode_tiled();
  return enc != nullptr && make_map(&m[0], enc, q, D, H, Sq, B, q_rows) &&
         make_map(&m[1], enc, k, D, KV, Sk, B, kv_rows) &&
         make_map(&m[2], enc, v, D, KV, Sk, B, kv_rows) &&
         make_map(&m[3], enc, dout, D, H, Sq, B, q_rows);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  *configured = err == cudaSuccess;
  return err;
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dd,
                const void* qseg, const void* kseg, float* dk_part,
                float* dv_part, void* dk, void* dv, int B, int Sq, int Sk,
                int H, int KV, int n_split, float scale, int causal,
                int window, cudaStream_t st) {
  constexpr size_t smem = DkdvSmem<D>::BYTES;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, D, B, Sq, Sk, H, KV, BwdCfg<D>::BQ,
                block_rows<D>()))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KV * n_split, B,
                  (Sk + block_rows<D>() - 1) / block_rows<D>());
  flash_bwd_dkdv_kernel<D><<<grid, THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dk_part, dv_part, B, Sq, Sk, H, KV, n_split,
      scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || dk_part == nullptr) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(B) * Sk * KV * D / 4;
  const unsigned sum_blocks = static_cast<unsigned>((n4 + 255) / 256);
  sum_partials_kernel<<<sum_blocks, 256, 0, st>>>(
      dk_part, dv_part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dd, const void* qseg,
              const void* kseg, void* dq, int B, int Sq, int Sk, int H,
              int KV, float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = DqSmem<D>::BYTES;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, &configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, D, B, Sq, Sk, H, KV, block_rows<D>(),
                BwdCfg<D>::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B, (Sq + block_rows<D>() - 1) / block_rows<D>());
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, st>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<bf16*>(dq), Sq, Sk, H, KV,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int rows_for(int D) {
  return D == 64 ? block_rows<64>() : D == 128 ? block_rows<128>()
                                               : block_rows<256>();
}

}  // namespace

extern "C" {

// How many blocks share each GQA group's q heads in the dK/dV kernel: 1
// (a block loops over its whole group) unless that grid would give fewer
// than two blocks per SM; then the smallest divisor of H / KV that
// reaches two (or H / KV itself). Above 1, call flash_bwd_dkdv_split_bf16.
int flash_bwd_dkdv_split(int B, int Sk, int H, int KV, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int rows = rows_for(D);
  const long blocks = static_cast<long>((Sk + rows - 1) / rows) * KV * B;
  const int n_rep = H / KV;
  for (int n = 1; n < n_rep; ++n)
    if (n_rep % n == 0 && blocks * n >= 2L * sms) return n;
  return n_rep;
}

// q, dout [B, Sq, H, D], k/v [B, Sk, KV, D] bf16 contiguous and 16-byte
// aligned; lse and dd = delta - dlse [B, H, Sq] f32; qseg [B, Sq] and
// kseg [B, Sk] int32 or both null; dk/dv [B, Sk, KV, D] bf16. D in
// {64, 128, 256}; window <= 0 means unbounded. Returns cudaGetLastError()
// after launch (cudaErrorInvalidValue for another D or a tensor TMA cannot
// map).
int flash_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        const void* qseg, const void* kseg, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int KV,
                        int D, float scale, int causal, int window,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKDV_ARGS(PART_K, PART_V, SPLIT)                                     \
  q, k, v, dout, lse, dd, qseg, kseg, PART_K, PART_V, dk, dv, B, Sq, Sk, H, \
      KV, SPLIT, scale, causal, window, st
  if (D == 64) return launch_dkdv<64>(DKDV_ARGS(nullptr, nullptr, 1));
  if (D == 128) return launch_dkdv<128>(DKDV_ARGS(nullptr, nullptr, 1));
  if (D == 256) return launch_dkdv<256>(DKDV_ARGS(nullptr, nullptr, 1));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with the group's q heads split over n_split blocks (n_split
// divides H / KV): dk_part and dv_part are f32 buffers of
// [n_split, B, Sk, KV, D], each fully written by the dK/dV kernel, then
// summed into dk and dv by a second kernel on the same stream. With
// n_split 1 and null partials it is flash_bwd_dkdv_bf16.
int flash_bwd_dkdv_split_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dd, const void* qseg,
                              const void* kseg, void* dk_part, void* dv_part,
                              void* dk, void* dv, int B, int Sq, int Sk,
                              int H, int KV, int D, int n_split, float scale,
                              int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || (H / KV) % n_split != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  if (D == 64) return launch_dkdv<64>(DKDV_ARGS(pk, pv, n_split));
  if (D == 128) return launch_dkdv<128>(DKDV_ARGS(pk, pv, n_split));
  if (D == 256) return launch_dkdv<256>(DKDV_ARGS(pk, pv, n_split));
#undef DKDV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same inputs; dq [B, Sq, H, D] bf16.
int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dd,
                      const void* qseg, const void* kseg, void* dq, int B,
                      int Sq, int Sk, int H, int KV, int D, float scale,
                      int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_ARGS                                                              \
  q, k, v, dout, lse, dd, qseg, kseg, dq, B, Sq, Sk, H, KV, scale, causal,  \
      window, st
  if (D == 64) return launch_dq<64>(DQ_ARGS);
  if (D == 128) return launch_dq<128>(DQ_ARGS);
  if (D == 256) return launch_dq<256>(DQ_ARGS);
#undef DQ_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
