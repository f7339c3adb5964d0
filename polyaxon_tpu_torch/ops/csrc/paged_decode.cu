// Paged decode attention for Hopper (sm_90a): one query position per
// row against that row's KV pages, read through its block table, split
// over pages across blocks (flash-decoding).
//
// Replaces: polyaxon_tpu/ops/paged_attention.py `_decode_kernel`
// (launched from `paged_decode_attention`).
//
// What bounds it on the H100: HBM bytes. A decode step does one
// multiply-add per K/V element per q head of the GQA group (rep = H/KV of
// them), far below the ~295 FLOP/byte ridge, so the least time is the
// live K/V bytes (columns 0..pos of every row, holes excluded) plus q,
// out, tables and pos, over 3.35 TB/s.
//
// The design, keyed to what holds a decode kernel back on this card:
// - Enough blocks. The grid is (split, kv head x head chunk, row). The
//   host picks the split count (`decode_splits` in ops/paged_attention.py)
//   without a device sync: 1 where rows x kv heads already give every SM
//   four blocks, else about four blocks per SM, with at least 8 tiles of
//   the table's width per split. The host cannot see the rows' lengths,
//   so each block computes its share here, from pos[b]: the row's live
//   tokens are cut into tiles of T = 32 tokens, and split s of n takes
//   tiles [s*ntiles/n, (s+1)*ntiles/n). A short row leaves splits empty;
//   they write an empty partial (m = -1e30, l = 0, O = 0). Table width
//   costs nothing.
// - K/V read once per GQA group. A block holds up to 16 q heads of one
//   kv head (the M rows of `mma.sync.m16n8k16`, padded), so gemma_2b's 8
//   and llama's 4 share every K/V tile from shared memory. Only a group
//   of more than 16 (no model of the repository) takes a second block
//   per kv head, which reads the pages again.
// - Loads in flight. Tiles stream into a shared-memory ring (4 stages, 3
//   at head_dim 256) by 16-byte `cp.async` with a 256-byte L2 prefetch
//   hint, zero-filled for holes and columns past pos, which are never
//   read. cp.async over TMA: a token row's address comes from its own
//   table entry, holes need a zero fill and a mask anyway, and there is
//   no tensor map to encode per call. Small tiles and a small ring leave
//   room for three blocks per SM (two at head_dim 256); on the card this
//   took 18% less time than 64-token tiles in a 3-stage ring at 8 long
//   llama3_8b rows.
// - Instructions under the memory time. The scores of a whole tile are
//   one tensor-core product per warp (q heads as M, 8-token n-tiles, the
//   head dim as depth); one max and one rescale per tile, exp2 with the
//   scale folded in; P goes through shared memory as bf16 and P V is a
//   second product, each warp owning a quarter of the head dim. No
//   per-token shuffle reduction, no per-token rescale.
// - Deterministic merge in the same launch. With more than one split
//   each block writes f32 partials (O, m, l); the last block of a (row,
//   kv head) to finish, found through a counter it resets, merges them
//   in a fixed order, so outputs repeat bitwise. One split writes the
//   output directly. (A second merge launch measured slower.)
//
// Layout: q [B, H, Hd], where kv head kvh serves query heads kvh*rep ..
// kvh*rep+rep-1 (rep = H / KV); pages [P, page, KV, Hd]; tables
// [B, maxp] int32 (-1 = hole); pos [B] int32 (-1 = idle row, whose
// output is 0). Columns 0..pos (and below maxp*page) are visible; the
// scale is Hd^-0.5. A row whose visible pages are all holes outputs 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;        // q heads per block: the mma M
constexpr int MAX_SPLITS = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int HD>
struct Cfg {
  static constexpr int T = 32;  // tokens per tile
  // cp.async ring depth: 4 where the ring stays small enough for three
  // blocks per SM (head_dim 64 and 128), 3 at 256 (two blocks per SM).
  static constexpr int STAGES = HD == 256 ? 3 : 4;
  static constexpr int ROW = HD + 8;   // K/V row pitch (elements): the 16
                                       // extra bytes make ldmatrix
                                       // conflict-free
  static constexpr int PROW = T + 8;   // P row pitch (elements)
  static constexpr int TW = T / WARPS;  // tokens per warp in S
  static constexpr int NT = TW / 8;     // S n-tiles per warp
  static constexpr int KS = HD / 16;    // depth steps of S
  static constexpr int CW = HD / WARPS;  // output columns per warp
  static constexpr int NO = CW / 8;      // output n-tiles per warp
  static constexpr int TPR = THREADS / T;  // loader threads per token row
  static constexpr int CPT = HD / 8 / TPR;  // 16-byte chunks per thread
  static constexpr int TILE = T * ROW;      // elements per matrix, stage
  static constexpr int SMEM = 2 * STAGES * TILE * 2 + ROWS * PROW * 2 +
                              STAGES * T * 4 + WARPS * ROWS * 4 + 16;
  static_assert(NT >= 1 && NO % 2 == 0 && KS % 2 == 0 && TPR >= 1,
                "tile shape");
  static_assert(2 * STAGES * TILE * 2 >= ROWS * MAX_SPLITS * 4,
                "the merge's weights reuse the K/V ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (no
// byte is read then). The L2 fetches the 256 bytes around it: a token
// row of one kv head is 128 to 512 bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (m16n8 f32) += a (m16k16 bf16, row) * b (k16n8 bf16, col).
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Merge the nsplit partials of one (row, kv head chunk), by the block
// that finished last: out[row0 + r] = sum_s w_s O_s with w_s =
// exp2(m_s - M) / sum_s exp2(m_s - M) l_s (all 0 where that sum is 0).
// One warp per q head loads all of that head's m and l at once (the
// weights go to `w`, ROWS * nsplit floats of shared memory); then each
// thread sums four columns over the splits, its loads issued MB splits at
// a time. Splits of weight 0 (empty, or all holes) are neither read nor
// added. O is summed in split order and l in a fixed shuffle order, so
// outputs repeat bitwise.
template <int HD>
__device__ __forceinline__ void merge_partials(
    const float* __restrict__ op, const float* __restrict__ mp,
    const float* __restrict__ lp, bf16* __restrict__ out, size_t row0,
    int nh, int nsplit, float* w) {
  constexpr int PER_LANE = MAX_SPLITS / 32;
  constexpr int MB = 8;
  constexpr int Q4 = HD / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nh; r += WARPS) {
    const float* m = mp + (row0 + r) * nsplit;
    const float* l = lp + (row0 + r) * nsplit;
    float mv[PER_LANE], lv[PER_LANE];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int s = lane + 32 * k;
      mv[k] = s < nsplit ? __ldcg(m + s) : NEG_INF;
      lv[k] = s < nsplit ? __ldcg(l + s) : 0.f;
      mx = fmaxf(mx, mv[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      mv[k] = ex2(mv[k] - mx);
      sum += mv[k] * lv[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int s = lane + 32 * k;
      if (s < nsplit) w[r * nsplit + s] = lv[k] > 0.f ? mv[k] * inv : 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * Q4; i += THREADS) {
    const int r = i / Q4, c = (i % Q4) * 4;
    const float* o = op + (row0 + r) * nsplit * HD + c;
    const float* wr = w + r * nsplit;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < nsplit; s0 += MB) {
      float4 v[MB];
      float wt[MB];
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        wt[u] = s0 + u < nsplit ? wr[s0 + u] : 0.f;
        if (wt[u] != 0.f)
          v[u] = __ldcg(reinterpret_cast<const float4*>(
              o + static_cast<size_t>(s0 + u) * HD));
      }
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        if (wt[u] != 0.f) {
          a.x += wt[u] * v[u].x;
          a.y += wt[u] * v[u].y;
          a.z += wt[u] * v[u].z;
          a.w += wt[u] * v[u].w;
        }
      }
    }
    uint2 packed;
    packed.x = pack_bf16(a.x, a.y);
    packed.y = pack_bf16(a.z, a.w);
    *reinterpret_cast<uint2*>(out + (row0 + r) * HD + c) = packed;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, bf16* __restrict__ out,
                    float* __restrict__ op, float* __restrict__ mp,
                    float* __restrict__ lp, int* __restrict__ counters,
                    int H, int KV, int page, int maxp, int nsplit,
                    float scale_log2) {
  typedef Cfg<HD> C;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + C::STAGES * C::TILE;
  bf16* ps = vs + C::STAGES * C::TILE;
  float* bias = reinterpret_cast<float*>(ps + ROWS * C::PROW);
  float* red = bias + C::STAGES * C::T;
  int* flag = reinterpret_cast<int*>(red + WARPS * ROWS);

  const int s = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV, chunks = (rep + ROWS - 1) / ROWS;
  const int kvh = y / chunks, ch = y % chunks;
  const int h0 = kvh * rep + ch * ROWS;
  const int nh = min(ROWS, rep - ch * ROWS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // This split's share of the row's live tiles.
  const int p = pos[b];
  const int last = min(p, maxp * page - 1);  // < 0: idle row
  const int ntiles = last < 0 ? 0 : last / C::T + 1;
  const int t0 = static_cast<int>(static_cast<long long>(s) * ntiles /
                                  nsplit);
  const int n = static_cast<int>(static_cast<long long>(s + 1) * ntiles /
                                 nsplit) - t0;

  // Loader: thread -> (token row of the tile, chunk phase).
  const int lrow = threadIdx.x / C::TPR, lpart = threadIdx.x % C::TPR;
  const int* trow = tables + static_cast<size_t>(b) * maxp;
  const size_t tok_stride = static_cast<size_t>(KV) * HD;
  auto page_of = [&](int i) -> int {
    const int tok = (t0 + i) * C::T + lrow;
    return (i < n && tok <= last) ? __ldg(trow + tok / page) : -1;
  };
  auto issue = [&](int i, int st, int pid) {
    const int tok = (t0 + i) * C::T + lrow;
    const bool ok = pid >= 0;
    const size_t off =
        ok ? (static_cast<size_t>(pid) * page + tok % page) * tok_stride +
                 static_cast<size_t>(kvh) * HD
           : 0;
    const uint32_t kd = smem_u32(ks + st * C::TILE + lrow * C::ROW);
    const uint32_t vd = smem_u32(vs + st * C::TILE + lrow * C::ROW);
#pragma unroll
    for (int i2 = 0; i2 < C::CPT; ++i2) {
      const int c = lpart + C::TPR * i2;
      cp_async16(kd + c * 16, kp + off + c * 8, ok);
      cp_async16(vd + c * 16, vp + off + c * 8, ok);
    }
    if (lpart == 0) bias[st * C::T + lrow] = ok ? 0.f : -CUDART_INF_F;
  };

  // q heads h0 .. h0+nh-1 as the A operand of S (rows past nh are 0).
  uint32_t qa[C::KS][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (static_cast<size_t>(b) * H + h0 + g) * HD);
    const uint32_t* q1 = q0 + 8 * HD / 2;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      const int c = (16 * kk + 2 * t) / 2;
      qa[kk][0] = g < nh ? q0[c] : 0u;
      qa[kk][1] = g + 8 < nh ? q1[c] : 0u;
      qa[kk][2] = g < nh ? q0[c + 4] : 0u;
      qa[kk][3] = g + 8 < nh ? q1[c + 4] : 0u;
    }
  }

  float acc[C::NO][4];
#pragma unroll
  for (int j = 0; j < C::NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // rows g and g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // this thread's columns only

#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < n) issue(i, i, page_of(i));
    cp_async_commit();
  }
  int pnext = page_of(C::STAGES - 1);

  const int cb = warp * C::CW;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile i landed; tile i-1's stage is free
    {
      const int nx = i + C::STAGES - 1;
      if (nx < n) issue(nx, nx % C::STAGES, pnext);
      cp_async_commit();
      pnext = page_of(nx + 1);
    }
    const int st = i % C::STAGES;
    const bf16* kt = ks + st * C::TILE;
    const bf16* vt = vs + st * C::TILE;
    const float* bs = bias + st * C::T;

    // S = q K^T over this warp's tokens, scaled to log2 units and masked.
    float sc[C::NT][4];
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int n0 = warp * C::TW + 8 * j;
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const uint32_t base =
          smem_u32(kt + (n0 + (lane & 7)) * C::ROW + 8 * (lane >> 3));
#pragma unroll
      for (int kk = 0; kk < C::KS; kk += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, base + kk * 32);
        mma16816(sc[j], qa[kk], bk[0], bk[1]);
        mma16816(sc[j], qa[kk + 1], bk[2], bk[3]);
      }
      const float2 bb = *reinterpret_cast<const float2*>(bs + n0 + 2 * t);
      sc[j][0] = fmaf(sc[j][0], scale_log2, bb.x);
      sc[j][1] = fmaf(sc[j][1], scale_log2, bb.y);
      sc[j][2] = fmaf(sc[j][2], scale_log2, bb.x);
      sc[j][3] = fmaf(sc[j][3], scale_log2, bb.y);
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      red[warp * ROWS + g] = mx0;
      red[warp * ROWS + g + 8] = mx1;
    }
    __syncthreads();  // every warp's tile max

    // One max and one rescale per tile.
    float tm0 = red[g], tm1 = red[g + 8];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      tm0 = fmaxf(tm0, red[w * ROWS + g]);
      tm1 = fmaxf(tm1, red[w * ROWS + g + 8]);
    }
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int n0 = warp * C::TW + 8 * j;
      const float p0 = ex2(sc[j][0] - mn0), p1 = ex2(sc[j][1] - mn0);
      const float p2 = ex2(sc[j][2] - mn1), p3 = ex2(sc[j][3] - mn1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      *reinterpret_cast<uint32_t*>(ps + g * C::PROW + n0 + 2 * t) =
          pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + (g + 8) * C::PROW + n0 + 2 * t) =
          pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
    __syncthreads();  // P of the whole tile

    // O[:, this warp's columns] = O * alpha + P V.
#pragma unroll
    for (int j = 0; j < C::NO; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
    const uint32_t pbase = smem_u32(
        ps + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::PROW + 8 * (lane >> 4));
    const uint32_t vbase =
        smem_u32(vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::ROW + cb +
                 8 * (lane >> 4));
#pragma unroll
    for (int k = 0; k < C::T / 16; ++k) {
      uint32_t pa[4];
      ldsm_x4(pa, pbase + k * 32);
#pragma unroll
      for (int jp = 0; jp < C::NO / 2; ++jp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vbase + (k * 16 * C::ROW + jp * 16) * 2);
        mma16816(acc[2 * jp], pa, bv[0], bv[1]);
        mma16816(acc[2 * jp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Row sums: the quad, then the four warps.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();  // the loop's last reads of red are done
  if (t == 0) {
    red[warp * ROWS + g] = l0;
    red[warp * ROWS + g + 8] = l1;
  }
  __syncthreads();
  float L0 = 0.f, L1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    L0 += red[w * ROWS + g];
    L1 += red[w * ROWS + g + 8];
  }

  const size_t row0 = static_cast<size_t>(b) * H + h0;
  if (nsplit == 1) {
    const float i0 = L0 > 0.f ? 1.f / L0 : 0.f;
    const float i1 = L1 > 0.f ? 1.f / L1 : 0.f;
#pragma unroll
    for (int j = 0; j < C::NO; ++j) {
      const int col = cb + 8 * j + 2 * t;
      if (g < nh)
        *reinterpret_cast<uint32_t*>(out + (row0 + g) * HD + col) =
            pack_bf16(acc[j][0] * i0, acc[j][1] * i0);
      if (g + 8 < nh)
        *reinterpret_cast<uint32_t*>(out + (row0 + g + 8) * HD + col) =
            pack_bf16(acc[j][2] * i1, acc[j][3] * i1);
    }
    return;
  }

  // Partials: O unnormalised, m in log2 units, l.
#pragma unroll
  for (int j = 0; j < C::NO; ++j) {
    const int col = cb + 8 * j + 2 * t;
    if (g < nh)
      *reinterpret_cast<float2*>(op + ((row0 + g) * nsplit + s) * HD + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (g + 8 < nh)
      *reinterpret_cast<float2*>(op + ((row0 + g + 8) * nsplit + s) * HD +
                                 col) = make_float2(acc[j][2], acc[j][3]);
  }
  if (warp == 0 && t == 0) {
    if (g < nh) {
      mp[(row0 + g) * nsplit + s] = m0;
      lp[(row0 + g) * nsplit + s] = L0;
    }
    if (g + 8 < nh) {
      mp[(row0 + g + 8) * nsplit + s] = m1;
      lp[(row0 + g + 8) * nsplit + s] = L1;
    }
  }

  // The last block of this (row, kv head chunk) to finish merges.
  __threadfence();
  __syncthreads();
  int* cnt = counters + static_cast<size_t>(b) * gridDim.y + y;
  if (threadIdx.x == 0) *flag = atomicAdd(cnt, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  merge_partials<HD>(op, mp, lp, out, row0, nh, nsplit,
                     reinterpret_cast<float*>(smem));
  if (threadIdx.x == 0) *cnt = 0;  // ready for the next launch
}

template <int HD>
int launch_hd(const void* q, const void* kp, const void* vp,
              const void* tables, const void* pos, void* out, void* op,
              void* mp, void* lp, void* counters, int B, int H, int KV,
              int page, int maxp, int nsplit, float scale, cudaStream_t st) {
  typedef Cfg<HD> C;
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (H / KV + ROWS - 1) / ROWS;
  const dim3 grid(nsplit, KV * chunks, B);
  paged_decode_kernel<HD><<<grid, THREADS, C::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<bf16*>(out),
      static_cast<float*>(op), static_cast<float*>(mp),
      static_cast<float*>(lp), static_cast<int*>(counters), H, KV, page,
      maxp, nsplit, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, H, Hd] bf16; k/v pages [P, page, KV, Hd] bf16; tables [B, maxp]
// int32; pos [B] int32; out [B, H, Hd] bf16; all contiguous, 16-byte
// aligned. Hd in {64, 128, 256}, H a multiple of KV, 1 <= nsplit <= 256.
// With nsplit > 1: partials op [B, H, nsplit, Hd] f32, mp and lp
// [B, H, nsplit] f32, and counters [B, KV * ceil(rep / 16)] int32, zero
// on entry and left zero. Returns cudaGetLastError()
// (cudaErrorInvalidValue for another shape).
int paged_decode_bf16(const void* q, const void* kp, const void* vp,
                      const void* tables, const void* pos, void* out,
                      void* op, void* mp, void* lp, void* counters, int B,
                      int H, int KV, int Hd, int page, int maxp, int nsplit,
                      float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || KV < 1 || H % KV || page < 1 || maxp < 1 || nsplit < 1 ||
      nsplit > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Hd) {
    case 64:
      return launch_hd<64>(q, kp, vp, tables, pos, out, op, mp, lp, counters,
                           B, H, KV, page, maxp, nsplit, scale, st);
    case 128:
      return launch_hd<128>(q, kp, vp, tables, pos, out, op, mp, lp,
                            counters, B, H, KV, page, maxp, nsplit, scale,
                            st);
    case 256:
      return launch_hd<256>(q, kp, vp, tables, pos, out, op, mp, lp,
                            counters, B, H, KV, page, maxp, nsplit, scale,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Tokens per tile at head_dim Hd (0 for a head_dim without a kernel):
// the unit in which a row's live tokens are split.
int paged_decode_tile_tokens(int Hd) {
  switch (Hd) {
    case 64:
      return Cfg<64>::T;
    case 128:
      return Cfg<128>::T;
    case 256:
      return Cfg<256>::T;
    default:
      return 0;
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
