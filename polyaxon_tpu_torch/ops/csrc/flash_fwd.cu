// Flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: polyaxon_tpu/ops/flash.py `_fwd_kernel` (launched from
// `_flash_fwd_pallas`), the blocked online-softmax forward.
//
// What bounds it on the H100: at prefill and training shapes (S in the
// thousands) attention does ~S/2 multiply-adds per byte it must read, far
// above the ~295 FLOP/byte ridge, so the bf16 tensor-core rate (989
// TFLOP/s dense) is the bound, not HBM. Reaching it takes `wgmma` (the
// only path to the full tensor-core rate) fed from shared memory without
// stalls on loads.
//
// What the design does about it:
// - Both products run on `wgmma.mma_async` (sm90_bf16.cuh): S = Q K^T
//   with Q and K from shared memory, then O += P V with P from registers
//   (the S accumulator, rescaled and rounded to bf16, is already the A
//   fragment) and V from shared memory through the transpose flag, so V
//   keeps its [keys, D] rows.
// - Warp specialisation: one producer thread issues TMA loads; two
//   consumer warpgroups own 64 q rows each of a 128-row q tile. Q is
//   loaded once; K and V stream through a ring of STAGES shared-memory
//   stages, each with a "full" mbarrier (TMA bytes landed) and an "empty"
//   one (both consumers' wgmmas on it are done), so the next tile's load
//   overlaps this tile's products and softmax. `setmaxnreg` gives the
//   producer warpgroup 24 registers and the consumers 240. While one
//   consumer warpgroup runs its softmax, the other's products keep the
//   tensor cores busy.
// - The tensor maps describe the strided [B, S, heads, D] layout directly
//   (no transpose), in 64-column panels with the 128-byte swizzle; they
//   are built for each call by `cuTensorMapEncodeTiled`, reached through
//   `cudaGetDriverEntryPoint` (no -lcuda). TMA zero-fills the ragged
//   tails, which the kernel still masks.
// - K/V tiles wholly above the causal diagonal or below the window band
//   are never loaded (`_block_visible`), a consumer warpgroup skips the
//   products of a tile none of its rows can see, the per-element mask
//   runs only on tiles that cut the diagonal, the band, the tail or
//   packed segments (the fast path folds the softmax scale into the exp),
//   and causal q tiles are issued longest first. With packed segments each
//   consumer thread loads one key segment id of the tile while the S
//   product runs, and the warpgroup shares them through shared memory.
// Not yet: skipping tiles whose segments the q tile never sees,
// overlapping a warpgroup's softmax with its own next product (tried:
// ptxas serialised the wgmmas, and it ran slower), and a TMA store of O
// (each thread writes its fragment).
//
// Tiles: 128 q rows per block; 128 keys per K/V tile at head_dim 64 and
// 128 and 64 at head_dim 256 (whose O accumulator alone is 128 registers
// a thread); 2 stages: 83 KB, 163 KB and 194 KB of shared memory.
//
// Masking follows `_block_mask`: causal triangle (rows >= cols, Sq ==
// Sk), window band (rows - cols < window), packed segment equality;
// masked logits are -1e30, and a row whose mass is 0 outputs 0 with lse
// = m + log(1), as `flash.py` finalizes. GQA: the kv head is h / (H / KV).

#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90_bf16.cuh"

namespace {

constexpr int BLOCK_M = 128;   // q rows per block: two warpgroups of 64
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int STAGES = 2;      // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int BN>  // head dim, keys per K/V tile
struct FwdSmem {
  static constexpr int PANELS = D / 64;
  static constexpr uint32_t Q_BYTES = BLOCK_M * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // K or V, one stage
  // Key-side segment ids of a tile (packed sequences only): two buffers
  // for each consumer warpgroup, alternating by tile.
  static constexpr uint32_t SEG_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = SEG_OFF + CONSUMERS * 2 * BN * 4;
  // + 1024 so the tiles can start on a 1024-byte boundary.
  static constexpr size_t BYTES = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
};

template <int D, int BN>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale, int causal, int window) {
  using L = FwdSmem<D, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::Q_BYTES;                        // stage s:
  const uint32_t v_s = base + L::Q_BYTES + STAGES * L::KV_BYTES;  // + s * KV
  const uint32_t seg_s = base + L::SEG_OFF;
  const uint32_t bar = base + L::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t q_bar = bar + 8 * 2 * STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BLOCK_M;
  const int kvh = h / (H / KV);
  const bool packed = qseg != nullptr;  // then kseg is [B, Sk] too

  // Tiles that can hold a visible column (`_block_visible`).
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
      mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int p = 0; p < L::PANELS; ++p)
        tma_load_4d(q_s + p * BLOCK_M * 128, &tq, q_bar, p * 64, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);  // a fresh barrier passes
        mbar_expect_tx(full(stage), 2 * L::KV_BYTES);
        for (int p = 0; p < L::PANELS; ++p) {
          const uint32_t off = stage * L::KV_BYTES + p * BN * 128;
          tma_load_4d(k_s + off, &tk, full(stage), p * 64, kvh, kt * BN, b);
          tma_load_4d(v_s + off, &tv, full(stage), p * 64, kvh, kt * BN, b);
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
    const int wg = tid / 128;  // consumer warpgroup: q rows wg*64 ..
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wg_row0 = q0 + wg * 64;
    const int row[2] = {wg_row0 + warp * 16 + g, wg_row0 + warp * 16 + g + 8};
    int qs[2] = {0, 0};
    if (packed) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < Sq) qs[r] = qseg[static_cast<size_t>(b) * Sq + row[r]];
    }
    // This warpgroup's two buffers of key segment ids: thread i of the
    // group copies id k0 + i of each tile (loaded before the tile's S
    // product, stored after it, then a warpgroup barrier).
    int* kseg_w = reinterpret_cast<int*>(
        smem_raw + (seg_s - smem_u32(smem_raw))) + wg * 2 * BN;
    const int* kseg_b =
        packed ? kseg + static_cast<size_t>(b) * Sk : nullptr;
    const int wtid = tid % 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // per-thread partial sums; quad-reduced at end

    mbar_wait(q_bar, 0);
    const uint32_t q_wg = q_s + wg * 64 * 128;  // this group's rows

    // The online softmax of a finished S: mask (only where the tile cuts
    // the diagonal, the band, the tail or segments), the running max and
    // sum, P in bf16 as the A operand. Returns each row's rescale factor
    // for O (applied by the caller once O is no longer in flight).
    auto softmax = [&](float* s, uint32_t (*pa)[4], int k0,
                       const int* ksg, float* alpha) {
      const bool masked =
          packed || k0 + BN > Sk ||
          (causal && (k0 + BN - 1 > wg_row0 ||
                      (window > 0 && wg_row0 + 63 - k0 >= window)));
      // Masked tiles scale visible logits into s and set masked ones to
      // -1e30; the fast path keeps s unscaled and folds the scale into
      // the exp.
      float mx[2] = {m[0], m[1]};
      if (masked) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + j * 8 + t4 * 2 + e;
            const bool in = c < Sk;
            const int ks_c = packed ? ksg[j * 8 + t4 * 2 + e] : 0;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              bool ok = in;
              if (causal)
                ok = ok && row[r] >= c &&
                     (window <= 0 || row[r] - c < window);
              if (packed) ok = ok && qs[r] == ks_c;
              const int i = 4 * j + 2 * r + e;
              const float x = ok ? s[i] * scale : NEG_INF;
              s[i] = x;
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
      } else {
        float raw[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], raw[r] * scale);
      }
      float ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
        ml[r] = mx[r] * LOG2E;
        l[r] *= alpha[r];
      }
      // p = exp(s - m) on visible columns, 0 on masked ones (a visible
      // logit is never exactly -1e30).
      const float s_log2 = masked ? LOG2E : scale * LOG2E;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float x = s[i];
        float p = fast_exp2(fmaf(x, s_log2, -ml[r]));
        if (masked && x == NEG_INF) p = 0.f;
        s[i] = p;
        l[r] += p;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk);
    };
    auto rescale = [&](const float* alpha) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    };

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * BN;
      // Every row of this warpgroup masked out of the whole tile: no
      // products (the stage is still released).
      const bool none = causal && (k0 > wg_row0 + 63 ||
                                   (window > 0 &&
                                    wg_row0 - (k0 + BN - 1) >= window));
      int my_seg = 0;  // in flight during the S product
      if (packed && !none && wtid < BN && k0 + wtid < Sk)
        my_seg = kseg_b[k0 + wtid];
      // This tile's key segment ids for the warpgroup; the other buffer
      // was last read before the previous tile's barrier.
      int* ksg = kseg_w + (kt & 1) * BN;
      mbar_wait(full(stage), phase);
      if (!none) {
        float s[BN / 2];
        uint32_t pa[BN / 16][4];
        float alpha[2];
        wgmma_fence();  // S = Q K^T: 64 rows x BN keys over the head dim
        issue_ss<BN, D>(s, q_wg, BLOCK_M, k_s + stage * L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN / 2>(s);
        if (packed) {
          if (wtid < BN) ksg[wtid] = my_seg;
          named_barrier_sync(1 + wg, 128);
        }
        softmax(s, pa, k0, ksg, alpha);
        rescale(alpha);
        wgmma_fence();  // O += P V, V MN-major
        issue_rs<D, BN>(acc, pa, v_s + stage * L::KV_BYTES, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        fence_regs<BN / 4>(&pa[0][0]);
      }
      mbar_arrive(empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Finalize: l over the quad, l == 0 -> 1 (a fully masked row outputs
    // 0), o in bf16, lse = m + log(l) in f32.
    const size_t q_stride = static_cast<size_t>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float l_safe = (l[r] == 0.f) ? 1.f : l[r];
      if (row[r] >= Sq) continue;
      const float inv = 1.f / l_safe;
      bf16* op = o + static_cast<size_t>(b) * Sq * q_stride +
                 static_cast<size_t>(row[r]) * q_stride +
                 static_cast<size_t>(h) * D + t4 * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(op + j * 8) =
            pack_f32(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
      if (t4 == 0)
        lse[(static_cast<size_t>(b) * H + h) * Sq + row[r]] =
            m[r] + logf(l_safe);
    }
  }
}

template <int D, int BN>
int launch(const void* q, const void* k, const void* v, const int* qseg,
           const int* kseg, bf16* o, float* lse, int B, int Sq, int Sk, int H,
           int KV, float scale, int causal, int window, cudaStream_t st) {
  constexpr size_t smem = FwdSmem<D, BN>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, enc, q, D, H, Sq, B, BLOCK_M) ||
      !make_map(&tk, enc, k, D, KV, Sk, B, BN) ||
      !make_map(&tv, enc, v, D, KV, Sk, B, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B, (Sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<D, BN><<<grid, THREADS, smem, st>>>(
      tq, tk, tv, qseg, kseg, o, lse, Sq, Sk, H, KV, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Sq, H, D], k/v [B, Sk, KV, D] bf16 contiguous and 16-byte
// aligned; qseg [B, Sq] and kseg [B, Sk] int32 or both null; o [B, Sq, H, D]
// bf16; lse [B, H, Sq] f32. D in {64, 128, 256}; window <= 0 means
// unbounded. Returns cudaGetLastError() after launch
// (cudaErrorInvalidValue for another D or a tensor TMA cannot map).
int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* qseg, const void* kseg, void* o, void* lse,
                   int B, int Sq, int Sk, int H, int KV, int D, float scale,
                   int causal, int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                          \
  q, k, v, static_cast<const int*>(qseg), static_cast<const int*>(kseg),    \
      static_cast<bf16*>(o), static_cast<float*>(lse), B, Sq, Sk, H, KV,    \
      scale, causal, window, st
  if (D == 128) return launch<128, 128>(FLASH_ARGS);
  if (D == 64) return launch<64, 128>(FLASH_ARGS);
  if (D == 256) return launch<256, 64>(FLASH_ARGS);
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
