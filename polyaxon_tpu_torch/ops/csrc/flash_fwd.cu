// Flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces: polyaxon_tpu/ops/flash.py `_fwd_kernel` (launched from
// `_flash_fwd_pallas`), the blocked online-softmax forward.
//
// What bounds it on the H100: at prefill shapes (S in the thousands,
// head_dim 128) attention does ~S/2 multiply-adds per byte it must read,
// far above the ~295 FLOP/byte ridge, so the bf16 tensor-core rate
// (989 TFLOP/s dense) is the bound, not HBM.
//
// What the design does about it: both products (Q K^T and P V) run on
// the tensor cores through `mma.sync.m16n8k16` (bf16 in, f32
// accumulate), the S tile never leaves registers (it becomes the A
// operand of P V in place, FlashAttention-2 style), and K/V tiles wholly
// above the causal diagonal or outside the sliding window are never
// loaded. This first version keeps one synchronous K/V tile in shared
// memory per step (no cp.async / TMA pipeline, no wgmma); those are the
// levers of a later pass.
//
// Layout: one thread block of 4 warps per (64-row q tile, q head, batch
// row); each warp owns 16 q rows. K/V tiles stream through shared memory
// (64 keys for head_dim 64 and 128; 32 keys for head_dim 256, so the two
// tiles still fit the 48 KB of static shared memory); the kv head is
// h / (H / KV) (GQA). Any sequence length:
// the ragged tail is masked in the kernel (columns >= Sk, rows >= Sq).
// Masking follows `_block_mask`: causal triangle (rows >= cols, Sq == Sk),
// window band (rows - cols < window), packed segment equality; masked
// logits are -1e30, and a row whose mass is 0 outputs 0 with
// lse = m + log(1), as `flash.py` finalizes.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BLOCK_M = 64;   // q rows per block, 16 per warp
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int D, int BLOCK_N>  // head dim, keys per K/V tile
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale, int causal, int window) {
  constexpr int KSTEPS = D / 16;        // k-steps of Q K^T over head dim
  constexpr int NT_S = BLOCK_N / 8;     // 8-column tiles of S
  constexpr int NT_O = D / 8;           // 8-column tiles of O
  constexpr int LDS = D + 8;            // padded smem row: no bank conflicts
  constexpr int CHUNKS = BLOCK_N * D / 8;  // 16-byte chunks per tile

  __shared__ __align__(16) bf16 Ks[BLOCK_N * LDS];
  __shared__ __align__(16) bf16 Vs[BLOCK_N * LDS];

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const size_t q_stride = static_cast<size_t>(H) * D;    // one q row
  const size_t kv_stride = static_cast<size_t>(KV) * D;  // one k/v row
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_stride +
                   static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kv_stride +
                   static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * kv_stride +
                   static_cast<size_t>(kvh) * D;

  // Q fragments stay in registers for the whole kv sweep.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks * 16 + t4 * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t lo = 0, hi = 0;
      if (row[r] < Sq) {
        const bf16* p = qb + static_cast<size_t>(row[r]) * q_stride + c;
        lo = *reinterpret_cast<const uint32_t*>(p);
        hi = *reinterpret_cast<const uint32_t*>(p + 8);
      }
      qf[ks][r] = lo;       // a0a1 (row g) / a2a3 (row g+8)
      qf[ks][r + 2] = hi;   // a4a5 / a6a7: columns + 8
    }
  }
  int qs[2] = {0, 0};
  if (qseg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < Sq) qs[r] = qseg[static_cast<size_t>(b) * Sq + row[r]];
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // per-thread partial sums; quad-reduced at end

  // Tiles that can hold a visible column (`_block_visible`).
  int kt_begin = 0;
  int kt_end = (Sk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last_row = min(q0 + BLOCK_M, Sq) - 1;
    kt_end = min(kt_end, last_row / BLOCK_N + 1);
    if (window > 0) {
      const int lo = q0 - (window - 1);
      if (lo > 0) kt_begin = lo / BLOCK_N;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BLOCK_N;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        const size_t off = static_cast<size_t>(k0 + r) * kv_stride + c;
        kk = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = kk;
      *reinterpret_cast<uint4*>(&Vs[r * LDS + c]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BLOCK_N keys.
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        // B[k][n] = K[key n][dim k]: b0b1 = K[n*8+g][ks*16+2t .. +1],
        // b2b3 = the same key, dims + 8.
        const bf16* kp = &Ks[(n * 8 + g) * LDS + ks * 16 + t4 * 2];
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kp),
                                 *reinterpret_cast<const uint32_t*>(kp + 8)};
        mma_16816(s[n], qf[ks], bfr);
      }
    }

    // Scale, mask, and the running row max.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row[i >> 1];
        const int c = k0 + n * 8 + t4 * 2 + (i & 1);
        bool ok = c < Sk;
        if (causal) ok = ok && r >= c && (window <= 0 || r - c < window);
        if (qseg != nullptr && ok)
          ok = qs[i >> 1] == kseg[static_cast<size_t>(b) * Sk + c];
        const float x = ok ? s[n][i] * scale : NEG_INF;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p = exp(s - m) on visible columns, 0 on masked ones (a visible
    // logit is never exactly -1e30).
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[n][i];
        const float p = (x == NEG_INF) ? 0.f : expf(x - m[i >> 1]);
        s[n][i] = p;
        l[i >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V. The S accumulator tiles (2kk, 2kk+1) are exactly the A
    // fragment of keys kk*16 .. kk*16+15.
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        // B[k][n] = V[key k][dim n]: b0b1 = V[kk*16+2t .. +1][n*8+g],
        // b2b3 = keys + 8.
        const bf16* vp = &Vs[(kk * 16 + t4 * 2) * LDS + n * 8 + g];
        const uint32_t bfr[2] = {pack_bf16(vp[0], vp[LDS]),
                                 pack_bf16(vp[8 * LDS], vp[9 * LDS])};
        mma_16816(acc[n], a, bfr);
      }
    }
  }

  // Finalize: l over the quad, l == 0 -> 1 (a fully masked row outputs
  // 0), o in bf16, lse = m + log(l) in f32.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = (l[r] == 0.f) ? 1.f : l[r];
    if (row[r] >= Sq) continue;
    bf16* op = o + static_cast<size_t>(b) * Sq * q_stride +
               static_cast<size_t>(row[r]) * q_stride +
               static_cast<size_t>(h) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_f32(acc[n][2 * r] / l_safe, acc[n][2 * r + 1] / l_safe);
    }
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row[r]] = m[r] + logf(l_safe);
  }
}

}  // namespace

extern "C" {

// q [B, Sq, H, D], k/v [B, Sk, KV, D] bf16 contiguous; qseg [B, Sq] and
// kseg [B, Sk] int32 or null; o [B, Sq, H, D] bf16; lse [B, H, Sq] f32.
// D in {64, 128, 256}; window <= 0 means unbounded. Returns
// cudaGetLastError() after launch (cudaErrorInvalidValue for another D).
int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const void* qseg, const void* kseg, void* o, void* lse,
                   int B, int Sq, int Sk, int H, int KV, int D, float scale,
                   int causal, int window, void* stream) {
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                        \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),               \
      static_cast<const bf16*>(v), static_cast<const int*>(qseg),         \
      static_cast<const int*>(kseg), static_cast<bf16*>(o),               \
      static_cast<float*>(lse), Sq, Sk, H, KV, scale, causal, window
  if (D == 128) {
    flash_fwd_kernel<128, 64><<<grid, THREADS, 0, st>>>(FLASH_ARGS);
  } else if (D == 64) {
    flash_fwd_kernel<64, 64><<<grid, THREADS, 0, st>>>(FLASH_ARGS);
  } else if (D == 256) {
    flash_fwd_kernel<256, 32><<<grid, THREADS, 0, st>>>(FLASH_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_ARGS
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
