// Paged decode attention for Hopper (sm_90a): one query position per
// row against that row's KV pages, read through its block table.
//
// Replaces: polyaxon_tpu/ops/paged_attention.py `_decode_kernel`
// (launched from `paged_decode_attention`).
//
// What bounds it on the H100: HBM bytes. A decode step does about one
// multiply-add per K/V element it reads (rep = H/KV of them per element
// under GQA), far below the ~295 FLOP/byte ridge, so the least time is
// the row's live K/V bytes over 3.35 TB/s.
//
// What the design does about it: K/V is read straight from the page
// pool, with no gathered copy of the pages (the gather formulation
// writes and re-reads one); pages that are holes (table entry -1) or
// start past the row's position are never touched; and up to four query
// heads of a GQA group share each K/V load, so every live K/V byte is
// read once when H/KV <= 4 (a larger group is split over adjacent blocks,
// each of which reads the pages). Each warp loads a chunk of tokens of K
// and V (64 registers' worth) before using any of it, so many loads are
// in flight per warp. The four warps of a block take pages round-robin
// with their own online-softmax state and merge through shared memory
// once at the end. A split over pages across blocks (flash-decoding) is
// left for a later pass.
//
// Layout: one thread block per (group of up to four query heads, kv
// head, row b); q [B, H, Hd], where kv head kvh serves query heads
// kvh*rep .. kvh*rep+rep-1 (rep = H / KV, any value); pages
// [P, page, KV, Hd]; tables [B, maxp] int32 (-1 = hole); pos [B] int32
// (-1 = idle row, whose output is 0). Columns 0..pos are visible; scale
// is Hd^-0.5.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
// Query heads of one GQA group per block, each with its own register
// slots; a larger group is split over blocks along grid x.
constexpr int MAX_REP = 4;
constexpr float NEG_INF = -1e30f;

typedef __nv_bfloat16 bf16;

// EPL consecutive bf16 per lane, loaded as one vector.
template <int EPL>
struct Vec;
template <>
struct Vec<2> { typedef uint32_t T; };
template <>
struct Vec<4> { typedef uint2 T; };
template <>
struct Vec<8> { typedef uint4 T; };

template <int EPL>
__device__ __forceinline__ void unpack(const typename Vec<EPL>::T& raw,
                                       float* out) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, bf16* __restrict__ out,
                    int H, int KV, int page, int maxp, float scale) {
  constexpr int EPL = HD / 32;  // head-dim elements per lane
  constexpr int CHUNK = 64 / EPL;  // tokens loaded per warp before use
  typedef typename Vec<EPL>::T VecT;
  __shared__ float m_s[WARPS][MAX_REP];
  __shared__ float l_s[WARPS][MAX_REP];
  __shared__ float acc_s[WARPS][MAX_REP][HD];

  const int grp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV;
  const int h0 = kvh * rep + grp * MAX_REP;         // this block's first q head
  const int nh = min(MAX_REP, rep - grp * MAX_REP);  // and how many it owns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = pos[b];
  const size_t tok_stride = static_cast<size_t>(KV) * HD;

  // Every slot is computed, so the per-head products and shuffles of the
  // token loop stay independent (no run-time branch between them); the
  // slots past nh hold q = 0 and are never stored.
  float qr[MAX_REP][EPL];
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) {
    if (h < nh) {
      const VecT raw = *reinterpret_cast<const VecT*>(
          q + (static_cast<size_t>(b) * H + h0 + h) * HD + lane * EPL);
      unpack<EPL>(raw, qr[h]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[h][e] = 0.f;
    }
  }
  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][EPL];
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }

  const int npages = (p < 0) ? 0 : min(maxp, p / page + 1);
  for (int j = warp; j < npages; j += WARPS) {
    const int pid = tables[static_cast<size_t>(b) * maxp + j];
    if (pid < 0) continue;  // hole: never allocated, never read
    const int ntok = min(page, p - j * page + 1);  // columns <= pos
    const size_t base = (static_cast<size_t>(pid) * page * KV + kvh) * HD +
                        lane * EPL;
    for (int t0 = 0; t0 < ntok; t0 += CHUNK) {
      VecT kr[CHUNK], vr[CHUNK];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        if (t0 + t < ntok) {
          const size_t off = base + static_cast<size_t>(t0 + t) * tok_stride;
          kr[t] = *reinterpret_cast<const VecT*>(kp + off);
          vr[t] = *reinterpret_cast<const VecT*>(vp + off);
        }
      }
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        if (t0 + t >= ntok) break;
        float kf[EPL], vf[EPL];
        unpack<EPL>(kr[t], kf);
        unpack<EPL>(vr[t], vf);
        float s[MAX_REP];
#pragma unroll
        for (int h = 0; h < MAX_REP; ++h) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d += qr[h][e] * kf[e];
          s[h] = d;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int h = 0; h < MAX_REP; ++h)
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
        }
#pragma unroll
        for (int h = 0; h < MAX_REP; ++h) {
          const float x = s[h] * scale;
          const float mn = fmaxf(m[h], x);
          const float alpha = expf(m[h] - mn);
          const float pr = expf(x - mn);
          l[h] = l[h] * alpha + pr;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h][e] = acc[h][e] * alpha + pr * vf[e];
          m[h] = mn;
        }
      }
    }
  }

  // Merge the four warps' partial softmax states.
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) {
    if (h >= nh) continue;
    if (lane == 0) {
      m_s[warp][h] = m[h];
      l_s[warp][h] = l[h];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_s[warp][h][lane * EPL + e] = acc[h][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * HD; i += THREADS) {
    const int h = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][h]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wgt = expf(m_s[w][h] - mx);
      lsum += l_s[w][h] * wgt;
      a += acc_s[w][h][d] * wgt;
    }
    const float l_safe = (lsum == 0.f) ? 1.f : lsum;  // idle row -> 0
    out[(static_cast<size_t>(b) * H + h0 + h) * HD + d] =
        __float2bfloat16(a / l_safe);
  }
}

template <int HD>
int launch_hd(const void* q, const void* kp, const void* vp,
              const void* tables, const void* pos, void* out, int B, int H,
              int KV, int page, int maxp, float scale, cudaStream_t st) {
  const int groups = (H / KV + MAX_REP - 1) / MAX_REP;
  const dim3 grid(groups, KV, B);
  paged_decode_kernel<HD><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<bf16*>(out), H, KV, page,
      maxp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, H, Hd] bf16; k/v pages [P, page, KV, Hd] bf16; tables [B, maxp]
// int32; pos [B] int32; out [B, H, Hd] bf16; all contiguous. Hd in
// {64, 128, 256}, any H that is a multiple of KV. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another shape).
int paged_decode_bf16(const void* q, const void* kp, const void* vp,
                      const void* tables, const void* pos, void* out, int B,
                      int H, int KV, int Hd, int page, int maxp, float scale,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  switch (Hd) {
    case 64:
      return launch_hd<64>(q, kp, vp, tables, pos, out, B, H, KV, page, maxp, scale, st);
    case 128:
      return launch_hd<128>(q, kp, vp, tables, pos, out, B, H, KV, page, maxp, scale, st);
    case 256:
      return launch_hd<256>(q, kp, vp, tables, pos, out, B, H, KV, page, maxp, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
