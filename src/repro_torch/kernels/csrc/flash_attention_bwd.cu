// Backward of flash_attention.cu's attention (GQA, causal and sliding
// window; query row i at Skv - Sq + i, the training call's placement).
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel and
// differentiates its jnp flash loop (src/repro/models/attention.py
// blocked_attention).  This is the gradient jax.grad takes through it,
// for the port's training path, where the forward is the flash_attention
// kernel.
//
// Contract: the plain version flash_attention_bwd_ref
// (flash_attention/ref.py).  With s = q k^T / sqrt(D) in f32 (masked:
// -1e30), p = exp(s - rowmax), l = rowsum(p), P = p / l and P_v = p
// rounded to v's dtype over l (the forward's PV operand):
//   dV = P_v^T dO,  dS = P * (dO V^T - rowsum(dO * O)) on visible keys,
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
// a KV head's dK and dV summed over its n_rep query heads.  q, o, do, dq
// [B, Hq, Sq, D] and k, v, dk, dv [B, Hkv, Skv, D], contiguous, all f32
// or all bf16; D a multiple of 4 up to 256 (the forward's head sizes).
//
// What bounds it: at hymba-1.5b's training shape (q [1, 25, 128, 64]
// bf16, 5 KV heads) the function moves ~1.3 MB (0.4 us at HBM rate) and
// needs ~10 MFLOP of products (0.01 us at the bf16 peak): launch latency
// and the sequential tile loops of few blocks, not the card's rates.
//
// Design (FlashAttention-2's backward, arXiv:2307.08691 Algorithm 2, as a
// simple SIMT body; wgmma and TMA wait for a redesign):
//  1. flash_attention_bwd_dq_kernel, a block per (batch, query head, 16
//     query rows): a first walk over the KV tiles the rows can see (32
//     keys each) takes each row's max and sum online, as the forward
//     would (recomputed from q and k, so the tuned forward is untouched);
//     with D_i = rowsum(dO * O) they go to scratch.  A second walk forms
//     dS = P * (dO V^T - D_i) tile by tile and accumulates dQ.
//  2. flash_attention_bwd_dkv_kernel, a block per (query head, batch, KV
//     head, 32 keys): walks the query tiles that can see its keys,
//     recomputes P and dS from the scratch statistics, and accumulates
//     that query head's share of dK and dV into scratch;
//     flash_attention_bwd_reduce_kernel sums each KV head's n_rep shares
//     in head order.  (A block per KV tile walking all n_rep heads left
//     20 blocks at hymba's shape and took 0.4-0.5 ms.)  Each output
//     element has one owner thread, summing in a fixed order: no float
//     atomics, two calls give the same bits.
// Tiles live in shared memory as f32 with rows padded to D + 1 floats (a
// warp reading 32 keys' column d meets 32 banks); accumulators live in
// shared memory, one thread an element.  A row that sees no key (causal,
// Sq > Skv) gets p = 1 on every key, as the plain version's, so blocks
// holding one walk every tile.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kRows = 16;                  // query rows a tile
constexpr int kKeys = 32;                  // keys a tile
constexpr int kSPad = kKeys + 1;
constexpr int kMaxD = 256;

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;                            // [3][B * Hq * Sq]: m, l, D_i
  float* parts;                            // [n_rep][2][B, Hkv, Skv, D]
  int batch, hq, hkv, n_rep, len_q, len_kv, d, causal, window;
  float scale;
};

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void st(bf16* p, long long i, float x) {
  p[i] = __float2bfloat16(x);
}
// p as the forward's PV product takes it: rounded to v's dtype
__device__ __forceinline__ float as_operand(float x, const float*) {
  return x;
}
__device__ __forceinline__ float as_operand(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int kk) {
  const int qp = p.len_kv - p.len_q + i;
  return (!p.causal || qp >= kk) && (p.window <= 0 || qp - kk < p.window);
}

// Can some row of the query tile at i0 see some key of the KV tile at
// k0?  A tile holding a row that sees no key meets every KV tile.
__device__ __forceinline__ bool tiles_meet(const Params& p, int i0, int k0) {
  const int off = p.len_kv - p.len_q;
  const int i1 = min(i0 + kRows, p.len_q) - 1;
  const int k1 = min(k0 + kKeys, p.len_kv) - 1;
  if (p.causal && off + i0 < 0) return true;
  if (p.causal && k0 > off + i1) return false;
  if (p.window > 0 && off + i0 - k1 >= p.window) return false;
  return true;
}

// rows [r0, r0 + n_rows) of a [S, d] matrix at base into a padded f32
// tile
template <typename T>
__device__ void load_rows(float* dst, const T* src, long long base, int r0,
                          int n_rows, int limit, int d) {
  const int dp = d + 1;
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads) {
    const int row = e / d, c = e - row * d;
    dst[row * dp + c] =
        r0 + row < limit
            ? ld(src, base + static_cast<long long>(r0 + row) * d + c)
            : 0.f;
  }
}

// a . b over d floats of shared memory (d a multiple of 4), in four
// independent sums so the loads are not one chain of waits
__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    x0 += a[c] * b[c];
    x1 += a[c + 1] * b[c + 1];
    x2 += a[c + 2] * b[c + 2];
    x3 += a[c + 3] * b[c + 3];
  }
  return (x0 + x1) + (x2 + x3);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d, dp = d + 1;
  float* qs = smem;                        // [kRows][dp]
  float* dos = qs + kRows * dp;            // [kRows][dp]
  float* ks = dos + kRows * dp;            // [kKeys][dp]
  float* vs = ks + kKeys * dp;             // [kKeys][dp]
  float* ss = vs + kKeys * dp;             // [kRows][kSPad] dS
  float* acc = ss + kRows * kSPad;         // [kRows][d] dQ
  float* di_s = acc + kRows * d;           // [kRows]

  const int q_tiles = (p.len_q + kRows - 1) / kRows;
  const int bhq = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x - bhq * q_tiles) * kRows;
  const int b = bhq / p.hq, h = bhq - b * p.hq, g = h / p.n_rep;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long q_base = static_cast<long long>(bhq) * p.len_q * d;
  const long long kv_base =
      (static_cast<long long>(b) * p.hkv + g) * p.len_kv * d;
  const T* q = static_cast<const T*>(p.q);
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  load_rows(qs, q, q_base, i0, kRows, p.len_q, d);
  load_rows(dos, dout, q_base, i0, kRows, p.len_q, d);
  for (int e = threadIdx.x; e < kRows * d; e += kThreads) acc[e] = 0.f;
  __syncthreads();
  // D_i = rowsum(dO * O): warp w takes rows w, w + 4, w + 8, w + 12
  for (int m = 0; m < kRows / 4; ++m) {
    const int row = warp + 4 * m, i = i0 + row;
    float x = 0.f;
    if (i < p.len_q) {
      for (int c = lane; c < d; c += kWarp) {
        x += dos[row * dp + c] *
             ld(o, q_base + static_cast<long long>(i) * d + c);
      }
    }
    x = warp_sum(x);
    if (lane == 0) di_s[row] = x;
  }

  // the KV tiles these rows can see
  const int off = p.len_kv - p.len_q;
  const int i_last = min(i0 + kRows, p.len_q) - 1;
  int k_lo = 0, k_hi = p.len_kv;
  if (!(p.causal && off + i0 < 0)) {
    if (p.causal) k_hi = min(p.len_kv, off + i_last + 1);
    if (p.window > 0) k_lo = max(0, off + i0 - p.window + 1);
  }
  k_lo = k_lo / kKeys * kKeys;

  // walk 1: each row's max and sum, online (a warp's lanes all hold the
  // running values of its four rows)
  float mr[kRows / 4], lr[kRows / 4];
#pragma unroll
  for (int m = 0; m < kRows / 4; ++m) {
    mr[m] = -INFINITY;
    lr[m] = 0.f;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += kKeys) {
    __syncthreads();
    load_rows(ks, k, kv_base, k0, kKeys, p.len_kv, d);
    __syncthreads();
    const int kk = k0 + lane;
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m) {
      const int row = warp + 4 * m;
      float s = dot(qs + row * dp, ks + lane * dp, d) * p.scale;
      if (kk >= p.len_kv) {
        s = -INFINITY;
      } else if (!visible(p, i0 + row, kk)) {
        s = kMasked;
      }
      const float m_new = fmaxf(mr[m], warp_max(s));
      lr[m] = lr[m] * expf(mr[m] - m_new) + warp_sum(expf(s - m_new));
      mr[m] = m_new;
    }
  }
  const long long n_rows = static_cast<long long>(p.batch) * p.hq * p.len_q;
#pragma unroll
  for (int m = 0; m < kRows / 4; ++m) {
    lr[m] = fmaxf(lr[m], 1e-30f);
    const int row = warp + 4 * m, i = i0 + row;
    if (lane == 0 && i < p.len_q) {
      const long long at = static_cast<long long>(bhq) * p.len_q + i;
      p.stats[at] = mr[m];
      p.stats[n_rows + at] = lr[m];
      p.stats[2 * n_rows + at] = di_s[row];
    }
  }

  // walk 2: dS tile by tile, dQ += dS K
  for (int k0 = k_lo; k0 < k_hi; k0 += kKeys) {
    __syncthreads();
    load_rows(ks, k, kv_base, k0, kKeys, p.len_kv, d);
    load_rows(vs, v, kv_base, k0, kKeys, p.len_kv, d);
    __syncthreads();
    const int kk = k0 + lane;
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m) {
      const int row = warp + 4 * m;
      float ds = 0.f;
      if (kk < p.len_kv && visible(p, i0 + row, kk)) {
        const float s = dot(qs + row * dp, ks + lane * dp, d) * p.scale;
        const float pn = expf(s - mr[m]) / lr[m];
        const float dpv = dot(dos + row * dp, vs + lane * dp, d);
        ds = pn * (dpv - di_s[row]);
      }
      ss[row * kSPad + lane] = ds;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
      const int row = e / d, c = e - row * d;
      float x = acc[e];
      for (int j = 0; j < kKeys; ++j) x += ss[row * kSPad + j] * ks[j * dp + c];
      acc[e] = x;
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(p.dq);
  for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
    const int row = e / d, c = e - row * d;
    if (i0 + row < p.len_q) {
      st(dq, q_base + static_cast<long long>(i0 + row) * d + c,
         acc[e] * p.scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d, dp = d + 1;
  float* ks = smem;                        // [kKeys][dp]
  float* vs = ks + kKeys * dp;             // [kKeys][dp]
  float* qs = vs + kKeys * dp;             // [kRows][dp]
  float* dos = qs + kRows * dp;            // [kRows][dp]
  float* ps = dos + kRows * dp;            // [kRows][kSPad] P_v
  float* dss = ps + kRows * kSPad;         // [kRows][kSPad] dS
  float* dk_acc = dss + kRows * kSPad;     // [kKeys][d]
  float* dv_acc = dk_acc + kKeys * d;      // [kKeys][d]
  float* st_s = dv_acc + kKeys * d;        // [3][kRows]: m, l, D_i

  // blockIdx.x = (r * B * Hkv + bkv) * k_tiles + key tile: query head r
  // of the KV head's group
  const int k_tiles = (p.len_kv + kKeys - 1) / kKeys;
  const int q_tiles = (p.len_q + kRows - 1) / kRows;
  const int n_kv = p.batch * p.hkv;
  const int rk = blockIdx.x / k_tiles;
  const int r = rk / n_kv, bkv = rk - r * n_kv;
  const int k0 = (blockIdx.x - rk * k_tiles) * kKeys;
  const int b = bkv / p.hkv, g = bkv - b * p.hkv;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long kv_base = static_cast<long long>(bkv) * p.len_kv * d;
  const long long n_rows = static_cast<long long>(p.batch) * p.hq * p.len_q;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const T* vtyped = static_cast<const T*>(p.v);

  load_rows(ks, static_cast<const T*>(p.k), kv_base, k0, kKeys,
               p.len_kv, d);
  load_rows(vs, vtyped, kv_base, k0, kKeys, p.len_kv, d);
  for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }
  const int kk = k0 + lane;
  {
    const int bhq = b * p.hq + g * p.n_rep + r;
    const long long q_base = static_cast<long long>(bhq) * p.len_q * d;
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int i0 = qt * kRows;
      if (!tiles_meet(p, i0, k0)) continue;
      __syncthreads();
      load_rows(qs, q, q_base, i0, kRows, p.len_q, d);
      load_rows(dos, dout, q_base, i0, kRows, p.len_q, d);
      if (threadIdx.x < kRows) {
        const int i = i0 + threadIdx.x;
        const long long at = static_cast<long long>(bhq) * p.len_q + i;
        const bool in = i < p.len_q;       // rows past Sq: zero q and dO
        st_s[threadIdx.x] = in ? p.stats[at] : 0.f;
        st_s[kRows + threadIdx.x] = in ? p.stats[n_rows + at] : 1.f;
        st_s[2 * kRows + threadIdx.x] = in ? p.stats[2 * n_rows + at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const int row = warp + 4 * m;
        float pv = 0.f, ds = 0.f;
        if (kk < p.len_kv) {
          const bool vis = visible(p, i0 + row, kk);
          const float s = dot(qs + row * dp, ks + lane * dp, d) * p.scale;
          const float e = expf((vis ? s : kMasked) - st_s[row]);
          const float l = st_s[kRows + row];
          pv = as_operand(e, vtyped) / l;
          if (vis) {
            const float dpv = dot(dos + row * dp, vs + lane * dp, d);
            ds = e / l * (dpv - st_s[2 * kRows + row]);
          }
        }
        ps[row * kSPad + lane] = pv;
        dss[row * kSPad + lane] = ds;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
        const int j = e / d, c = e - j * d;
        float xv = dv_acc[e], xk = dk_acc[e];
        for (int row = 0; row < kRows; ++row) {
          xv += ps[row * kSPad + j] * dos[row * dp + c];
          xk += dss[row * kSPad + j] * qs[row * dp + c];
        }
        dv_acc[e] = xv;
        dk_acc[e] = xk;
      }
    }
  }
  // this query head's share, to scratch; the reduce kernel sums the
  // group's shares in head order
  const long long plane = static_cast<long long>(n_kv) * p.len_kv * d;
  float* dk_part = p.parts + (2LL * r) * plane;
  float* dv_part = dk_part + plane;
  for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
    const int j = e / d, c = e - j * d;
    if (k0 + j < p.len_kv) {
      const long long at = kv_base + static_cast<long long>(k0 + j) * d + c;
      dk_part[at] = dk_acc[e];
      dv_part[at] = dv_acc[e];
    }
  }
}

// dK and dV: each element the sum of its group's n_rep shares, in head
// order, dK scaled by 1 / sqrt(D); one thread an element.
template <typename T>
__global__ void flash_attention_bwd_reduce_kernel(Params p) {
  const long long plane =
      static_cast<long long>(p.batch) * p.hkv * p.len_kv * p.d;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= plane) return;
  float xk = 0.f, xv = 0.f;
  for (int r = 0; r < p.n_rep; ++r) {
    xk += p.parts[2LL * r * plane + e];
    xv += p.parts[(2LL * r + 1) * plane + e];
  }
  st(static_cast<T*>(p.dk), e, xk * p.scale);
  st(static_cast<T*>(p.dv), e, xv);
}

constexpr int dq_smem(int d) {
  return ((2 * kRows + 2 * kKeys) * (d + 1) + kRows * kSPad + kRows * d +
          kRows) * static_cast<int>(sizeof(float));
}
constexpr int dkv_smem(int d) {
  return ((2 * kRows + 2 * kKeys) * (d + 1) + 2 * kRows * kSPad +
          2 * kKeys * d + 3 * kRows) * static_cast<int>(sizeof(float));
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const cudaError_t set = repro::once_per_device([] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem(kMaxD));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                dkv_smem(kMaxD));
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long q_blocks = static_cast<long long>(p.batch) * p.hq *
                             ((p.len_q + kRows - 1) / kRows);
  const long long kv_blocks = static_cast<long long>(p.n_rep) * p.batch *
                              p.hkv * ((p.len_kv + kKeys - 1) / kKeys);
  const long long kv_elems =
      static_cast<long long>(p.batch) * p.hkv * p.len_kv * p.d;
  if (q_blocks >= (1LL << 31) || kv_blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_bwd_dq_kernel<T>
      <<<static_cast<unsigned>(q_blocks), kThreads, dq_smem(p.d), stream>>>(
          p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dkv_kernel<T>
      <<<static_cast<unsigned>(kv_blocks), kThreads, dkv_smem(p.d), stream>>>(
          p);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  flash_attention_bwd_reduce_kernel<T>
      <<<static_cast<unsigned>((kv_elems + 255) / 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: 3 * batch * hq * len_q floats (each row's max, sum and D_i),
// then 2 * hq * batch * len_kv * d (each query head's share of dK and dV;
// hq = n_rep * hkv).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* scratch,
    int batch, int hq, int hkv, int len_q, int len_kv, int d, int causal,
    int window, int dtype, float scale, void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || len_q < 1 || len_kv < 1 ||
      d < 4 || d > kMaxD || d % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* stats = static_cast<float*>(scratch);
  float* parts = stats + 3LL * batch * hq * len_q;
  Params p{q, k, v, o, dout, dq, dk, dv, stats, parts, batch, hq, hkv,
           hq / hkv, len_q, len_kv, d, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, s) : launch<bf16>(p, s);
}
