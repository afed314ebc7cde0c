// Online-softmax attention forward (flash attention) with GQA, causal and
// sliding-window masks, a per-row query offset and a per-batch KV row map.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (body _kernel), together with the GQA expansion of its ops.py
//   (_gqa_expand: query head h reads KV head h / n_rep, indexed here, never
//   materialised).
//
// Contract (same as the Pallas kernel): logits = q k^T * D^-1/2 in f32, a
// masked logit is -1e30, the running (max, denominator, f32 accumulator)
// is updated tile by tile, p is rounded to v's dtype before the PV product,
// and the output is acc / max(l, 1e-30) in q's dtype.  Query row i of a
// (batch, head) sits at position q_offset[b * Hq + h] + i on the KV
// timeline; without q_offset it is Skv - Sq + i, which is exactly the
// TPU kernel's function.  Extensions the serving path needs: q_offset per
// row (each decode lane at its own depth), kv_index (batch b reads KV row
// kv_index[b] of a slot pool), any Sq and Skv (the TPU kernel asserts
// divisibility), and strided 4-D views [B, H, S, D] so the model's
// [B, S, H, D] activations and KV cache are read where they lie.
//
// What bounds it on an H100: decode (Sq = 1) reads each visible K/V row
// once and does 4 flops per byte of bf16 K/V: memory and launch latency.
// Prefill at qwen3-14b's shape (40 heads, 128 queries, 128 visible keys,
// D 128) is ~0.17 GFLOP per layer; the tensor cores would finish it in
// well under a microsecond, so launch latency bounds it here too.
//
// What the design does about it: one block per (query tile of 16 rows,
// batch x KV head).  The rows of a tile run over the n_rep query heads that
// share the KV head and over the query positions (row m = r * Sq + i), so
// one K/V tile in shared memory serves every head of the group: decode
// reads the cache once per KV head, not n_rep times.  The block walks only
// the KV tiles that some row of it can see (causal end, window start), so
// a decode lane at depth pos reads pos + 1 keys of its max_seq cache.  If
// some row of the tile sees no key at all (the reference then returns the
// mean of v), the block walks every tile, which gives that row the same
// answer.  A tile's loads are all issued before its shared stores, 16
// bytes each where the rows are aligned (the cache always is).  SIMT f32
// arithmetic with K padded in shared memory against bank conflicts;
// wgmma/TMA (FlashAttention-3) is later work.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // 16 rows x 8 lanes
constexpr int kBQ = 16;         // query rows per block
constexpr int kBK = 32;         // keys per KV tile
constexpr float kMasked = -1e30f;

struct View {                   // element strides of a [B, H, S, D] view
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  View sq, sk, sv, so;
  const int32_t* q_offset;      // [B * Hq] or null
  const int32_t* kv_index;      // [B] or null
  int hq, hkv, n_rep, len_q, len_kv;
  int causal, window;           // window <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element i of 16 bytes holding f32 or bf16 values (little-endian: a bf16
// pair's first element is the low half of its word).
__device__ __forceinline__ uint32_t word(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}
template <typename T>
__device__ __forceinline__ float unpack(const uint4& c, int i);
template <>
__device__ __forceinline__ float unpack<float>(const uint4& c, int i) {
  return __uint_as_float(word(c, i));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint4& c, int i) {
  const uint32_t w = word(c, i / 2);
  return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
}

// Stage one tile of kBK keys of K and V into shared memory as f32.  Every
// global load of a thread is issued before its first shared store, so a
// tile costs about one memory latency rather than one per element; with
// kVec (16-byte aligned rows, checked by the launcher) each load moves 16
// bytes.
template <typename T, int D, bool kVec>
__device__ __forceinline__ void load_tile(const T* kb, const T* vb,
                                          long long k_stride,
                                          long long v_stride, int k0,
                                          int len_kv, float* ks, float* vs) {
  constexpr int kW = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kPerRow = D / kW;
  constexpr int kLoads = kBK * kPerRow;
  constexpr int kPer = (kLoads + kThreads - 1) / kThreads;
  using Raw = typename std::conditional<kVec, uint4, T>::type;
  Raw kc[kPer], vc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    const int kp = k0 + idx / kPerRow;
    const int e = (idx % kPerRow) * kW;
    if (idx < kLoads && kp < len_kv) {
      kc[c] = *reinterpret_cast<const Raw*>(kb + kp * k_stride + e);
      vc[c] = *reinterpret_cast<const Raw*>(vb + kp * v_stride + e);
    }
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int idx = threadIdx.x + c * kThreads;
    if (idx < kLoads) {
      const int j = idx / kPerRow, e = (idx % kPerRow) * kW;
      const bool in = k0 + j < len_kv;
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        float kx = 0.f, vx = 0.f;
        if (in) {
          if constexpr (kVec) {
            kx = unpack<T>(kc[c], i);
            vx = unpack<T>(vc[c], i);
          } else {
            kx = to_f32(kc[c]);
            vx = to_f32(vc[c]);
          }
        }
        ks[j * (D + 1) + e + i] = kx;
        vs[j * D + e + i] = vx;
      }
    }
  }
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK + 1]
  __shared__ int row_pos[kBQ];
  __shared__ int row_ok[kBQ];
  __shared__ int lo_all, hi_all, all_see;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.hkv;
  const int kvh = blockIdx.y % p.hkv;
  const int m0 = blockIdx.x * kBQ;
  const int n_rows = p.n_rep * p.len_q;
  const int kvb = p.kv_index ? p.kv_index[b] : b;
  const T* kb = static_cast<const T*>(p.k) + kvb * p.sk.b + kvh * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + kvb * p.sv.b + kvh * p.sv.h;

  if (tid == 0) {
    lo_all = INT_MAX;
    hi_all = -1;
    all_see = 1;
  }
  __syncthreads();
  if (tid < kBQ) {
    const int m = m0 + tid;
    const int ok = m < n_rows;
    int pos = 0;
    if (ok) {
      const int h = kvh * p.n_rep + m / p.len_q;
      const int off =
          p.q_offset ? p.q_offset[b * p.hq + h] : p.len_kv - p.len_q;
      pos = off + m % p.len_q;
      const int hi = p.causal ? min(pos, p.len_kv - 1) : p.len_kv - 1;
      const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
      if (lo > hi) {
        atomicExch(&all_see, 0);       // this row sees no key
      } else {
        atomicMin(&lo_all, lo);
        atomicMax(&hi_all, hi);
      }
    }
    row_pos[tid] = pos;
    row_ok[tid] = ok;
  }
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D;
    const int m = m0 + rr;
    float x = 0.f;
    if (m < n_rows) {
      const int h = kvh * p.n_rep + m / p.len_q;
      x = to_f32(static_cast<const T*>(p.q)[b * p.sq.b + h * p.sq.h +
                                            (m % p.len_q) * p.sq.s + d]);
    }
    qs[rr * (D + 1) + d] = x;
  }
  __syncthreads();

  int kv_lo = 0, kv_hi = p.len_kv;
  if (all_see) {
    kv_lo = lo_all / kBK * kBK;
    kv_hi = hi_all + 1;
  }

  const int row = tid >> 3;
  const int lane = tid & 7;
  const int pos = row_pos[row];
  float m_run = kMasked, l_run = 0.f;
  float acc[D / 8];
#pragma unroll
  for (int a = 0; a < D / 8; ++a) acc[a] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    load_tile<T, D, kVec>(kb, vb, p.sk.s, p.sv.s, k0, p.len_kv, ks, vs);
    __syncthreads();

    float s[kBK / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
      const int j = lane + 8 * c;
      const float* qr = qs + row * (D + 1);
      const float* kr = ks + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      dot *= p.scale;
      const int kp = k0 + j;
      if (kp >= p.len_kv) {
        dot = -INFINITY;               // past the end: weighs nothing
      } else {
        bool see = !p.causal || pos >= kp;
        if (p.window > 0) see = see && pos - kp < p.window;
        if (!see) dot = kMasked;
      }
      s[c] = dot;
      mx = fmaxf(mx, dot);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 8; ++c) {
      const float pc = expf(s[c] - m_new);
      psum += pc;
      ps[row * (kBK + 1) + lane + 8 * c] = to_f32(from_f32<T>(pc));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 4);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float corr = expf(m_run - m_new);
    l_run = corr * l_run + psum;
    m_run = m_new;
    __syncwarp();                      // a row's p is written by its warp

    float pv[D / 8];
#pragma unroll
    for (int a = 0; a < D / 8; ++a) pv[a] = 0.f;
    for (int j = 0; j < kBK; ++j) {
      const float pj = ps[row * (kBK + 1) + j];
#pragma unroll
      for (int a = 0; a < D / 8; ++a) pv[a] += pj * vs[j * D + lane + 8 * a];
    }
#pragma unroll
    for (int a = 0; a < D / 8; ++a) acc[a] = acc[a] * corr + pv[a];
    __syncthreads();                   // before the next tile overwrites
  }

  if (row_ok[row]) {
    const int m = m0 + row;
    const int h = kvh * p.n_rep + m / p.len_q;
    T* orow = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h +
              (m % p.len_q) * p.so.s;
    const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int a = 0; a < D / 8; ++a) {
      orow[lane + 8 * a] = from_f32<T>(acc[a] / denom);
    }
  }
}

// K and V rows start on 16-byte boundaries: every base and stride is a
// multiple of 16 bytes.
template <typename T>
bool rows_aligned(const Params& p, int d) {
  const long long n = 16 / static_cast<long long>(sizeof(T));
  const long long strides[] = {p.sk.b, p.sk.h, p.sk.s, p.sv.b, p.sv.h,
                               p.sv.s, static_cast<long long>(d)};
  for (long long x : strides) {
    if (x % n != 0) return false;
  }
  return reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = rows_aligned<T>(p, D) ? flash_attention_kernel<T, D, true>
                                      : flash_attention_kernel<T, D, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_rows = p.n_rep * p.len_q;
  const dim3 grid((n_rows + kBQ - 1) / kBQ, batch * p.hkv);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, const void* q_offset, const void* kv_index,
    int batch, int hq, int hkv, int len_q, int len_kv, int d, int causal,
    int window, float scale, int dtype, void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || len_q < 0 || len_kv < 1 ||
      batch * hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (len_q == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  View* views[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) {
    views[i]->b = strides[3 * i];
    views[i]->h = strides[3 * i + 1];
    views[i]->s = strides[3 * i + 2];
  }
  p.q_offset = static_cast<const int32_t*>(q_offset);
  p.kv_index = static_cast<const int32_t*>(kv_index);
  p.hq = hq;
  p.hkv = hkv;
  p.n_rep = hq / hkv;
  p.len_q = len_q;
  p.len_kv = len_kv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, batch, d, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
