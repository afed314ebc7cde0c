// Online-softmax attention forward (flash attention) with GQA, causal and
// sliding-window masks, a per-row query offset and a per-batch KV row map.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:108 flash_attention
//   (body _kernel), together with the GQA expansion of its ops.py
//   (_gqa_expand: query head h reads KV head h / n_rep, indexed here, never
//   materialised).
//
// Contract (same as the Pallas kernel): logits = q k^T * D^-1/2 in f32, a
// masked logit is -1e30, the running (max, denominator, f32 accumulator)
// is updated tile by tile, p is rounded to v's dtype before the PV product,
// and the output is acc / max(l, 1e-30) in q's dtype.  Query row i of a
// (batch, head) sits at q_offset[b * qo_b + h * qo_h] + i on the KV
// timeline (qo_h = 0: one offset per batch row); without q_offset it is
// Skv - Sq + i, which is exactly the TPU kernel's function.  Extensions
// the serving path needs: a query offset per lane (each decode lane at its
// own depth), kv_index (batch b reads KV row kv_index[b] of a slot pool),
// any Sq and Skv (the TPU kernel asserts divisibility), and strided 4-D
// views [B, H, S, D] so the model's [B, S, H, D] activations and KV cache
// are read where they lie.  A row that sees no key gets the mean of v
// over every key, as the plain version gives it.
//
// Rows.  A block's query rows run over the n_rep query heads that share
// one KV head and over the query positions (row m = r * Sq + i), so one
// K/V tile serves every head of the group and the cache is read once per
// KV head, not n_rep times.  A block walks only the KV tiles that some row
// of it can see (causal end, window start); if some row sees no key at
// all, it walks every tile, which gives that row the plain version's
// answer.
//
// Three bodies, chosen by the launcher:
//
// 1. bf16 decode (n_rep * Sq <= 16 rows per KV head: the serve round, 5
//    rows of 40 heads over 8).  Bound by bytes: 4 flops per byte of K/V,
//    and at depth 144 of qwen3-14b's pool 4.9 MB in all, 1.5 us at HBM
//    rate; a block per KV head, the earlier form, used 64 blocks of 132
//    SMs and took 33 us.  Split-KV ("flash decoding"): the grid is
//    n_split x B * Hkv blocks on axis x, a thread-block cluster of the
//    n_split consecutive blocks of each (lane, KV head).  The host cannot know a lane's depth without a
//    sync (q_offset lies on the card), so each block finds from the
//    offsets, mask and window which 32-key tiles its rows see and takes
//    its share of them (the wrapper picks n_split, at most 8, so that the
//    grid fills the card: 5 at the serve shape, 320 blocks, all working
//    at depth 144).  A working block copies its tiles of K and V with
//    16-byte cp.async into a ring of two stages, takes the logits with a
//    lane per key (K rows padded so the lanes' 16-byte loads meet no bank
//    twice, q broadcast from shared memory, f32 from bf16 pairs), runs the
//    online softmax of each row in its warp's registers (shuffle max and
//    sum), and keeps (m, l, acc) in f32 in shared memory.  The partials
//    merge by log-sum-exp in the same launch through distributed shared
//    memory: after a cluster barrier each block reads the others' (m, l,
//    acc) and writes its share of the output.  (A merge through global
//    scratch and an atomic ticket, three round trips to L2, was the
//    largest part of the launch.)
// 2. bf16 prefill (more rows).  Bound by launch latency and then the
//    tensor cores: 0.17 GFLOP per qwen3-14b layer is 0.17 us at the bf16
//    peak.  wgmma (sm_90a) on 64-row Q tiles, one warpgroup a block:
//    S = Q K^T with Q and K in shared memory (K-major), P from the S
//    accumulator to registers as bf16 (the A operand, no shared round
//    trip), O += P V with V read MN-major through its descriptor (no
//    transpose).  With lse given (the training forward; null on every
//    serving call) each row's log-sum-exp, m + log l, goes there for the
//    backward.  Tiles of 64 keys (32 at D 256, for registers) arrive by
//    16-byte cp.async into a two-stage ring of swizzled tiles (128-, 64-
//    or 32-byte swizzle, the widest that divides D: 160 takes 64).  TMA
//    would need a tensor map per tensor and call, encoded on the host,
//    and the slot pool's rows depend on kv_index on the card; on a
//    host-bound serve round the encode costs more than the copy engine
//    saves, so the block computes its own addresses.
// 3. f32 (the serve phases' float32 checks only): SIMT, as before, since
//    the tensor cores would round its inputs to TF32 and miss the 2e-5
//    the checks hold it to.  16-row tiles of 32 keys in shared memory,
//    loads batched before the stores.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it), no spills in any
// body; registers for D = 16, 32, 64, 128, 160, 256, static shared
// memory, and the dynamic shared memory the launcher asks for:
//   decode   95, 90, 96, 96, 95, 96; 272 B; 384 D + 3136 B (52,288 at 128)
//   prefill  109, 117, 132, 168, 188, 216; 272 B; 1024 + 640 D B at
//            D <= 160 (82,944 at 128), 99,328 B at 256
//   f32      56 to 165; 80 B; 320 D + 2304 B

#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "per_device.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;

struct View {                   // element strides of a [B, H, S, D] view
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  View sq, sk, sv, so;
  const int32_t* q_offset;      // q_offset[b * qo_b + h * qo_h], or null
  long long qo_b, qo_h;
  const int32_t* kv_index;      // [B] or null
  float* lse;                   // prefill body: each row's log-sum-exp of
                                // its logits, [B, Hq, Sq] f32, or null
  int hkv, n_rep, len_q, len_kv;
  int causal, window;           // window <= 0: none
  float scale;
  int n_split;                  // decode: blocks (one cluster) per (batch
                                // row, KV head)
  int per_bh;                   // consecutive blocks on grid x per (batch
                                // row, KV head): n_split or the row tiles
};

// Grid x holds every block, per_bh consecutive ones for each (batch row,
// KV head) (x reaches 2^31 - 1; y would stop B * Hkv at 65,535): this
// block's (batch row, KV head) index and its place among their blocks.
__device__ __forceinline__ int block_bh(const Params& p) {
  return static_cast<int>(blockIdx.x) / p.per_bh;
}
__device__ __forceinline__ int block_sub(const Params& p) {
  return static_cast<int>(blockIdx.x) % p.per_bh;
}

__device__ __forceinline__ int row_pos(const Params& p, int b, int m) {
  const int h = m / p.len_q;    // head within the group, query index
  const int i = m - h * p.len_q;
  const int hh = block_bh(p) % p.hkv * p.n_rep + h;
  const int off = p.q_offset ? p.q_offset[b * p.qo_b + hh * p.qo_h]
                             : p.len_kv - p.len_q;
  return off + i;
}

__device__ __forceinline__ bool sees(const Params& p, int pos, int kp) {
  bool see = !p.causal || pos >= kp;
  if (p.window > 0) see = see && pos - kp < p.window;
  return see;
}

// Rows m0 .. m0 + count - 1 (those below n_rep * Sq) of this block's batch
// row and KV head: each row's position into pos_s, and into span the
// union of their visible keys [span[0], span[1]], or every key if some
// row sees none.  Ends with a barrier.
__device__ void visible_span(const Params& p, int b, int m0, int count,
                             int* pos_s, int* span) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = -1;
    span[2] = 1;
  }
  __syncthreads();
  if (tid < count) {
    const int m = m0 + tid;
    int pos = 0;
    if (m < p.n_rep * p.len_q) {
      pos = row_pos(p, b, m);
      const int hi = p.causal ? min(pos, p.len_kv - 1) : p.len_kv - 1;
      const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
      if (lo > hi) {
        atomicExch(&span[2], 0);       // this row sees no key
      } else {
        atomicMin(&span[0], lo);
        atomicMax(&span[1], hi);
      }
    }
    pos_s[tid] = pos;
  }
  __syncthreads();
  if (tid == 0 && !span[2]) {
    span[0] = 0;
    span[1] = p.len_kv - 1;
  }
  __syncthreads();
}

using wgmma::cp_async16;
using wgmma::cp_async_commit;
using wgmma::cp_async_wait;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ const bf16* kv_base(const Params& p, const void* t,
                                               const View& s, int b,
                                               int kvh) {
  const int kvb = p.kv_index ? p.kv_index[b] : b;
  return static_cast<const bf16*>(t) + kvb * s.b + kvh * s.h;
}

__device__ __forceinline__ bf16* out_row(const Params& p, int b, int m) {
  const int h = m / p.len_q;
  const int hh = block_bh(p) % p.hkv * p.n_rep + h;
  return static_cast<bf16*>(p.o) + b * p.so.b + hh * p.so.h +
         (m - h * p.len_q) * p.so.s;
}

__device__ __forceinline__ const bf16* q_row(const Params& p, int b, int m) {
  const int h = m / p.len_q;
  const int hh = block_bh(p) % p.hkv * p.n_rep + h;
  return static_cast<const bf16*>(p.q) + b * p.sq.b + hh * p.sq.h +
         (m - h * p.len_q) * p.sq.s;
}

// ---------------------------------------------------------------------------
// 1. bf16 decode: split-KV, the visible tiles shared out over n_split blocks
// ---------------------------------------------------------------------------

constexpr int kDecRows = 16;    // at most n_rep * Sq rows
constexpr int kDecBK = 32;      // keys per tile: a lane per key
constexpr int kMaxSplit = 8;    // blocks per (batch row, KV head) at most:
                                // the portable cluster size

template <int D>
struct Dec {
  static constexpr int KP = D + 8;      // K row pitch: 16-byte loads by
                                        // lanes on 32 keys hit 32 banks
  static constexpr int SMEM = 2 * kDecRows * D * 4 +          // q, acc
                              kDecRows * (kDecBK + 1) * 4 +   // p
                              2 * kDecBK * KP * 2 + 2 * kDecBK * D * 2;
};

// One 32-key tile of K ([32][D + 8]) and V ([32][D]) into shared memory,
// zeros past the end.
template <int D>
__device__ __forceinline__ void dec_load(const bf16* kb, const bf16* vb,
                                         long long ks, long long vs, int k0,
                                         int len_kv, bf16* kd, bf16* vd) {
  constexpr int kRow = D / 8;   // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < kDecBK * kRow; idx += kThreads) {
    const int j = idx / kRow, e = (idx % kRow) * 8;
    const bool in = k0 + j < len_kv;
    const long long kp = in ? k0 + j : 0;
    cp_async16(kd + j * Dec<D>::KP + e, kb + kp * ks + e, in);
    cp_async16(vd + j * D + e, vb + kp * vs + e, in);
  }
}

// (A minimum of blocks per SM in the bounds, which shared memory allows
// anyway, keeps ptxas from a 4-byte spill at D 32.)
template <int D>
__global__ void __launch_bounds__(kThreads, 4)
flash_decode_kernel(const Params p) {
  using C = Dec<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);      // [16][D]
  float* acc = qs + kDecRows * D;                      // [16][D]
  float* ps = acc + kDecRows * D;                      // [16][33]
  bf16* ks = reinterpret_cast<bf16*>(ps + kDecRows * (kDecBK + 1));
  bf16* vs = ks + 2 * kDecBK * C::KP;                  // K [2][32][D + 8]
  __shared__ int pos_s[kDecRows];                      // V [2][32][D]
  __shared__ int span[3];
  __shared__ float m_s[kDecRows], l_s[kDecRows], corr_s[kDecRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = block_bh(p), b = bh / p.hkv, kvh = bh % p.hkv;
  const int rows = p.n_rep * p.len_q;
  const bf16* kb = kv_base(p, p.k, p.sk, b, kvh);
  const bf16* vb = kv_base(p, p.v, p.sv, b, kvh);
  for (int idx = tid; idx < kDecRows * D / 8; idx += kThreads) {
    const int r = idx / (D / 8), e = idx % (D / 8) * 8;
    uint4 q8 = make_uint4(0, 0, 0, 0);       // 8 bf16 of row r
    if (r < rows) q8 = *reinterpret_cast<const uint4*>(q_row(p, b, r) + e);
    float4* qd = reinterpret_cast<float4*>(qs + r * D + e);
    qd[0] = make_float4(__uint_as_float(q8.x << 16),
                        __uint_as_float(q8.x & 0xffff0000u),
                        __uint_as_float(q8.y << 16),
                        __uint_as_float(q8.y & 0xffff0000u));
    qd[1] = make_float4(__uint_as_float(q8.z << 16),
                        __uint_as_float(q8.z & 0xffff0000u),
                        __uint_as_float(q8.w << 16),
                        __uint_as_float(q8.w & 0xffff0000u));
    float4* ad = reinterpret_cast<float4*>(acc + r * D + e);
    ad[0] = ad[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < kDecRows) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  visible_span(p, b, 0, rows, pos_s, span);

  // the visible tiles, shared out as evenly as whole tiles allow
  const int t_lo = span[0] / kDecBK;
  const int n_tiles = span[1] / kDecBK - t_lo + 1;
  const int n_work = min(p.n_split, n_tiles);
  const int w = block_sub(p);
  const bool works = w < n_work;           // else: only the merge below
  const int t0 = t_lo + w * n_tiles / n_work;
  const int t1 = works ? t_lo + (w + 1) * n_tiles / n_work - 1 : t0 - 1;

  if (works) {
    dec_load<D>(kb, vb, p.sk.s, p.sv.s, t0 * kDecBK, p.len_kv, ks, vs);
  }
  cp_async_commit();

  constexpr int kPairs = D / 2;
  int stage = 0;
  for (int t = t0; t <= t1; ++t, stage ^= 1) {
    if (t < t1) {
      dec_load<D>(kb, vb, p.sk.s, p.sv.s, (t + 1) * kDecBK, p.len_kv,
                  ks + (stage ^ 1) * kDecBK * C::KP,
                  vs + (stage ^ 1) * kDecBK * D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + stage * kDecBK * C::KP;
    const bf16* vt = vs + stage * kDecBK * D;
    const int kp = t * kDecBK + lane;

    // logits: lane = key, warp w takes rows w, w + 4, w + 8, w + 12, with
    // the row's q read by every lane at once (a broadcast)
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    const uint4* kr = reinterpret_cast<const uint4*>(kt + lane * C::KP);
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      const uint4 k8 = kr[c];
      // bf16 -> f32 is exact: the bf16 bits are the f32's high half (the
      // first of a pair is the low half of its word)
      const float kf[8] = {
          __uint_as_float(k8.x << 16), __uint_as_float(k8.x & 0xffff0000u),
          __uint_as_float(k8.y << 16), __uint_as_float(k8.y & 0xffff0000u),
          __uint_as_float(k8.z << 16), __uint_as_float(k8.z & 0xffff0000u),
          __uint_as_float(k8.w << 16), __uint_as_float(k8.w & 0xffff0000u)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp + 4 * i;
        if (r < rows) {
          const float4* qr = reinterpret_cast<const float4*>(qs + r * D) +
                             2 * c;
          const float4 a = qr[0], z = qr[1];
          dot[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                    z.x * kf[4] + z.y * kf[5] + z.z * kf[6] + z.w * kf[7];
        }
      }
    }
    // the online softmax of each row over this tile's 32 keys, in the warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 4 * i;
      if (r < rows) {
        float sv = dot[i] * p.scale;
        if (kp >= p.len_kv) {
          sv = -INFINITY;              // past the end: weighs nothing
        } else if (!sees(p, pos_s[r], kp)) {
          sv = kMasked;
        }
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(sv));
        const float pr = expf(sv - m_new);
        const float psum = warp_sum(pr);
        ps[r * (kDecBK + 1) + lane] = __bfloat162float(__float2bfloat16(pr));
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[r] = corr;
          l_s[r] = corr * l_s[r] + psum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + p V, a thread per (row, pair of columns)
    for (int it = tid; it < rows * kPairs; it += kThreads) {
      const int r = it / kPairs, pi = it % kPairs;
      const float* pr = ps + r * (kDecBK + 1);
      float2 a = make_float2(0.f, 0.f);
#pragma unroll 8
      for (int j = 0; j < kDecBK; ++j) {
        const float2 v2 = __bfloat1622float2(
            reinterpret_cast<const bf162*>(vt + j * D)[pi]);
        a.x += pr[j] * v2.x;
        a.y += pr[j] * v2.y;
      }
      float2* ar = reinterpret_cast<float2*>(acc + r * D) + pi;
      const float corr = corr_s[r];
      float2 o = *ar;
      o.x = o.x * corr + a.x;
      o.y = o.y * corr + a.y;
      *ar = o;
    }
    __syncthreads();                 // before the next tile overwrites
  }

  // The merge, across the cluster of this (lane, KV head)'s blocks: every
  // partial (m, l, acc) stays in its block's shared memory, each block
  // reads the working blocks' through distributed shared memory and
  // writes its share of the output, weighting block w's partial for row
  // r by exp(m_w - m) / sum_w' exp(m_w' - m) l_w'.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                    // every partial is complete
  float* wts = ps;                   // [rows][33]: the weights
  if (tid < rows) {
    float mt = -INFINITY;
    for (int ww = 0; ww < n_work; ++ww) {
      mt = fmaxf(mt, *cluster.map_shared_rank(m_s + tid, ww));
    }
    float lt = 0.f;
    for (int ww = 0; ww < n_work; ++ww) {
      const float e = expf(*cluster.map_shared_rank(m_s + tid, ww) - mt);
      wts[tid * (kDecBK + 1) + ww] = e;
      lt += e * *cluster.map_shared_rank(l_s + tid, ww);
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    for (int ww = 0; ww < n_work; ++ww) wts[tid * (kDecBK + 1) + ww] *= inv;
  }
  __syncthreads();
  const int n_items = rows * kPairs;
  const int per = (n_items + p.n_split - 1) / p.n_split;
  const int end = min(n_items, (w + 1) * per);
  for (int it = w * per + tid; it < end; it += kThreads) {
    const int r = it / kPairs, pi = it % kPairs;
    float2 o = make_float2(0.f, 0.f);
    for (int ww = 0; ww < n_work; ++ww) {
      const float wt = wts[r * (kDecBK + 1) + ww];
      const float2 a = reinterpret_cast<const float2*>(
          cluster.map_shared_rank(acc, ww) + r * D)[pi];
      o.x += wt * a.x;
      o.y += wt * a.y;
    }
    reinterpret_cast<bf162*>(out_row(p, b, r))[pi] =
        __floats2bfloat162_rn(o.x, o.y);
  }
  cluster.sync();                    // no block leaves while read from
}

// ---------------------------------------------------------------------------
// 2. bf16 prefill: wgmma on 64-row Q tiles
// ---------------------------------------------------------------------------

constexpr int kPreRows = 64;

template <int D>
struct Pre {
  static constexpr int BK = D >= 256 ? 32 : 64;            // keys per tile
  static constexpr int SW = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int E = SW / 2;                         // bf16 per row
  static constexpr int Q_BYTES = kPreRows * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // Q, then stages (K, V) x 2; 1024 for aligning the base to the swizzle
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
};

using wgmma::sw_off;

template <int D>
__device__ __forceinline__ void pre_load_kv(const bf16* kb, const bf16* vb,
                                            long long ks, long long vs,
                                            int k0, int len_kv,
                                            unsigned char* kd,
                                            unsigned char* vd) {
  using C = Pre<D>;
  constexpr int kRow = D / 8;
  for (int idx = threadIdx.x; idx < C::BK * kRow; idx += kThreads) {
    const int j = idx / kRow, e = (idx % kRow) * 8;
    const bool in = k0 + j < len_kv;
    const long long kp = in ? k0 + j : 0;
    const uint32_t off = sw_off<C::SW>(j, e, C::BK);
    cp_async16(kd + off, kb + kp * ks + e, in);
    cp_async16(vd + off, vb + kp * vs + e, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const Params p) {
  using C = Pre<D>;
  constexpr int BK = C::BK, SW = C::SW, E = C::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = sm;
  unsigned char* kvs = sm + C::Q_BYTES;      // stage s: K at 2 s, V at 2 s + 1
  __shared__ int pos_s[kPreRows];
  __shared__ int span[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = block_bh(p) / p.hkv, kvh = block_bh(p) % p.hkv;
  const int m0 = block_sub(p) * kPreRows;
  const int n_rows = p.n_rep * p.len_q;
  const bf16* kb = kv_base(p, p.k, p.sk, b, kvh);
  const bf16* vb = kv_base(p, p.v, p.sv, b, kvh);
  {                                           // Q tile, zeros past n_rows
    constexpr int kRow = D / 8;
    for (int idx = tid; idx < kPreRows * kRow; idx += kThreads) {
      const int r = idx / kRow, e = (idx % kRow) * 8;
      const bool in = m0 + r < n_rows;
      cp_async16(qs + sw_off<SW>(r, e, kPreRows),
                 (in ? q_row(p, b, m0 + r) : static_cast<const bf16*>(p.q)) + e,
                 in);
    }
  }
  visible_span(p, b, m0, kPreRows, pos_s, span);
  const int kv_lo = span[0] / BK * BK, kv_hi = span[1] + 1;
  pre_load_kv<D>(kb, vb, p.sk.s, p.sv.s, kv_lo, p.len_kv, kvs,
                 kvs + C::KV_BYTES);
  cp_async_commit();                          // Q and the first K/V tile

  // this thread's two rows of the tile, and their positions
  const int r0 = warp * 16 + lane / 4;
  const int pos[2] = {pos_s[r0], pos_s[r0 + 8]};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};

  int stage = 0;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < kv_hi) {
      unsigned char* nk = kvs + (stage ^ 1) * 2 * C::KV_BYTES;
      pre_load_kv<D>(kb, vb, p.sk.s, p.sv.s, k0 + BK, p.len_kv, nk,
                     nk + C::KV_BYTES);
    }
    cp_async_commit();
    cp_async_wait<1>();
    wgmma::fence_async_shared();
    __syncthreads();
    const unsigned char* kt = kvs + stage * 2 * C::KV_BYTES;
    const unsigned char* vt = kt + C::KV_BYTES;

    // S = Q K^T, K in steps of 16 columns of D
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk * 16 / E, in = (kk * 16 % E) * 2;
      const uint64_t da = wgmma::desc(qs + atom * kPreRows * SW + in, 16,
                                      8 * SW, SW);
      const uint64_t db = wgmma::desc(kt + atom * BK * SW + in, 16, 8 * SW,
                                      SW);
      wgmma::wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) wgmma::hold(s[i]);

    // scale, mask and the online softmax of this thread's two rows
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
          float x = s[4 * j + 2 * ri + e] * p.scale;
          if (kp >= p.len_kv) {
            x = -INFINITY;
          } else if (!sees(p, pos[ri], kp)) {
            x = kMasked;
          }
          s[4 * j + 2 * ri + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[ri], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = expf(s[4 * j + 2 * ri + e] - m_new);
          s[4 * j + 2 * ri + e] = pe;
          psum += pe;
        }
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float corr = expf(m_run[ri] - m_new);
      l_run[ri] = corr * l_run[ri] + psum;
      m_run[ri] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * ri] *= corr;
        o[4 * j + 2 * ri + 1] *= corr;
      }
    }

    // O += P V: P from the S fragment as bf16, V MN-major, 16 keys a step
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bf162 h = __floats2bfloat162_rn(s[8 * t + 2 * g],
                                              s[8 * t + 2 * g + 1]);
        pa[t][g] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    wgmma::fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint64_t dv = wgmma::desc(vt + t * 16 * SW, BK * SW, 8 * SW, SW);
      wgmma::wgmma_rs<D>(o, pa[t], dv, 1);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) wgmma::hold(o[i]);
    __syncthreads();                 // before the next load reuses the stage
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int m = m0 + r0 + 8 * ri;
    if (m < n_rows) {
      bf16* orow = out_row(p, b, m);
      const float inv = 1.f / fmaxf(l_run[ri], 1e-30f);
      if (p.lse != nullptr && lane % 4 == 0) {   // the backward's P
        const int h = m / p.len_q;
        p.lse[(static_cast<long long>(b) * p.hkv * p.n_rep + kvh * p.n_rep +
               h) * p.len_q + m - h * p.len_q] =
            m_run[ri] + logf(fmaxf(l_run[ri], 1e-30f));
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        reinterpret_cast<bf162*>(orow + 8 * j + 2 * (lane % 4))[0] =
            __floats2bfloat162_rn(o[4 * j + 2 * ri] * inv,
                                  o[4 * j + 2 * ri + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. f32: SIMT, 16-row tiles of 32 keys
// ---------------------------------------------------------------------------

constexpr int kBQ = 16;         // query rows per block
constexpr int kBK = 32;         // keys per KV tile

// Stage one tile of kBK keys of K and V into shared memory.  A thread
// issues up to kBatch global loads of each before its shared stores, so a
// tile costs a few memory latencies rather than one per element, without
// holding a whole D 256 tile in registers; with kVec (16-byte aligned rows,
// checked by the launcher) each load moves 16 bytes.
template <int D, bool kVec>
__device__ __forceinline__ void load_tile(const float* kb, const float* vb,
                                          long long k_stride,
                                          long long v_stride, int k0,
                                          int len_kv, float* ks, float* vs) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kPerRow = D / kW;
  constexpr int kLoads = kBK * kPerRow;
  constexpr int kPer = (kLoads + kThreads - 1) / kThreads;
  constexpr int kBatch = kPer < 8 ? kPer : 8;
  using Raw = typename std::conditional<kVec, float4, float>::type;
#pragma unroll 1
  for (int c0 = 0; c0 < kPer; c0 += kBatch) {
    Raw kc[kBatch], vc[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const int idx = threadIdx.x + (c0 + c) * kThreads;
      const int kp = k0 + idx / kPerRow;
      const int e = (idx % kPerRow) * kW;
      if (idx < kLoads && kp < len_kv) {
        kc[c] = *reinterpret_cast<const Raw*>(kb + kp * k_stride + e);
        vc[c] = *reinterpret_cast<const Raw*>(vb + kp * v_stride + e);
      }
    }
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const int idx = threadIdx.x + (c0 + c) * kThreads;
      if (idx < kLoads) {
        const int j = idx / kPerRow, e = (idx % kPerRow) * kW;
        const bool in = k0 + j < len_kv;
        const float* kx = reinterpret_cast<const float*>(&kc[c]);
        const float* vx = reinterpret_cast<const float*>(&vc[c]);
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          ks[j * (D + 1) + e + i] = in ? kx[i] : 0.f;
          vs[j * D + e + i] = in ? vx[i] : 0.f;
        }
      }
    }
  }
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);        // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK + 1]
  __shared__ int row_pos_s[kBQ];
  __shared__ int span[3];

  const int tid = threadIdx.x;
  const int b = block_bh(p) / p.hkv;
  const int kvh = block_bh(p) % p.hkv;
  const int m0 = block_sub(p) * kBQ;
  const int n_rows = p.n_rep * p.len_q;
  const int kvb = p.kv_index ? p.kv_index[b] : b;
  const float* kb = static_cast<const float*>(p.k) + kvb * p.sk.b +
                    kvh * p.sk.h;
  const float* vb = static_cast<const float*>(p.v) + kvb * p.sv.b +
                    kvh * p.sv.h;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D;
    const int m = m0 + rr;
    float x = 0.f;
    if (m < n_rows) {
      const int h = kvh * p.n_rep + m / p.len_q;
      x = static_cast<const float*>(p.q)[b * p.sq.b + h * p.sq.h +
                                         (m % p.len_q) * p.sq.s + d];
    }
    qs[rr * (D + 1) + d] = x;
  }
  visible_span(p, b, m0, kBQ, row_pos_s, span);
  const int kv_lo = span[0] / kBK * kBK, kv_hi = span[1] + 1;

  const int row = tid >> 3;
  const int lane = tid & 7;
  const int pos = row_pos_s[row];
  float m_run = kMasked, l_run = 0.f;
  float acc[D / 8];
#pragma unroll
  for (int a = 0; a < D / 8; ++a) acc[a] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    load_tile<D, kVec>(kb, vb, p.sk.s, p.sv.s, k0, p.len_kv, ks, vs);
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
      } else if (!sees(p, pos, kp)) {
        dot = kMasked;
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
      ps[row * (kBK + 1) + lane + 8 * c] = pc;
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

  const int m = m0 + row;
  if (m < n_rows) {
    const int h = kvh * p.n_rep + m / p.len_q;
    float* orow = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h +
                  (m % p.len_q) * p.so.s;
    const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int a = 0; a < D / 8; ++a) orow[lane + 8 * a] = acc[a] / denom;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// K and V rows start on 16-byte boundaries: every base and stride is a
// multiple of 16 bytes.
bool rows_aligned(const Params& p, int d, long long elem) {
  const long long n = 16 / elem;
  const long long strides[] = {p.sk.b, p.sk.h, p.sk.s, p.sv.b, p.sv.h,
                               p.sv.s, static_cast<long long>(d)};
  for (long long x : strides) {
    if (x % n != 0) return false;
  }
  return reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
}

// The grid: per_bh blocks for each of the batch x hkv (row, KV head)
// pairs, all on axis x; 0 when they pass its 2^31 - 1.
unsigned grid_x(Params& p, int per_bh, int batch) {
  p.per_bh = per_bh;
  const long long n = static_cast<long long>(per_bh) * batch * p.hkv;
  return n <= INT_MAX ? static_cast<unsigned>(n) : 0u;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch_f32(Params p, int batch, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = rows_aligned(p, D, 4) ? flash_f32_kernel<D, true>
                                      : flash_f32_kernel<D, false>;
  const int set = repro::once_per_device([smem] {
    return allow_smem(flash_f32_kernel<D, true>, smem) |
           allow_smem(flash_f32_kernel<D, false>, smem);
  });
  if (set) return set;
  const int n_rows = p.n_rep * p.len_q;
  const unsigned grid = grid_x(p, (n_rows + kBQ - 1) / kBQ, batch);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(Params p, int batch, cudaStream_t stream) {
  const int n_rows = p.n_rep * p.len_q;
  if (n_rows <= kDecRows) {
    constexpr int smem = Dec<D>::SMEM;
    const int set = repro::once_per_device(
        [] { return allow_smem(flash_decode_kernel<D>, Dec<D>::SMEM); });
    if (set) return set;
    const unsigned grid = grid_x(p, p.n_split, batch);
    if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = p.n_split;   // a cluster per (b, KV head)
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_decode_kernel<D>, p);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    constexpr int smem = Pre<D>::SMEM;
    const int set = repro::once_per_device(
        [] { return allow_smem(flash_prefill_kernel<D>, Pre<D>::SMEM); });
    if (set) return set;
    const unsigned grid = grid_x(p, (n_rows + kPreRows - 1) / kPreRows,
                                 batch);
    if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
    flash_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int batch, int dtype, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(p, batch, stream)
                    : launch_bf16<D>(p, batch, stream);
}

}  // namespace

// One launch's arguments, packed by the wrapper into 224 bytes
// (ops.py ARGS, "<21q10if4xq"): a Python call with one bytes argument
// costs the host far less than one with 33 converted ones.  Strides are
// element strides (b, h, s) of the [B, H, S, D] views of q, k, v and o.
// Row (b, h) reads q_offset[b * qo_b + h * qo_h].  dtype: 0 float32, 1
// bfloat16 (q, k, v and o share it); bfloat16 needs 16-byte aligned rows.
// For bfloat16 with n_rep * Sq <= 16 (the decode body), each (batch row,
// KV head)'s visible 32-key tiles are shared out over a cluster of
// n_split (1 to 8) blocks.  lse (null on every serving call): the
// prefill body writes each row's log-sum-exp there for the backward; the
// other bodies leave it.
struct LaunchArgs {
  long long q, k, v, o;
  long long strides[12];
  long long q_offset, qo_b, qo_h, kv_index, lse;
  int n_split, batch, hq, hkv, len_q, len_kv, d, causal, window, dtype;
  float scale;
  long long stream;
};
static_assert(sizeof(LaunchArgs) == 224, "LaunchArgs must match ops.ARGS");

extern "C" int repro_flash_attention(const char* packed) {
  LaunchArgs a;
  memcpy(&a, packed, sizeof(a));
  const int batch = a.batch, hq = a.hq, hkv = a.hkv, len_q = a.len_q;
  const int len_kv = a.len_kv, d = a.d, dtype = a.dtype;
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || len_q < 0 || len_kv < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (len_q == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.q = reinterpret_cast<const void*>(a.q);
  p.k = reinterpret_cast<const void*>(a.k);
  p.v = reinterpret_cast<const void*>(a.v);
  p.o = reinterpret_cast<void*>(a.o);
  View* views[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) {
    *views[i] = {a.strides[3 * i], a.strides[3 * i + 1], a.strides[3 * i + 2]};
  }
  p.q_offset = reinterpret_cast<const int32_t*>(a.q_offset);
  p.qo_b = a.qo_b;
  p.qo_h = a.qo_h;
  p.kv_index = reinterpret_cast<const int32_t*>(a.kv_index);
  p.lse = reinterpret_cast<float*>(a.lse);
  p.hkv = hkv;
  p.n_rep = hq / hkv;
  p.len_q = len_q;
  p.len_kv = len_kv;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  p.n_split = a.n_split;
  if (dtype == 1) {
    if (!rows_aligned(p, d, 2)) return static_cast<int>(cudaErrorInvalidValue);
    if (p.n_rep * len_q <= kDecRows &&
        (a.n_split < 1 || a.n_split > kMaxSplit)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  switch (d) {
    case 16: return launch_d<16>(p, batch, dtype, s);
    case 32: return launch_d<32>(p, batch, dtype, s);
    case 64: return launch_d<64>(p, batch, dtype, s);
    case 128: return launch_d<128>(p, batch, dtype, s);
    case 160: return launch_d<160>(p, batch, dtype, s);
    case 256: return launch_d<256>(p, batch, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
