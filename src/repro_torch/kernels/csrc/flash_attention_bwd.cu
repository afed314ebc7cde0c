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
// [B, Hq, Sq, D] and k, v, dk, dv [B, Hkv, Skv, D], strided views with a
// unit last stride (the model's transposed [B, S, H, D] activations are
// read where they lie), all f32 or all bf16 (bf16 rows on 16-byte
// boundaries); D a multiple of 4 up to 256 (the forward's head sizes).
//
// What bounds it: at hymba-1.5b's training shape (q [1, 25, 128, 64]
// bf16, 5 KV heads) the function moves ~1.3 MB (0.4 us at HBM rate) and
// needs ~10 MFLOP of products (0.01 us at the bf16 peak): launch latency
// and the dependent steps of each tile (load, two products, the
// elementwise dS, two more products), not the card's rates.
//
// Two bodies, chosen by the launcher from dtype, D and n_rep alone:
//
// 1. wgmma (bf16 at D 64 and 128 with n_rep <= 8: hymba, qwen3, deepseek,
//    chameleon, qwen3-moe).  FlashAttention-2's backward (arXiv:2307.08691,
//    Algorithm 2) on one warpgroup a block, 64 rows a block, the forward's
//    prefill machinery (wgmma.cuh, swizzled tiles filled by 16-byte
//    cp.async into a two-stage ring).  One launch holds two kinds of
//    block:
//    - dQ: 64 query rows of one (batch, query head).  S = Q K^T and
//      dP = dO V^T (wgmma_ss, both K-major, as the forward's S) for each
//      64-key tile the rows see; dS = P * (dP - D_i) in the accumulator
//      registers, P = exp(s - lse); dQ += dS K (wgmma_rs, dS from the
//      accumulator as bf16, K read MN-major as the forward reads V).
//    - dK/dV: 64 keys of one (batch, KV head) and one of its query heads,
//      a thread-block cluster of the n_rep blocks of a key tile, one a
//      query head (at hymba's shape 50 dQ and 50 dK/dV blocks; 64 is
//      wgmma's M, so keys are not split finer).  S^T = K Q^T and
//      dP^T = V dO^T (wgmma_ss) over BQ query rows a tile (64 at D 64,
//      32 at D 128, for registers); P^T and dS^T
//      from each row's lse and D_i; dV += P^T dO and dK += dS^T Q
//      (wgmma_rs, dO and Q MN-major).  The n_rep shares then sum in head
//      order through distributed shared memory, each block writing
//      1 / n_rep of the tile: no scratch, no reduce launch, no float
//      atomics; two calls give the same bits.
//    D_i = rowsum(dO * O) is taken where it is needed (the dK/dV block
//    takes the next tile's while its products run).  Each row's
//    log-sum-exp comes from the forward's prefill body when the caller
//    has it (lse, the training path); else a first launch
//    (flash_bwd_lse_kernel) takes it from q and k as the forward would,
//    into scratch.  P = 2^(s log2 e - lse log2 e) (ex2), masked keys
//    through the exponent (2^-inf = 0) and the mask as bounds on query
//    minus key joined by & (Band), no branch.  Rounding: P and dS
//    are bf16 wgmma operands (the plain version keeps dS in f32 and rounds
//    p before dividing by l); the products accumulate in f32.
//    Where a dK/dV block's time goes at hymba's shape (kernels/
//    bwd_trace.py, cycles): the first loads ~5,300, forming P^T and dS^T
//    ~3,000 a tile, the four products ~1,700 a tile, the cluster's
//    barrier and head-order sum ~6,200.
// 2. SIMT (float32, whose 1e-4 checks the tensor cores' TF32 would miss;
//    bf16 at D 16/32/160/256; n_rep > 8): 16 query rows x 32 keys in f32
//    shared memory.  flash_attention_bwd_dq_kernel takes
//    each row's max and sum in a first walk (rows padded to D + 1 floats)
//    and dQ in a second; flash_attention_bwd_dkv_kernel a block per
//    (query head, KV head, 32 keys) writes that head's share of dK and dV
//    to scratch and flash_attention_bwd_reduce_kernel sums the n_rep
//    shares in head order (any n_rep; a cluster holds at most 8).
// A row that sees no key (causal, Sq > Skv) gets p = 1 on every key, as
// the plain version's (P = 1 / Skv, dS = 0), so blocks holding one walk
// every tile.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it), no spills:
//   flash_bwd_kernel 245 (D 64) and 252 (D 128) registers, 1536 / 1024 B
//   static shared memory, Wg<D>::SMEM dynamic (50,176 / 99,328 B);
//   flash_bwd_lse_kernel 85 / 89 registers; the SIMT body 32–64.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

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
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;             // the portable cluster size

struct View {                              // element strides of [B, H, S, D]
  long long b, h, s;
};

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  View sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;                        // wgmma: [B, Hq, Sq]
  float* stats;                            // SIMT: [3][B * Hq * Sq] m, l, D_i
  float* parts;                            // SIMT: [n_rep][2][B, Hkv, Skv, D]
  int batch, hq, hkv, n_rep, len_q, len_kv, d, causal, window;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* t, const View& s, int b,
                                       int h) {
  return static_cast<const T*>(t) + b * s.b + h * s.h;
}
template <typename T>
__device__ __forceinline__ T* at(void* t, const View& s, int b, int h) {
  return static_cast<T*>(t) + b * s.b + h * s.h;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int kk) {
  const int qp = p.len_kv - p.len_q + i;
  return (!p.causal || qp >= kk) && (p.window <= 0 || qp - kk < p.window);
}

// The wgmma body's mask as bounds on d = (query position) - (key): a
// key is visible when lo <= d < hi.  Each element then costs an add and
// two compares joined by & (no short-circuit, so no branch: with
// visible()'s && the masks took ~10x the arithmetic of P and dS).
struct Band {
  int lo, hi;
  __device__ explicit Band(const Params& p)
      : lo(p.causal ? 0 : INT_MIN), hi(p.window > 0 ? p.window : INT_MAX) {}
  __device__ bool sees(int d) const { return (d >= lo) & (d < hi); }
};

// ---------------------------------------------------------------------------
// 1. wgmma: bf16 at D 64 and 128
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                  // a warpgroup's M
constexpr int kSW = 128;                   // swizzle: D is a multiple of 64
constexpr int kE = kSW / 2;                // bf16 per swizzle atom row

template <int D>
struct Wg {
  static constexpr int BK = 64;                    // dQ: keys a tile
  static constexpr int BQ = D == 64 ? 64 : 32;     // dK/dV: rows a tile
  static constexpr int TILE = kRows * D * 2;       // a 64-row bf16 tile
  static constexpr int DQ_BYTES = 2 * TILE + 4 * BK * D * 2;
  static constexpr int DKV_BYTES = 2 * TILE + 4 * BQ * D * 2;
  static constexpr int PITCH = D + 8;              // floats a row of red
  static constexpr int RED_BYTES = 2 * kRows * PITCH * 4;
  static constexpr int MAX1 = DQ_BYTES > DKV_BYTES ? DQ_BYTES : DKV_BYTES;
  // 1024 for aligning the base to the swizzle
  static constexpr int SMEM = 1024 + (MAX1 > RED_BYTES ? MAX1 : RED_BYTES);
  static constexpr int LSE_SMEM = 1024 + TILE + 2 * BK * D * 2;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Rows [r0, r0 + ROWS) of a [S, D] slice at base (row stride rs) into a
// swizzled tile; zeros past limit.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* base, long long rs,
                                          int r0, int limit) {
  constexpr int kRow = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kRow; idx += kThreads) {
    const int j = idx / kRow, e = (idx % kRow) * 8;
    const bool in = r0 + j < limit;
    wgmma::cp_async16(dst + wgmma::sw_off<kSW>(j, e, ROWS),
                      base + (in ? r0 + j : 0) * rs + e, in);
  }
}

// K-major descriptor of k-step kk (16 columns of D) of a tile of `rows`
// rows: the A or B operand of S = Q K^T.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int rows, int kk) {
  return wgmma::desc(tile + (kk * 16 / kE) * rows * kSW + (kk * 16 % kE) * 2,
                     16, 8 * kSW, kSW);
}
// MN-major descriptor of rows [16 t, 16 t + 16) of a tile of `rows` rows,
// D its N: the B operand of O += P V.
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int rows, int t) {
  return wgmma::desc(tile + t * 16 * kSW, rows * kSW, 8 * kSW, kSW);
}

// D_i = rowsum(dO * O) and the log-sum-exp of rows [i0, i0 + ROWS) of
// one (batch, query head) into di_s and lse_s (lse +inf past Sq, so those
// rows' P is 0); kThreads / ROWS threads a row, 16-byte loads.
template <int D, int ROWS>
__device__ __forceinline__ void row_stats(const Params& p, int b, int h,
                                          int i0, float* di_s,
                                          float* lse_s) {
  constexpr int TPR = kThreads / ROWS, PER = D / TPR;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int i = i0 + row;
  float x = 0.f;
  if (i < p.len_q) {
    const bf16* a = at<bf16>(p.o, p.so, b, h) + i * p.so.s + part * PER;
    const bf16* g = at<bf16>(p.dout, p.sdo, b, h) + i * p.sdo.s + part * PER;
#pragma unroll
    for (int e = 0; e < PER; e += 8) {
      const uint4 ua = *reinterpret_cast<const uint4*>(a + e);
      const uint4 ug = *reinterpret_cast<const uint4*>(g + e);
      const bf162* pa = reinterpret_cast<const bf162*>(&ua);
      const bf162* pg = reinterpret_cast<const bf162*>(&ug);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 fa = __bfloat1622float2(pa[c]);
        const float2 fg = __bfloat1622float2(pg[c]);
        x = fmaf(fa.x, fg.x, x);
        x = fmaf(fa.y, fg.y, x);
      }
    }
  }
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (part == 0) {
    di_s[row] = x;
    lse_s[row] = i < p.len_q
                     ? p.lse[(static_cast<long long>(b) * p.hq + h) *
                                 p.len_q + i]
                     : INFINITY;
  }
}

// The keys [k_lo, k_hi) that some row of [i0, i0 + 64) sees (rows that
// see none take no dS); k_lo on a tile boundary.
__device__ __forceinline__ void key_span(const Params& p, int i0, int bk,
                                         int* k_lo, int* k_hi) {
  const int off = p.len_kv - p.len_q;
  const int i_last = min(i0 + kRows, p.len_q) - 1;
  int lo = 0, hi = p.len_kv;
  if (p.causal) hi = min(p.len_kv, off + i_last + 1);
  if (p.window > 0) lo = max(0, off + i0 - p.window + 1);
  *k_lo = lo / bk * bk;
  *k_hi = hi;
}

// Pack accumulator columns [16 t, 16 t + 16) as the bf16 A fragment of a
// K step (the accumulator's own fragment order).
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int t = 0; t < N / 16; ++t) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const bf162 h = __floats2bfloat162_rn(x[8 * t + 2 * g],
                                            x[8 * t + 2 * g + 1]);
      a[t][g] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

// dQ for 64 query rows of (b, h): a block of the main launch.
template <int D>
__device__ void dq_block(const Params& p, unsigned char* sm, int blk) {
  using C = Wg<D>;
  constexpr int BK = C::BK, KV = BK * D * 2;
  __shared__ float di_s[kRows], lse_s[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_tiles = (p.len_q + kRows - 1) / kRows;
  const int r = blk % p.n_rep;
  int c = blk / p.n_rep;
  const int qt = c % q_tiles;
  c /= q_tiles;
  const int g = c % p.hkv, b = c / p.hkv, h = g * p.n_rep + r;
  const int i0 = qt * kRows;
  unsigned char* qs = sm;
  unsigned char* dos = sm + C::TILE;
  unsigned char* kvs = sm + 2 * C::TILE;     // stage s: K at 2 s, V at 2 s + 1
  const bf16* kb = at<bf16>(p.k, p.sk, b, g);
  const bf16* vb = at<bf16>(p.v, p.sv, b, g);

  load_tile<D, kRows>(qs, at<bf16>(p.q, p.sq, b, h), p.sq.s, i0, p.len_q);
  load_tile<D, kRows>(dos, at<bf16>(p.dout, p.sdo, b, h), p.sdo.s, i0,
                      p.len_q);
  int k_lo, k_hi;
  key_span(p, i0, BK, &k_lo, &k_hi);
  if (k_lo < k_hi) {
    load_tile<D, BK>(kvs, kb, p.sk.s, k_lo, p.len_kv);
    load_tile<D, BK>(kvs + KV, vb, p.sv.s, k_lo, p.len_kv);
  }
  wgmma::cp_async_commit();                  // Q, dO and the first tile
  row_stats<D, kRows>(p, b, h, i0, di_s, lse_s);
  __syncthreads();
  const int r0 = warp * 16 + lane / 4;
  const float di[2] = {di_s[r0], di_s[r0 + 8]};
  // P = exp(s - lse) as 2^(s log2 e - lse log2 e)
  const float scale2 = p.scale * kLog2e;
  const float lse[2] = {lse_s[r0] * kLog2e, lse_s[r0 + 8] * kLog2e};
  const int i[2] = {i0 + r0, i0 + r0 + 8};
  const Band band(p);
  const int pos0 = p.len_kv - p.len_q + i0 + r0;   // row ri at pos0 + 8 ri

  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
  int stage = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_hi) {
      unsigned char* nk = kvs + (stage ^ 1) * 2 * KV;
      load_tile<D, BK>(nk, kb, p.sk.s, k0 + BK, p.len_kv);
      load_tile<D, BK>(nk + KV, vb, p.sv.s, k0 + BK, p.len_kv);
    }
    wgmma::cp_async_commit();
    wgmma::cp_async_wait<1>();
    wgmma::fence_async_shared();
    __syncthreads();
    const unsigned char* kt = kvs + stage * 2 * KV;
    const unsigned char* vt = kt + KV;

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma::wgmma_ss<BK>(s, kmajor(qs, kRows, kk), kmajor(kt, BK, kk),
                          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma::wgmma_ss<BK>(dp, kmajor(dos, kRows, kk), kmajor(vt, BK, kk),
                          kk > 0);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      wgmma::hold(s[e]);
      wgmma::hold(dp[e]);
    }
    // dS = P * (dP - D_i) on visible keys (P = 0 elsewhere), in place of
    // s, without a branch
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * ri + e;
          const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
          const bool vis = (kp < p.len_kv) & band.sees(pos0 + 8 * ri - kp);
          s[x] = exp2f(vis ? s[x] * scale2 - lse[ri] : -INFINITY) *
                 (dp[x] - di[ri]);
        }
      }
    }
    uint32_t a[BK / 16][4];
    to_a<BK>(s, a);
    wgmma::fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      wgmma::wgmma_rs<D>(dq, a[t], mnmajor(kt, BK, t), 1);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int e = 0; e < D / 2; ++e) wgmma::hold(dq[e]);
    __syncthreads();                 // before the next load reuses the stage
  }
  wgmma::cp_async_wait<0>();
  bf16* out = at<bf16>(p.dq, p.sdq, b, h);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (i[ri] < p.len_q) {
      bf16* row = out + i[ri] * p.sdq.s;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        reinterpret_cast<bf162*>(row + 8 * j + 2 * (lane % 4))[0] =
            __floats2bfloat162_rn(dq[4 * j + 2 * ri] * p.scale,
                                  dq[4 * j + 2 * ri + 1] * p.scale);
      }
    }
  }
}

// dK and dV for 64 keys of (b, KV head g), this block's query head's
// share; the cluster of the group's n_rep blocks sums the shares.
template <int D>
__device__ void dkv_block(const Params& p, unsigned char* sm, int blk) {
  using C = Wg<D>;
  constexpr int BQ = C::BQ, QB = BQ * D * 2, PITCH = C::PITCH;
  __shared__ float di_s[2][BQ], lse_s[2][BQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_tiles = (p.len_kv + kRows - 1) / kRows;
  const int r = blk % p.n_rep;               // the block's cluster rank
  int c = blk / p.n_rep;
  const int kt = c % k_tiles;
  c /= k_tiles;
  const int g = c % p.hkv, b = c / p.hkv, h = g * p.n_rep + r;
  const int k0 = kt * kRows;
  unsigned char* ks = sm;
  unsigned char* vs = sm + C::TILE;
  unsigned char* qdo = sm + 2 * C::TILE;     // stage s: Q at 2 s, dO at 2 s + 1
  const bf16* qb = at<bf16>(p.q, p.sq, b, h);
  const bf16* dob = at<bf16>(p.dout, p.sdo, b, h);

  load_tile<D, kRows>(ks, at<bf16>(p.k, p.sk, b, g), p.sk.s, k0, p.len_kv);
  load_tile<D, kRows>(vs, at<bf16>(p.v, p.sv, b, g), p.sv.s, k0, p.len_kv);
  // the query rows some key of this tile is visible to, and those that see
  // no key at all (causal, i < Sq - Skv), which see every key
  const int off = p.len_kv - p.len_q;
  const int k1 = min(k0 + kRows, p.len_kv) - 1;
  int q_lo = 0, q_hi = p.len_q;
  if (p.causal && off >= 0) q_lo = max(0, k0 - off);
  if (p.window > 0) q_hi = min(p.len_q, k1 + p.window - off);
  q_lo = q_lo / BQ * BQ;
  if (q_lo < q_hi) {
    load_tile<D, BQ>(qdo, qb, p.sq.s, q_lo, p.len_q);
    load_tile<D, BQ>(qdo + QB, dob, p.sdo.s, q_lo, p.len_q);
    row_stats<D, BQ>(p, b, h, q_lo, di_s[0], lse_s[0]);
  }
  wgmma::cp_async_commit();                  // K, V and the first tile
  const float inv_kv = 1.f / p.len_kv;
  const float scale2 = p.scale * kLog2e;     // P = 2^(s log2 e - lse log2 e)
  const int kr0 = warp * 16 + lane / 4;      // this thread's two keys
  const int kp[2] = {k0 + kr0, k0 + kr0 + 8};
  const bool kin[2] = {kp[0] < p.len_kv, kp[1] < p.len_kv};
  const Band band(p);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
  int stage = 0;
  for (int i0 = q_lo; i0 < q_hi; i0 += BQ, stage ^= 1) {
    const bool more = i0 + BQ < q_hi;
    if (more) {
      unsigned char* nq = qdo + (stage ^ 1) * 2 * QB;
      load_tile<D, BQ>(nq, qb, p.sq.s, i0 + BQ, p.len_q);
      load_tile<D, BQ>(nq + QB, dob, p.sdo.s, i0 + BQ, p.len_q);
    }
    wgmma::cp_async_commit();
    wgmma::cp_async_wait<1>();
    wgmma::fence_async_shared();
    __syncthreads();
    const unsigned char* qt = qdo + stage * 2 * QB;
    const unsigned char* dt = qt + QB;

    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] = dpt[e] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma::wgmma_ss<BQ>(st, kmajor(ks, kRows, kk), kmajor(qt, BQ, kk),
                          kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma::wgmma_ss<BQ>(dpt, kmajor(vs, kRows, kk), kmajor(dt, BQ, kk),
                          kk > 0);
    }
    wgmma::commit();
    // while the products run: the next tile's D_i and log-sum-exp
    if (more) {
      row_stats<D, BQ>(p, b, h, i0 + BQ, di_s[stage ^ 1], lse_s[stage ^ 1]);
    }
    wgmma::wait_all();
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      wgmma::hold(st[e]);
      wgmma::hold(dpt[e]);
    }
    // P^T and dS^T in place of st and dpt, without a branch (P = 0 on a
    // key a row does not see, 1 / Skv on every key of a row that sees
    // none): this tile's rows qc < q_left are real, those below
    // none_left see no key
    const int q_left = p.len_q - i0;
    const int none_left = p.causal ? -(off + i0) : 0;
    const int d0[2] = {off + i0 - kp[0], off + i0 - kp[1]};
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int ki = 0; ki < 2; ++ki) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * ki + e;
          const int qc = 8 * j + 2 * (lane % 4) + e;
          const bool in = kin[ki] & (qc < q_left);
          const bool vis = in & band.sees(d0[ki] + qc);
          const bool none = in & (qc < none_left);
          const float pv = exp2f(
              vis ? st[x] * scale2 - lse_s[stage][qc] * kLog2e : -INFINITY);
          dpt[x] = pv * (dpt[x] - di_s[stage][qc]);
          st[x] = none ? inv_kv : pv;
        }
      }
    }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
    to_a<BQ>(st, pa);
    to_a<BQ>(dpt, sa);
    wgmma::fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      wgmma::wgmma_rs<D>(dv, pa[t], mnmajor(dt, BQ, t), 1);
    }
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      wgmma::wgmma_rs<D>(dk, sa[t], mnmajor(qt, BQ, t), 1);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      wgmma::hold(dk[e]);
      wgmma::hold(dv[e]);
    }
    __syncthreads();                 // before the next load reuses the stage
  }

  // the shares into shared memory (every tile is dead now), f32 [2][64][PITCH]
  wgmma::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int ki = 0; ki < 2; ++ki) {
      const int at_row = (kr0 + 8 * ki) * PITCH + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(red + at_row) =
          make_float2(dk[4 * j + 2 * ki], dk[4 * j + 2 * ki + 1]);
      *reinterpret_cast<float2*>(red + kRows * PITCH + at_row) =
          make_float2(dv[4 * j + 2 * ki], dv[4 * j + 2 * ki + 1]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // this block's 1 / n_rep of the 8-column pieces, each the sum of the
  // n_rep shares in head order
  constexpr int kPieces = D / 8;
  for (int it = r * kThreads + tid; it < 2 * kRows * kPieces;
       it += p.n_rep * kThreads) {
    const int which = it / (kRows * kPieces);
    const int row = it % (kRows * kPieces) / kPieces;
    const int col = it % kPieces * 8;
    if (k0 + row >= p.len_kv) continue;
    const int off_f = (which * kRows + row) * PITCH + col;
    // every share's loads in flight together, then the sums in head order
    float4 sh[2 * kMaxCluster];
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr) {
      if (rr < p.n_rep) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, rr) + off_f);
        sh[2 * rr] = src[0];
        sh[2 * rr + 1] = src[1];
      }
    }
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < kMaxCluster; ++rr) {
      if (rr < p.n_rep) {
        const float4 a = sh[2 * rr], c4 = sh[2 * rr + 1];
        x[0] += a.x; x[1] += a.y; x[2] += a.z; x[3] += a.w;
        x[4] += c4.x; x[5] += c4.y; x[6] += c4.z; x[7] += c4.w;
      }
    }
    const float sc = which == 0 ? p.scale : 1.f;
    uint4 packed;
    bf162* pk = reinterpret_cast<bf162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pk[e] = __floats2bfloat162_rn(x[2 * e] * sc, x[2 * e + 1] * sc);
    }
    bf16* dst = which == 0
                    ? at<bf16>(p.dk, p.sdk, b, g) + (k0 + row) * p.sdk.s
                    : at<bf16>(p.dv, p.sdv, b, g) + (k0 + row) * p.sdv.s;
    *reinterpret_cast<uint4*>(dst + col) = packed;
  }
  cluster.sync();                    // no block leaves while read from
}

// The main launch: blocks [0, n_dq) take dQ, the rest dK/dV; both counts
// are multiples of n_rep, so each cluster is of one kind.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const Params p, int n_dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < n_dq) {
    dq_block<D>(p, sm, blk);
  } else {
    dkv_block<D>(p, sm, blk - n_dq);
  }
}

// Each row's log-sum-exp of its logits, as the forward's prefill body
// takes it (running max and sum over the 64-key tiles the rows see), for
// a caller without the forward's: a block per 64 rows of (b, h).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_lse_kernel(const Params p, float* lse) {
  constexpr int BK = Wg<D>::BK, KB = BK * D * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* qs = sm;
  unsigned char* kstage = sm + Wg<D>::TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_tiles = (p.len_q + kRows - 1) / kRows;
  const int bh = blockIdx.x / q_tiles, b = bh / p.hq, h = bh % p.hq;
  const int i0 = (blockIdx.x % q_tiles) * kRows;
  const bf16* kb = at<bf16>(p.k, p.sk, b, h / p.n_rep);
  load_tile<D, kRows>(qs, at<bf16>(p.q, p.sq, b, h), p.sq.s, i0, p.len_q);
  int k_lo, k_hi;
  key_span(p, i0, BK, &k_lo, &k_hi);
  if (k_lo < k_hi) load_tile<D, BK>(kstage, kb, p.sk.s, k_lo, p.len_kv);
  wgmma::cp_async_commit();
  const int r0 = warp * 16 + lane / 4;
  const int i[2] = {i0 + r0, i0 + r0 + 8};
  const Band band(p);
  const int pos0 = p.len_kv - p.len_q + i0 + r0;   // row ri at pos0 + 8 ri
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.f, 0.f};
  int stage = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < k_hi) {
      load_tile<D, BK>(kstage + (stage ^ 1) * KB, kb, p.sk.s, k0 + BK,
                       p.len_kv);
    }
    wgmma::cp_async_commit();
    wgmma::cp_async_wait<1>();
    wgmma::fence_async_shared();
    __syncthreads();
    const unsigned char* kt = kstage + stage * KB;
    float s[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma::wgmma_ss<BK>(s, kmajor(qs, kRows, kk), kmajor(kt, BK, kk),
                          kk > 0);
    }
    wgmma::commit();
    wgmma::wait_all();
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) wgmma::hold(s[e]);
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
          const float x =
              kp >= p.len_kv ? -INFINITY
              : band.sees(pos0 + 8 * ri - kp) ? s[4 * j + 2 * ri + e] * p.scale
                                              : kMasked;
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
        for (int e = 0; e < 2; ++e) psum += expf(s[4 * j + 2 * ri + e] - m_new);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run[ri] = expf(m_run[ri] - m_new) * l_run[ri] + psum;
      m_run[ri] = m_new;
    }
    __syncthreads();                 // before the next load reuses the stage
  }
  wgmma::cp_async_wait<0>();
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (lane % 4 == 0 && i[ri] < p.len_q) {
      lse[static_cast<long long>(bh) * p.len_q + i[ri]] =
          m_run[ri] + logf(fmaxf(l_run[ri], 1e-30f));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_wgmma(Params p, float* scratch, cudaStream_t stream) {
  using C = Wg<D>;
  const cudaError_t set = repro::once_per_device([] {
    const cudaError_t e = allow_smem(flash_bwd_kernel<D>, C::SMEM);
    return e != cudaSuccess ? e
                            : allow_smem(flash_bwd_lse_kernel<D>, C::LSE_SMEM);
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long q_tiles = (p.len_q + kRows - 1) / kRows;
  const long long k_tiles = (p.len_kv + kRows - 1) / kRows;
  const long long n_dq = static_cast<long long>(p.batch) * p.hq * q_tiles;
  const long long n_all =
      n_dq + static_cast<long long>(p.batch) * p.hq * k_tiles;
  if (n_all > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (p.lse == nullptr) {                    // no forward's: take it here
    flash_bwd_lse_kernel<D><<<static_cast<unsigned>(n_dq), kThreads,
                              C::LSE_SMEM, stream>>>(p, scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    p.lse = scratch;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_all));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.n_rep;     // a group's query heads
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, flash_bwd_kernel<D>, p,
                                             static_cast<int>(n_dq)));
}

// ---------------------------------------------------------------------------
// 2. SIMT: float32, and bf16 at the other head sizes
// ---------------------------------------------------------------------------

constexpr int kSRows = 16;                 // query rows a tile
constexpr int kKeys = 32;                  // keys a tile
constexpr int kSPad = kKeys + 1;

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

// Can some row of the query tile at i0 see some key of the KV tile at
// k0?  A tile holding a row that sees no key meets every KV tile.
__device__ __forceinline__ bool tiles_meet(const Params& p, int i0, int k0) {
  const int off = p.len_kv - p.len_q;
  const int i1 = min(i0 + kSRows, p.len_q) - 1;
  const int k1 = min(k0 + kKeys, p.len_kv) - 1;
  if (p.causal && off + i0 < 0) return true;
  if (p.causal && k0 > off + i1) return false;
  if (p.window > 0 && off + i0 - k1 >= p.window) return false;
  return true;
}

// rows [r0, r0 + n_rows) of a [S, d] slice at base (row stride rs) into a
// padded f32 tile
template <typename T>
__device__ void load_rows(float* dst, const T* base, long long rs, int r0,
                          int n_rows, int limit, int d) {
  const int dp = d + 1;
  for (int e = threadIdx.x; e < n_rows * d; e += kThreads) {
    const int row = e / d, c = e - row * d;
    dst[row * dp + c] = r0 + row < limit ? ld(base, (r0 + row) * rs + c)
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
  float* qs = smem;                        // [kSRows][dp]
  float* dos = qs + kSRows * dp;           // [kSRows][dp]
  float* ks = dos + kSRows * dp;           // [kKeys][dp]
  float* vs = ks + kKeys * dp;             // [kKeys][dp]
  float* ss = vs + kKeys * dp;             // [kSRows][kSPad] dS
  float* acc = ss + kSRows * kSPad;        // [kSRows][d] dQ
  float* di_s = acc + kSRows * d;          // [kSRows]

  const int q_tiles = (p.len_q + kSRows - 1) / kSRows;
  const int bhq = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x - bhq * q_tiles) * kSRows;
  const int b = bhq / p.hq, h = bhq - b * p.hq, g = h / p.n_rep;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* q = at<T>(p.q, p.sq, b, h);
  const T* o = at<T>(p.o, p.so, b, h);
  const T* dout = at<T>(p.dout, p.sdo, b, h);
  const T* k = at<T>(p.k, p.sk, b, g);
  const T* v = at<T>(p.v, p.sv, b, g);

  load_rows(qs, q, p.sq.s, i0, kSRows, p.len_q, d);
  load_rows(dos, dout, p.sdo.s, i0, kSRows, p.len_q, d);
  for (int e = threadIdx.x; e < kSRows * d; e += kThreads) acc[e] = 0.f;
  __syncthreads();
  // D_i = rowsum(dO * O): warp w takes rows w, w + 4, w + 8, w + 12
  for (int m = 0; m < kSRows / 4; ++m) {
    const int row = warp + 4 * m, i = i0 + row;
    float x = 0.f;
    if (i < p.len_q) {
      for (int c = lane; c < d; c += kWarp) {
        x += dos[row * dp + c] * ld(o, i * p.so.s + c);
      }
    }
    x = warp_sum(x);
    if (lane == 0) di_s[row] = x;
  }

  // the KV tiles these rows can see
  const int off = p.len_kv - p.len_q;
  const int i_last = min(i0 + kSRows, p.len_q) - 1;
  int k_lo = 0, k_hi = p.len_kv;
  if (!(p.causal && off + i0 < 0)) {
    if (p.causal) k_hi = min(p.len_kv, off + i_last + 1);
    if (p.window > 0) k_lo = max(0, off + i0 - p.window + 1);
  }
  k_lo = k_lo / kKeys * kKeys;

  // walk 1: each row's max and sum, online (a warp's lanes all hold the
  // running values of its four rows)
  float mr[kSRows / 4], lr[kSRows / 4];
#pragma unroll
  for (int m = 0; m < kSRows / 4; ++m) {
    mr[m] = -INFINITY;
    lr[m] = 0.f;
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += kKeys) {
    __syncthreads();
    load_rows(ks, k, p.sk.s, k0, kKeys, p.len_kv, d);
    __syncthreads();
    const int kk = k0 + lane;
#pragma unroll
    for (int m = 0; m < kSRows / 4; ++m) {
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
  for (int m = 0; m < kSRows / 4; ++m) {
    lr[m] = fmaxf(lr[m], 1e-30f);
    const int row = warp + 4 * m, i = i0 + row;
    if (lane == 0 && i < p.len_q) {
      const long long at_row = static_cast<long long>(bhq) * p.len_q + i;
      p.stats[at_row] = mr[m];
      p.stats[n_rows + at_row] = lr[m];
      p.stats[2 * n_rows + at_row] = di_s[row];
    }
  }

  // walk 2: dS tile by tile, dQ += dS K
  for (int k0 = k_lo; k0 < k_hi; k0 += kKeys) {
    __syncthreads();
    load_rows(ks, k, p.sk.s, k0, kKeys, p.len_kv, d);
    load_rows(vs, v, p.sv.s, k0, kKeys, p.len_kv, d);
    __syncthreads();
    const int kk = k0 + lane;
#pragma unroll
    for (int m = 0; m < kSRows / 4; ++m) {
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
    for (int e = threadIdx.x; e < kSRows * d; e += kThreads) {
      const int row = e / d, c = e - row * d;
      float x = acc[e];
      for (int j = 0; j < kKeys; ++j) x += ss[row * kSPad + j] * ks[j * dp + c];
      acc[e] = x;
    }
  }
  __syncthreads();
  T* dq = at<T>(p.dq, p.sdq, b, h);
  for (int e = threadIdx.x; e < kSRows * d; e += kThreads) {
    const int row = e / d, c = e - row * d;
    if (i0 + row < p.len_q) st(dq, (i0 + row) * p.sdq.s + c, acc[e] * p.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d, dp = d + 1;
  float* ks = smem;                        // [kKeys][dp]
  float* vs = ks + kKeys * dp;             // [kKeys][dp]
  float* qs = vs + kKeys * dp;             // [kSRows][dp]
  float* dos = qs + kSRows * dp;           // [kSRows][dp]
  float* ps = dos + kSRows * dp;           // [kSRows][kSPad] P_v
  float* dss = ps + kSRows * kSPad;        // [kSRows][kSPad] dS
  float* dk_acc = dss + kSRows * kSPad;    // [kKeys][d]
  float* dv_acc = dk_acc + kKeys * d;      // [kKeys][d]
  float* st_s = dv_acc + kKeys * d;        // [3][kSRows]: m, l, D_i

  // blockIdx.x = (r * B * Hkv + bkv) * k_tiles + key tile: query head r
  // of the KV head's group
  const int k_tiles = (p.len_kv + kKeys - 1) / kKeys;
  const int q_tiles = (p.len_q + kSRows - 1) / kSRows;
  const int n_kv = p.batch * p.hkv;
  const int rk = blockIdx.x / k_tiles;
  const int r = rk / n_kv, bkv = rk - r * n_kv;
  const int k0 = (blockIdx.x - rk * k_tiles) * kKeys;
  const int b = bkv / p.hkv, g = bkv - b * p.hkv;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long n_rows = static_cast<long long>(p.batch) * p.hq * p.len_q;
  const int h = g * p.n_rep + r, bhq = b * p.hq + h;
  const T* q = at<T>(p.q, p.sq, b, h);
  const T* dout = at<T>(p.dout, p.sdo, b, h);
  const T* vtyped = at<T>(p.v, p.sv, b, g);

  load_rows(ks, at<T>(p.k, p.sk, b, g), p.sk.s, k0, kKeys, p.len_kv, d);
  load_rows(vs, vtyped, p.sv.s, k0, kKeys, p.len_kv, d);
  for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }
  const int kk = k0 + lane;
  for (int qt = 0; qt < q_tiles; ++qt) {
    const int i0 = qt * kSRows;
    if (!tiles_meet(p, i0, k0)) continue;
    __syncthreads();
    load_rows(qs, q, p.sq.s, i0, kSRows, p.len_q, d);
    load_rows(dos, dout, p.sdo.s, i0, kSRows, p.len_q, d);
    if (threadIdx.x < kSRows) {
      const int i = i0 + threadIdx.x;
      const long long at_row = static_cast<long long>(bhq) * p.len_q + i;
      const bool in = i < p.len_q;         // rows past Sq: zero q and dO
      st_s[threadIdx.x] = in ? p.stats[at_row] : 0.f;
      st_s[kSRows + threadIdx.x] = in ? p.stats[n_rows + at_row] : 1.f;
      st_s[2 * kSRows + threadIdx.x] = in ? p.stats[2 * n_rows + at_row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kSRows / 4; ++m) {
      const int row = warp + 4 * m;
      float pv = 0.f, ds = 0.f;
      if (kk < p.len_kv) {
        const bool vis = visible(p, i0 + row, kk);
        const float s = dot(qs + row * dp, ks + lane * dp, d) * p.scale;
        const float e = expf((vis ? s : kMasked) - st_s[row]);
        const float l = st_s[kSRows + row];
        pv = as_operand(e, vtyped) / l;
        if (vis) {
          const float dpv = dot(dos + row * dp, vs + lane * dp, d);
          ds = e / l * (dpv - st_s[2 * kSRows + row]);
        }
      }
      ps[row * kSPad + lane] = pv;
      dss[row * kSPad + lane] = ds;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
      const int j = e / d, c = e - j * d;
      float xv = dv_acc[e], xk = dk_acc[e];
      for (int row = 0; row < kSRows; ++row) {
        xv += ps[row * kSPad + j] * dos[row * dp + c];
        xk += dss[row * kSPad + j] * qs[row * dp + c];
      }
      dv_acc[e] = xv;
      dk_acc[e] = xk;
    }
  }
  // this query head's share, to scratch; the reduce kernel sums the
  // group's shares in head order
  const long long plane = static_cast<long long>(n_kv) * p.len_kv * d;
  const long long kv_base = static_cast<long long>(bkv) * p.len_kv * d;
  float* dk_part = p.parts + (2LL * r) * plane;
  float* dv_part = dk_part + plane;
  for (int e = threadIdx.x; e < kKeys * d; e += kThreads) {
    const int j = e / d, c = e - j * d;
    if (k0 + j < p.len_kv) {
      const long long at_el = kv_base + static_cast<long long>(k0 + j) * d + c;
      dk_part[at_el] = dk_acc[e];
      dv_part[at_el] = dv_acc[e];
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
  const int c = static_cast<int>(e % p.d);
  const long long row = e / p.d;
  const int key = static_cast<int>(row % p.len_kv);
  const int bkv = static_cast<int>(row / p.len_kv);
  const int b = bkv / p.hkv, g = bkv % p.hkv;
  st(at<T>(p.dk, p.sdk, b, g), key * p.sdk.s + c, xk * p.scale);
  st(at<T>(p.dv, p.sdv, b, g), key * p.sdv.s + c, xv);
}

constexpr int dq_smem(int d) {
  return ((2 * kSRows + 2 * kKeys) * (d + 1) + kSRows * kSPad + kSRows * d +
          kSRows) * static_cast<int>(sizeof(float));
}
constexpr int dkv_smem(int d) {
  return ((2 * kSRows + 2 * kKeys) * (d + 1) + 2 * kSRows * kSPad +
          2 * kKeys * d + 3 * kSRows) * static_cast<int>(sizeof(float));
}

template <typename T>
int launch_simt(Params p, cudaStream_t stream) {
  const cudaError_t set = repro::once_per_device([] {
    const cudaError_t e =
        allow_smem(flash_attention_bwd_dq_kernel<T>, dq_smem(kMaxD));
    return e != cudaSuccess
               ? e
               : allow_smem(flash_attention_bwd_dkv_kernel<T>,
                            dkv_smem(kMaxD));
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long q_blocks = static_cast<long long>(p.batch) * p.hq *
                             ((p.len_q + kSRows - 1) / kSRows);
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

// One launch's arguments, packed by the wrapper into 328 bytes (ops.py
// BWD_ARGS, "<35q9ifq"): pointers (q, k, v, o, do, dq, dk, dv, lse or 0,
// scratch), the scratch's floats, the (b, h, s) element strides of q, k,
// v, o, do, dq, dk and dv, then the sizes; dtype 0 float32, 1 bfloat16.
struct BwdArgs {
  long long q, k, v, o, dout, dq, dk, dv, lse, scratch, scratch_floats;
  long long strides[24];
  int batch, hq, hkv, len_q, len_kv, d, causal, window, dtype;
  float scale;
  long long stream;
};
static_assert(sizeof(BwdArgs) == 328, "BwdArgs must match ops.BWD_ARGS");

}  // namespace

// The wgmma body takes bf16 at D 64 and 128 with n_rep <= 8 and needs
// batch * hq * len_q floats of scratch when lse is 0; the SIMT body takes
// the rest and needs 3 * batch * hq * len_q (each row's max, sum and D_i)
// + 2 * batch * hq * len_kv * d (each query head's share of dK and dV).
extern "C" int repro_flash_attention_bwd(const char* packed) {
  BwdArgs a;
  memcpy(&a, packed, sizeof(a));
  if (a.batch < 1 || a.hkv < 1 || a.hq % a.hkv != 0 || a.len_q < 1 ||
      a.len_kv < 1 || a.d < 4 || a.d > kMaxD || a.d % 4 != 0 ||
      (a.dtype != 0 && a.dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = reinterpret_cast<const void*>(a.q);
  p.k = reinterpret_cast<const void*>(a.k);
  p.v = reinterpret_cast<const void*>(a.v);
  p.o = reinterpret_cast<const void*>(a.o);
  p.dout = reinterpret_cast<const void*>(a.dout);
  p.dq = reinterpret_cast<void*>(a.dq);
  p.dk = reinterpret_cast<void*>(a.dk);
  p.dv = reinterpret_cast<void*>(a.dv);
  View* views[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk,
                    &p.sdv};
  for (int i = 0; i < 8; ++i) {
    *views[i] = {a.strides[3 * i], a.strides[3 * i + 1], a.strides[3 * i + 2]};
  }
  p.lse = reinterpret_cast<const float*>(a.lse);
  p.batch = a.batch;
  p.hq = a.hq;
  p.hkv = a.hkv;
  p.n_rep = a.hq / a.hkv;
  p.len_q = a.len_q;
  p.len_kv = a.len_kv;
  p.d = a.d;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  float* scratch = reinterpret_cast<float*>(a.scratch);
  const long long rows = static_cast<long long>(a.batch) * a.hq * a.len_q;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(a.stream);
  if (a.dtype == 1 && (a.d == 64 || a.d == 128) && p.n_rep <= kMaxCluster) {
    if (p.lse == nullptr && a.scratch_floats < rows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.stats = p.parts = nullptr;
    return a.d == 64 ? launch_wgmma<64>(p, scratch, s)
                     : launch_wgmma<128>(p, scratch, s);
  }
  if (a.scratch_floats <
      3 * rows + 2LL * a.batch * a.hq * a.len_kv * a.d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.stats = scratch;
  p.parts = scratch + 3 * rows;
  return a.dtype == 0 ? launch_simt<float>(p, s) : launch_simt<bf16>(p, s);
}
