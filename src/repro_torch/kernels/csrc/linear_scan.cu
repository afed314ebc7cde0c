// Matrix-state linear recurrence (the RWKV6 "Finch" time-mix):
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t                S: [Dk, Dv] f32
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)           (u = bonus, optional)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/linear_scan/linear_scan.py::linear_scan (body _kernel).
//
// Contract: the TPU kernel's function (f32 state, zero at t = 0, dropped
// at the end), extended for a recurrence carried across calls: an optional
// s0 [BH, Dk, Dv] replaces the zero start, and the final state S_T is
// always written, so RWKV decode (T = 1 per tick) continues the prefill's
// state.  u may hold one row per head (u_rows = H) and is then broadcast
// over the batch: row bh reads u[bh % u_rows].  All tensors are f32 and
// contiguous: r, k, w [BH, T, Dk], v and o [BH, T, Dv].  Domain: decays
// w in [0, 1] (the reference's "decay in (0, 1)" with its closed ends;
// w = 0 forgets the state exactly), any finite r, k, v, u, s0.
//
// What bounds it on an H100: at rwkv6-7b's prefill (64 heads, 128 tokens,
// 64 x 64 state) the function reads and writes 11.5 MB, 3.45 us at HBM
// rate, and needs ~42 MFLOP; but the recurrence is sequential in T, so a
// step-by-step scan is bound by its chain of dependent steps (the first
// design: one warp per 32 columns of S, 128 blocks, 128 steps of a 64-long
// FMA chain each, 86 us).
//
// Two bodies, chosen by the launcher from the shape alone:
//
// 1. Sequential (T < C, Dk 8 and 16, and r, k or w off a 16-byte
//    boundary; RWKV decode, T = 1 over 512 (lane, head) rows, runs near
//    its byte bound).  Column j of S only ever meets
//    column j of the update k^T v and produces o_t[j], so the columns are
//    independent: each thread owns one column of S in registers, each
//    block is one warp over 32 columns of one bh, r, k, w staged in shared
//    memory.
// 2. Chunked (T >= C, C = 8 by default; Dk 32, 64, 128): the chain of
//    dependent steps becomes T / C chunk steps.  Within a chunk of n <= C
//    steps starting from state S0, with P_t = prod_{tau<=t} w_tau (per
//    key channel):
//      o_t   = (r_t * P_{t-1}) S0 + sum_{s<t} A[t,s] v_s
//              + (r_t . (u * k_t)) v_t
//      A[t,s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]
//      S_end = diag(P_{n-1}) S0 + sum_s (k_s * prod_{s<tau<n} w_tau)^T v_s.
//    Every decay is a running product of w over the steps it spans, never
//    a ratio of products or a difference of cumulative logs: the factors
//    are <= 1, so nothing overflows, w = 0 gives an exact 0 (no log, no
//    clamp, no NaN), and no large cumulative sum cancels.  Only S0 ->
//    S_end is sequential; the decays and A of a chunk depend on its inputs
//    alone.  So a block (bh, 32 columns of S: 128 blocks at the prefill
//    shape) specialises its warps.  Four producer warps copy chunk c + 2's
//    r, k, w rows (16 bytes a copy) and v tile into a ring of three
//    shared-memory stages (cp.async, zeros past T) and derive chunk c + 1:
//    (a) the prefix and suffix products, one thread a channel, its loads
//    ahead of its chain; (b) A, warp p taking the steps p + 4 n, each lane
//    Dk/32 channels, one load of r_t and w_t serving the warp's steps,
//    selects rather than branches, the lanes' sums reduced and scattered
//    by shuffles.  Meanwhile four consumer warps take chunk c from S0:
//    (c) o and (d) S_end, thread (g, a) keeping rows g + 8 m of columns a
//    and a + 16 of S in registers (a load of q or kd serves both columns;
//    eight consecutive channels a warp load, no bank met twice).  One
//    block barrier a chunk.  All FP32 FMAs on CUDA cores.  What set the
//    design: at one warp per scheduler nothing hides the shared-memory and
//    shuffle latencies, so the chunk's independent work runs beside its
//    sequential work, and C = 8 beats 16 (A's work grows with C).

#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// 1. sequential body
// ---------------------------------------------------------------------------

template <int DK>
__global__ void __launch_bounds__(kWarp)
linear_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, int u_rows,
                   const float* __restrict__ s0, float* __restrict__ o,
                   float* __restrict__ s_out, int t_len, int dv) {
  constexpr int kChunk = 2048 / DK;      // time steps staged per pass
  __shared__ float rs[kChunk * DK];
  __shared__ float ks[kChunk * DK];
  __shared__ float ws[kChunk * DK];
  __shared__ float us[DK];

  const long long bh = blockIdx.x;
  const int j = blockIdx.y * kWarp + threadIdx.x;
  const bool col = j < dv;

  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) {
    s[i] = (s0 != nullptr && col) ? s0[(bh * DK + i) * dv + j] : 0.f;
  }
  for (int i = threadIdx.x; i < DK; i += kWarp) {
    us[i] = u != nullptr ? u[(bh % u_rows) * DK + i] : 0.f;
  }
  const float* rb = r + bh * t_len * DK;
  const float* kb = k + bh * t_len * DK;
  const float* wb = w + bh * t_len * DK;
  const float* vb = v + bh * t_len * dv;
  float* ob = o + bh * t_len * dv;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0) * DK;
    __syncwarp();                        // the last chunk has been read
    for (int i = threadIdx.x; i < n; i += kWarp) {
      rs[i] = rb[t0 * DK + i];
      ks[i] = kb[t0 * DK + i];
      ws[i] = wb[t0 * DK + i];
    }
    __syncwarp();
    for (int tt = 0; tt < n / DK; ++tt) {
      const float vj = col ? vb[(t0 + tt) * static_cast<long long>(dv) + j]
                           : 0.f;
      const float* rt = rs + tt * DK;
      const float* kt = ks + tt * DK;
      const float* wt = ws + tt * DK;
      float y = 0.f;
      if (u != nullptr) {
#pragma unroll
        for (int i = 0; i < DK; ++i) {
          const float kv = kt[i] * vj;
          y += rt[i] * (s[i] + us[i] * kv);
          s[i] = wt[i] * s[i] + kv;
        }
      } else {
#pragma unroll
        for (int i = 0; i < DK; ++i) {
          y += rt[i] * s[i];
          s[i] = wt[i] * s[i] + kt[i] * vj;
        }
      }
      if (col) ob[(t0 + tt) * static_cast<long long>(dv) + j] = y;
    }
  }
  if (col) {
#pragma unroll
    for (int i = 0; i < DK; ++i) s_out[(bh * DK + i) * dv + j] = s[i];
  }
}

// ---------------------------------------------------------------------------
// 2. chunked body
// ---------------------------------------------------------------------------

constexpr int kHalfThreads = 128;   // consumer warps 0-3, producer warps 4-7
constexpr int kChunkThreads = 2 * kHalfThreads;
constexpr int kGroups = 8;          // consumers: channel groups, lane bits 0-2
constexpr int kColsPerThread = 2;   // consumers: columns of S a thread keeps
constexpr int kColStride = kHalfThreads / kGroups;
constexpr int kTileJ = kColStride * kColsPerThread;  // columns per block
constexpr int kDefaultChunk = 8;

template <int DK, int C>
struct Chunked {
  static constexpr int RPT = DK / kGroups;   // consumers: rows per thread
  static constexpr int CPL = DK / 32;        // producers: channels per lane
  static constexpr int NS = C / 4;           // producers: steps per warp
  static constexpr int STAGE = 3 * C * DK + C * kTileJ;  // r, k, w, v
  // per chunk from the producers: q and kd [C][DK], P_{n-1} [DK],
  // A [C][C + 1]
  static constexpr int DERIVED = 2 * C * DK + DK + C * (C + 1);
  // three input stages, two derived ones, u [DK]
  static constexpr int SMEM = (3 * STAGE + 2 * DERIVED + DK) * 4;
  static_assert(DK % 32 == 0 && C % 8 == 0 && C <= 32 && (C & (C - 1)) == 0,
                "unsupported chunk shape");
};

// global -> shared, asynchronously, 4 or 16 bytes; zeros where !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// A barrier of the producer warps alone.
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kHalfThreads) : "memory");
}

// N consecutive floats of shared memory, N-float aligned (one vector load).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = p[0];
  }
}

// One butterfly step over lane bit `mask`: of N values, the lane keeps the
// half its bit selects (upper if set) plus its partner's copy of that half.
template <int N>
__device__ __forceinline__ void halve(const float (&x)[N], float (&y)[N / 2],
                                      int mask) {
  const bool upper = (threadIdx.x & mask) != 0;
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float send = upper ? x[q] : x[q + N / 2];
    const float keep = upper ? x[q + N / 2] : x[q];
    y[q] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// x[t] summed over the 8 lanes of an octet (lanes 8o .. 8o + 7), reduced
// and scattered: lane g of the octet gets the sums for t = g C/8 + q, q <
// C/8, in y[q] (7C/8 shuffles, not 3C).
template <int C>
__device__ __forceinline__ void octet_sum(const float (&x)[C],
                                          float (&y)[C / 8]) {
  float h[C / 2], f[C / 4];
  halve<C>(x, h, 4);
  halve<C / 2>(h, f, 2);
  halve<C / 4>(f, y, 1);
}

// x[t] (N a power of two, at most 32) summed over the warp's 32 lanes;
// lane L returns the sum for t = L / (32 / N).
template <int N>
__device__ __forceinline__ float warp_sum(const float (&x)[N],
                                          int mask = 16) {
  if constexpr (N == 1) {
    float y = x[0];
    for (int m = mask; m > 0; m >>= 1) {
      y += __shfl_xor_sync(0xffffffffu, y, m);
    }
    return y;
  } else {
    float h[N / 2];
    halve<N>(x, h, mask);
    return warp_sum<N / 2>(h, mask >> 1);
  }
}

// The producers' work for one chunk of n steps whose r, k, w rows lie at
// rs, ks, ws (zeros past n): q, kd, P_{n-1} and A into der.  ptid: the
// thread among the producers.
template <int DK, int C>
__device__ __forceinline__ void derive(const float* rs, const float* ks,
                                       const float* ws, const float* us,
                                       int n, float* der, int ptid) {
  using L = Chunked<DK, C>;
  constexpr int CPL = L::CPL, NS = L::NS;
  float* const qs = der;                  // [C][DK] r_t * P_{t-1}
  float* const kds = qs + C * DK;         // [C][DK] k_s * prod_{s<tau<n} w
  float* const pend = kds + C * DK;       // [DK] P_{n-1}
  float* const as = pend + DK;            // [C][C + 1] A[t][s], s <= t

  // (a) per channel: q_t = r_t * P_{t-1}, P_{n-1}, and kd_s = k_s times
  // the product of w after s (steps past n count as w = 1, k = 0); the
  // loads first, then the chain
  for (int i = ptid; i < 2 * DK; i += kHalfThreads) {
    const int ch = i % DK;
    const float* const xs = i < DK ? rs : ks;
    float x[C], y[C];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      x[t] = xs[t * DK + ch];
      y[t] = t < n ? ws[t * DK + ch] : 1.f;
    }
    float pr = 1.f;
    if (i < DK) {
#pragma unroll
      for (int t = 0; t < C; ++t) {
        qs[t * DK + ch] = x[t] * pr;
        pr *= y[t];
      }
      pend[ch] = pr;
    } else {
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        kds[t * DK + ch] = x[t] * pr;
        pr *= y[t];
      }
    }
  }

  // (b) A[t][sb] for t > sb, A[sb][sb] = r . (u * k): producer warp pw
  // takes the steps sb = pw + 4 ns, each lane CPL channels, carrying k_sb
  // times the running product of w along t (selects, no branches); one
  // load of r_t and w_t serves the warp's NS steps, and the lanes' sums
  // are reduced and scattered across the warp
  const int lane = ptid & 31, pw = ptid >> 5;
  const int c0 = lane * CPL;
  float ku[NS][CPL], e[NS][CPL], x[NS][C];
  {
    float uu[CPL];
    load_vec(us + c0, uu);
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
      load_vec(ks + (pw + 4 * ns) * DK + c0, e[ns]);
#pragma unroll
      for (int m = 0; m < CPL; ++m) ku[ns][m] = e[ns][m] * uu[m];
    }
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    float rr[CPL], ww[CPL];
    load_vec(rs + t * DK + c0, rr);
    load_vec(ws + t * DK + c0, ww);
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
      const int sb = pw + 4 * ns;
      const bool diag = t == sb, after = t > sb;
      float y = 0.f;
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        y += rr[m] * (diag ? ku[ns][m] : e[ns][m]);
        e[ns][m] *= after ? ww[m] : 1.f;
      }
      x[ns][t] = diag || after ? y : 0.f;
    }
  }
#pragma unroll
  for (int ns = 0; ns < NS; ++ns) {
    const float sum = warp_sum<C>(x[ns]);
    if (lane % (32 / C) == 0) {
      as[(lane / (32 / C)) * (C + 1) + pw + 4 * ns] = sum;
    }
  }
}

template <int DK, int C>
__global__ void __launch_bounds__(kChunkThreads)
linear_scan_chunked_kernel(const float* __restrict__ r,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ w,
                           const float* __restrict__ u, int u_rows,
                           const float* __restrict__ s0, float* __restrict__ o,
                           float* __restrict__ s_out, int t_len, int dv) {
  using L = Chunked<DK, C>;
  constexpr int RPT = L::RPT, CPT = kColsPerThread;
  extern __shared__ __align__(16) float sm[];   // input stages 0-2, then:
  float* const der0 = sm + 3 * L::STAGE;  // derived stages 0-1
  float* const us = der0 + 2 * L::DERIVED;  // [DK] u, zeros without it

  const int tid = threadIdx.x;
  const bool producer = tid >= kHalfThreads;
  const int ptid = tid - kHalfThreads;
  const long long bh = blockIdx.x;
  const int j0 = blockIdx.y * kTileJ;
  const float* const rb = r + bh * t_len * DK;
  const float* const kb = k + bh * t_len * DK;
  const float* const wb = w + bh * t_len * DK;
  const float* const vb = v + bh * t_len * dv;
  float* const ob = o + bh * t_len * dv;
  const int n_chunks = (t_len + C - 1) / C;
  const auto stage = [&](int c) { return sm + (c % 3) * L::STAGE; };
  const auto steps = [&](int c) { return min(C, t_len - c * C); };

  // producers: chunk c's rows of r, k, w (16 bytes a copy) and its v tile
  // into stage c % 3, zeros past T and past dv
  const auto load = [&](int c) {
    float* const st = stage(c);
    const int t0 = c * C, n = steps(c);
    for (int e = 4 * ptid; e < C * DK; e += 4 * kHalfThreads) {
      const bool in = e < n * DK;
      const long long off = in ? static_cast<long long>(t0) * DK + e : 0;
      cp_async16(st + e, rb + off, in);
      cp_async16(st + C * DK + e, kb + off, in);
      cp_async16(st + 2 * C * DK + e, wb + off, in);
    }
    for (int e = ptid; e < C * kTileJ; e += kHalfThreads) {
      const int t = e / kTileJ, jj = e % kTileJ;
      const bool in = t < n && j0 + jj < dv;
      cp_async4(st + 3 * C * DK + e,
                vb + (in ? static_cast<long long>(t0 + t) * dv + j0 + jj : 0),
                in);
    }
  };
  const auto derive_chunk = [&](int c) {
    const float* const st = stage(c);
    derive<DK, C>(st, st + C * DK, st + 2 * C * DK, us, steps(c),
                  der0 + (c & 1) * L::DERIVED, ptid);
  };

  // consumers: rows g + 8 m of columns j0 + a + kColStride cc of S
  const int g = tid & (kGroups - 1);
  const int a = (tid % kHalfThreads) / kGroups;
  bool col[CPT];
  float s[CPT][RPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int j = j0 + a + kColStride * cc;
    col[cc] = !producer && j < dv;
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      s[cc][m] = (s0 != nullptr && col[cc])
                     ? s0[(bh * DK + g + 8 * m) * dv + j] : 0.f;
    }
  }

  if (producer) {
    for (int i = ptid; i < DK; i += kHalfThreads) {
      us[i] = u != nullptr ? u[(bh % u_rows) * DK + i] : 0.f;
    }
    load(0);
    cp_async_commit();
    if (n_chunks > 1) load(1);
    cp_async_commit();
    cp_async_wait1();                     // this thread's copies of chunk 0
    producers_sync();                     // and every producer's, and u
    derive_chunk(0);
  }
  __syncthreads();

  // Chunk c: the consumers take its outputs and its state update from S0
  // while the producers copy chunk c + 2 and derive chunk c + 1.
  for (int c = 0; c < n_chunks; ++c) {
    if (producer) {
      if (c + 1 < n_chunks) {
        if (c + 2 < n_chunks) load(c + 2);
        cp_async_commit();
        cp_async_wait1();                 // chunk c + 1 has landed
        producers_sync();
        derive_chunk(c + 1);
      }
    } else {
      const float* const der = der0 + (c & 1) * L::DERIVED;
      const float* const qs = der;
      const float* const kds = qs + C * DK;
      const float* const pend = kds + C * DK;
      const float* const as = pend + DK;
      const float* const vs = stage(c) + 3 * C * DK;
      const int t0 = c * C, n = steps(c);

      // (c) o_t[j] = q_t . S0[:, j] + sum_{s <= t} A[t][s] v_s[j], rows
      // t = g C/8 + q of the thread's columns
      float part[CPT][C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) part[cc][t] = 0.f;
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          const float q = qs[t * DK + g + 8 * m];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) part[cc][t] += q * s[cc][m];
        }
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        float inter[C / 8];
        octet_sum<C>(part[cc], inter);
#pragma unroll
        for (int q = 0; q < C / 8; ++q) {
          const int t = g * (C / 8) + q;
          float y = inter[q];
#pragma unroll
          for (int sb = 0; sb < C; ++sb) {
            if (sb <= t) {
              y += as[t * (C + 1) + sb] * vs[sb * kTileJ + a + kColStride * cc];
            }
          }
          if (col[cc] && t < n) {
            ob[static_cast<long long>(t0 + t) * dv + j0 + a +
               kColStride * cc] = y;
          }
        }
      }

      // (d) S_end = diag(P_{n-1}) S0 + sum_s kd_s^T v_s
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const float p = pend[g + 8 * m];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) s[cc][m] *= p;
      }
#pragma unroll
      for (int sb = 0; sb < C; ++sb) {
        float vj[CPT];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          vj[cc] = vs[sb * kTileJ + a + kColStride * cc];
        }
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          const float kd = kds[sb * DK + g + 8 * m];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) s[cc][m] += kd * vj[cc];
        }
      }
    }
    __syncthreads();      // chunk c's stages are free, chunk c + 1's ready
  }
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    if (col[cc]) {
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        s_out[(bh * DK + g + 8 * m) * dv + j0 + a + kColStride * cc] =
            s[cc][m];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const float *r, *k, *v, *w, *u;
  int u_rows;
  const float* s0;
  float *o, *s_out;
  int bh, t_len, dv;
  cudaStream_t stream;
};

template <int DK>
int launch_sequential(const Args& a) {
  const dim3 grid(a.bh, (a.dv + kWarp - 1) / kWarp);
  linear_scan_kernel<DK><<<grid, kWarp, 0, a.stream>>>(
      a.r, a.k, a.v, a.w, a.u, a.u_rows, a.s0, a.o, a.s_out, a.t_len, a.dv);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int C>
int launch_chunked(const Args& a) {
  constexpr int smem = Chunked<DK, C>::SMEM;
  const cudaError_t set =
      smem > 48 * 1024
          ? repro::once_per_device([] {
              return cudaFuncSetAttribute(
                  linear_scan_chunked_kernel<DK, C>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                  Chunked<DK, C>::SMEM);
            })
          : cudaSuccess;
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(a.bh, (a.dv + kTileJ - 1) / kTileJ);
  linear_scan_chunked_kernel<DK, C><<<grid, kChunkThreads, smem, a.stream>>>(
      a.r, a.k, a.v, a.w, a.u, a.u_rows, a.s0, a.o, a.s_out, a.t_len, a.dv);
  return static_cast<int>(cudaGetLastError());
}

// chunk: C of the chunked body (0: kDefaultChunk; 16 only at Dk 64, for
// the card's sweep).  T < C, Dk under 32, and r, k or w not on a 16-byte
// boundary (the chunked body copies them 16 bytes at a time) take the
// sequential body.
template <int DK>
int launch(const Args& a, int chunk) {
  const int c = chunk == 0 ? kDefaultChunk : chunk;
  if (c != kDefaultChunk && (DK != 64 || c != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.r) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.w)) & 15) == 0;
  if constexpr (DK < 32) {
    return launch_sequential<DK>(a);
  } else {
    if (a.t_len < c || !aligned) return launch_sequential<DK>(a);
    if constexpr (DK == 64) {
      if (c == 16) return launch_chunked<DK, 16>(a);
    }
    return launch_chunked<DK, kDefaultChunk>(a);
  }
}

}  // namespace

extern "C" int repro_linear_scan(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, int u_rows,
                                 const void* s0, void* o, void* s_out, int bh,
                                 int t_len, int dk, int dv, int chunk,
                                 void* stream) {
  if (bh < 1 || t_len < 0 || dv < 1 || (dv + kWarp - 1) / kWarp > 65535 ||
      (dv + kTileJ - 1) / kTileJ > 65535 || (u != nullptr && u_rows < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), u_rows,
               static_cast<const float*>(s0), static_cast<float*>(o),
               static_cast<float*>(s_out), bh, t_len, dv,
               static_cast<cudaStream_t>(stream)};
  switch (dk) {
    case 8: return launch<8>(a, chunk);
    case 16: return launch<16>(a, chunk);
    case 32: return launch<32>(a, chunk);
    case 64: return launch<64>(a, chunk);
    case 128: return launch<128>(a, chunk);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
