// Backward of the matrix-state linear recurrence of linear_scan.cu:
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//
// Replaces no TPU kernel: the reference has no backward Pallas kernel and
// differentiates its jnp scans (src/repro/models/rwkv.py::time_mix_forward
// through scan_utils.chunked_scan, src/repro/models/ssm.py::_ssd_chunked).
// This is the gradient jax.grad takes through them, for the port's
// training path, where the forward is the linear_scan kernel.
//
// Contract: the plain version linear_scan_bwd_ref (linear_scan/ref.py).
// Given do [BH, T, Dv] and dS_T [BH, Dk, Dv] (null: zero), with G_t the
// gradient of the state after step t, from t = T down to 1:
//   dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
//   dk_t = G_t v_t + r_t * u (v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . u * k_t) do_t
//   dw_t = rowsum(G_t * S_{t-1})
//   du  += r_t * k_t (v_t . do_t)      (summed over the rows sharing u)
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t,   ds0 = G_0.
// All f32 and contiguous, Dv up to 128; u, s0, dS_T, du and ds0 may be
// null.
//
// What bounds it: at hymba-1.5b's training shape (BH 25, T 128, Dk 16,
// Dv 64) the function reads 2.2 MB and writes 1.3 MB (~1 us at HBM rate)
// and needs ~3 MFLOP.  What takes the time is one bh's dependent steps in
// T (a forward walk to rebuild the states, then the reverse walk) and the
// shared memory every step passes through: S_{t-1} and G_t of each step,
// written by the walks and read back by the sums (~20 KB a step at that
// shape).  Element (i, j) of S and of G only ever meets row i of r, k, w
// and column j of v, do: the recurrences are elementwise, rows are
// independent, and every sum (over columns for dk, dw, dr; over rows for
// dv) can wait until a chunk of steps is done.
//
// Design: a thread-block cluster of CL blocks a bh (CL = min(8, Dk / 4)),
// block b owning rows [b RB, b RB + RB), RB = Dk / CL, and every Dv
// column (4 x 32 ceil(Dv / 32) threads; thread (slice, j) holds rows
// [slice R, slice R + R) of column j, R = RB / 4), so the shared-memory
// traffic of a bh spreads over CL SMs.
//  * A first walk runs the forward from s0 and keeps the state at the
//    start of every chunk of C steps in scratch (C: the most steps whose
//    buffers fit ~110 KB of shared memory, at most 32; chunk_len).  The
//    reverse walk, chunk by chunk from the last, takes the chunk's inputs
//    and start state staged by cp.async while the chunk before was
//    worked, writes the C states S_{t-1} to shared memory, then walks
//    backwards writing G_t beside them (rows padded to cols + 1 floats,
//    so every pattern of access meets 32 banks): each thread's chain is
//    its own elements' two FMAs a step, with no shuffle or barrier.
//  * Then the block forms the chunk's sums from shared memory in a fixed
//    order: dk, dw and dr of four rows at a step over the columns (four
//    lanes an item, joined by a shuffle tree), and each column's share of
//    dv over the block's rows.  The CL shares of dv sum in rank order
//    through distributed shared memory, each block writing 1 / CL of them
//    (one cluster barrier a chunk: the shares alternate between two
//    buffers).  The u terms take v_t . do_t and the block's share of
//    r_t . (u * k_t) a step, 8 lanes' shuffle sum each, off the chain;
//    du sums a bh's steps in one thread a row, then
//    linear_scan_bwd_du_kernel sums the rows sharing u in order.  No float
//    atomics: two calls give the same bits.
//
// Where a block's time goes at hymba's shape (kernels/bwd_trace.py,
// 57,000 cycles): the chain walks 23 %, the cluster's dv sum 19 %, the
// row sums 15 %, the forward walk 15 %, dv's shares 13 %, waits 8 %.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it), no spills:
//   linear_scan_bwd_kernel 96 registers at Dk 8, 16 and 32, 112 at 64
//   and 128; linear_scan_bwd_du_kernel 22.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kSlices = 4;                 // row slices of a column
constexpr int kMaxThreads = kSlices * 128;
constexpr int kMaxDv = 128;
constexpr int kMaxChunk = 32;
constexpr int kSmemBytes = 110 * 1024;

// Blocks of a bh's cluster and the rows each owns.
__host__ __device__ constexpr int cluster_of(int dk) {
  return dk / 4 < 8 ? dk / 4 : 8;
}
__host__ __device__ constexpr int rows_of(int dk) {
  return dk / cluster_of(dk);
}

// Columns a row slice holds: Dv up to a multiple of 32.
__host__ __device__ constexpr int cols(int dv) { return (dv + 31) / 32 * 32; }

// The staged v and do rows: cols + 4 floats (16-byte rows; the lanes of a
// row sum that span several steps meet distinct banks).
__host__ __device__ constexpr int v_pitch(int dv) { return cols(dv) + 4; }

// G and S of a step lie as [RB][pitch], pitch = cols + 1: a walk's store
// and a dv share's load (lanes on consecutive columns) and a row sum's
// loads (lanes on 4 columns of 8 row groups or steps, RB pitch apart)
// each meet 32 banks.
__host__ __device__ constexpr int pitch(int dv) { return cols(dv) + 1; }
__host__ __device__ constexpr int ts(int rb, int dv) {
  return rb * pitch(dv);
}

// Floats of shared memory a step of a chunk takes: r, k, w (RB each) and
// v, do (vp each) in two stages; G and S (ts each); v . do and the
// block's share of r . (u * k); dv's shares in two buffers (cols each).
// Once: u's rows (RB) and a chunk's start state (RB x cols).
__host__ __device__ constexpr int step_floats(int dk, int dv) {
  return 2 * (3 * rows_of(dk) + 2 * v_pitch(dv)) +
         2 * ts(rows_of(dk), dv) + 2 + 2 * cols(dv);
}
__host__ __device__ constexpr int once_floats(int dk, int dv) {
  return rows_of(dk) + rows_of(dk) * cols(dv);
}

// C: linear_scan/ops.py bwd_chunk computes the same.
__host__ __device__ constexpr int chunk_len(int dk, int dv) {
  const int c = (kSmemBytes / 4 - once_floats(dk, dv)) / step_floats(dk, dv);
  return c < kMaxChunk ? c : kMaxChunk;
}

// global -> shared, asynchronously, zeros where !pred: 4 bytes through L1
// or 16 through L2.
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V consecutive floats (V = 1, 2 or 4) as one shared-memory access.
template <int V>
__device__ __forceinline__ void load_v(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

struct Args {
  const float *r, *k, *v, *w, *u;
  int u_rows;
  const float *s0, *dout, *ds_t;
  float *ckpt, *du_part, *dr, *dk, *dv, *dw, *du, *ds0;
  int bh, t_len, dv_n;
  cudaStream_t stream;
};

// The chain: n steps of x <- w * x + a * b over a thread's R rows (from
// r0 of the block's RB; a, b: k and v for S, r and do for G), forward or
// backward in time, each x first written to out at its step (S_{t-1} or
// G_t; out points at the thread's first row and column) when out is
// given.  The operands of U steps are loaded before their updates, whose
// stores the compiler may not move them past.
template <int RB, int R>
__device__ __forceinline__ void store_rows(float* out, const float (&x)[R],
                                           int pt) {
#pragma unroll
  for (int i = 0; i < R; ++i) out[i * pt] = x[i];
}
template <int RB, int R>
__device__ __forceinline__ void walk(float (&x)[R], const float* wm,
                                     const float* am, const float* bv,
                                     float* out, int n, bool backward,
                                     int r0, int j, int vp, int tstride,
                                     int pt) {
  constexpr int U = 8 / R;
  auto step = [&](int m) { return backward ? n - 1 - m : m; };
  int m = 0;
  for (; m + U <= n; m += U) {
    float wr[U][R], ar[U][R], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tt = step(m + u);
      load_v<R>(wr[u], wm + tt * RB + r0);
      load_v<R>(ar[u], am + tt * RB + r0);
      b[u] = bv[tt * vp + j];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (out != nullptr) store_rows<RB, R>(out + step(m + u) * tstride, x, pt);
#pragma unroll
      for (int i = 0; i < R; ++i) x[i] = fmaf(wr[u][i], x[i], ar[u][i] * b[u]);
    }
  }
  for (; m < n; ++m) {
    const int tt = step(m);
    float wr[R], ar[R];
    load_v<R>(wr, wm + tt * RB + r0);
    load_v<R>(ar, am + tt * RB + r0);
    const float b = bv[tt * vp + j];
    if (out != nullptr) store_rows<RB, R>(out + tt * tstride, x, pt);
#pragma unroll
    for (int i = 0; i < R; ++i) x[i] = fmaf(wr[i], x[i], ar[i] * b);
  }
}

// A chunk's staged inputs: [C][RB] r, k, w and [C][vp] v, do.
struct Stage {
  float *r, *k, *w, *v, *d;
};

// dk, dw and dr of the block's rows [i, i + 4) at step tt, summed over the
// columns by kLanes lanes (lane l the columns l, l + kLanes, ..., then a
// fixed tree over the lanes); every lane of the warp calls it, active or
// not.
constexpr int kLanes = 4;
template <int RB>
__device__ __forceinline__ void row_sums(bool active, int tt, int i, int l,
                                         const float* gb, const float* sb,
                                         const Stage& sg, const float* us,
                                         const float* vdo, bool with_u,
                                         int dv, int vp, int tstride,
                                         int pt, float* dk, float* dw,
                                         float* dr) {
  float x[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    const float* gr = gb + tt * tstride + i * pt;
    const float* sr = sb + tt * tstride + i * pt;
    const float* vr = sg.v + tt * vp;
    const float* dr_ = sg.d + tt * vp;
#pragma unroll 4
    for (int jj = l; jj < dv; jj += kLanes) {
      float gv[4], sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[e] = gr[e * pt + jj];
        sv[e] = sr[e * pt + jj];
      }
      const float vj = vr[jj], dj = dr_[jj];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = fmaf(gv[e], vj, x[e]);              // dk
        x[4 + e] = fmaf(gv[e], sv[e], x[4 + e]);   // dw
        x[8 + e] = fmaf(sv[e], dj, x[8 + e]);      // dr
      }
    }
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 12; ++e) x[e] += __shfl_xor_sync(0xffffffffu, x[e], o);
  }
  if (!active || l != 0) return;
  if (with_u) {
    const float z = vdo[tt];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[8 + e] = fmaf(us[i + e] * sg.k[tt * RB + i + e], z, x[8 + e]);
      x[e] = fmaf(sg.r[tt * RB + i + e] * us[i + e], z, x[e]);
    }
  }
  store4(dk, x);
  store4(dw, x + 4);
  store4(dr, x + 8);
}

template <int DK>
__global__ void __launch_bounds__(kMaxThreads, 1)
linear_scan_bwd_kernel(const Args a) {
  constexpr int CL = cluster_of(DK), RB = rows_of(DK);
  constexpr int R = RB / kSlices;            // rows a thread holds
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int dv = a.dv_n, dvc = cols(dv), vp = v_pitch(dv);
  const int tstride = ts(RB, dv), pt = pitch(dv);
  const int c_len = chunk_len(DK, dv);
  const int nt = kSlices * dvc;
  float* us = smem;                          // [RB] u's rows
  float* cks = us + RB;                      // [RB][dvc] a chunk's start
  float* stages = cks + RB * dvc;            // two Stages
  const int stage_floats = 3 * c_len * RB + 2 * c_len * vp;
  auto stage = [&](int c) {
    float* p = stages + (c & 1) * stage_floats;
    return Stage{p, p + c_len * RB, p + 2 * c_len * RB, p + 3 * c_len * RB,
                 p + 3 * c_len * RB + c_len * vp};
  };
  float* gb = stages + 2 * stage_floats;     // [C][tstride] G_t
  float* sb = gb + c_len * tstride;          // [C][tstride] S_{t-1}
  float* dvs = sb + c_len * tstride;         // [2][C][dvc] dv's shares
  float* vdo = dvs + 2 * c_len * dvc;        // [C] v_t . do_t
  float* ruk = vdo + c_len;                  // [C] the rows' r_t . (u k_t)

  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / CL, row0 = rank * RB, tid = threadIdx.x;
  const int j = tid % dvc, r0 = tid / dvc * R;
  const bool col = j < dv;
  const int t_len = a.t_len;
  const int chunks = (t_len + c_len - 1) / c_len;
  const long long base_k = static_cast<long long>(bh) * t_len * DK + row0;
  const long long base_v = static_cast<long long>(bh) * t_len * dv;
  const long long plane = static_cast<long long>(DK) * dv;
  // this block's rows of the state and of each chunk's start
  const long long at_s = bh * plane + static_cast<long long>(row0) * dv;
  float* ck = a.ckpt + static_cast<long long>(bh) * chunks * plane +
              static_cast<long long>(row0) * dv;
  const bool with_u = a.u != nullptr;
  // 16-byte copies where every row starts on a 16-byte boundary
  const bool vec = dv % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.r) |
                     reinterpret_cast<uintptr_t>(a.k) |
                     reinterpret_cast<uintptr_t>(a.w) |
                     reinterpret_cast<uintptr_t>(a.v) |
                     reinterpret_cast<uintptr_t>(a.dout) |
                     reinterpret_cast<uintptr_t>(a.ckpt)) & 15) == 0;
  for (int i = tid; i < RB; i += nt) {
    us[i] = with_u ? a.u[(bh % a.u_rows) * DK + row0 + i] : 0.f;
  }

  // chunk c's inputs into stage c % 2, asynchronously (zeros past T and
  // past Dv); r and do only for the reverse walk.  Not committed.
  auto load = [&](int c, bool reverse) {
    const Stage sg = stage(c);
    const int t0 = c * c_len, n = min(c_len, t_len - t0);
    const int e = vec ? 4 : 1;
    for (int x = tid * e; x < c_len * RB; x += nt * e) {
      const int tt = x / RB;
      const bool in = tt < n;
      const long long at =
          in ? base_k + static_cast<long long>(t0 + tt) * DK + x % RB : 0;
      if (vec) {
        cp_async16(sg.k + x, a.k + at, in);
        cp_async16(sg.w + x, a.w + at, in);
        if (reverse) cp_async16(sg.r + x, a.r + at, in);
      } else {
        cp_async4(sg.k + x, a.k + at, in);
        cp_async4(sg.w + x, a.w + at, in);
        if (reverse) cp_async4(sg.r + x, a.r + at, in);
      }
    }
    for (int x = tid * e; x < c_len * dvc; x += nt * e) {
      const int tt = x / dvc, jj = x % dvc;
      const bool in = tt < n && jj < dv;
      const long long at =
          in ? base_v + static_cast<long long>(t0 + tt) * dv + jj : 0;
      if (vec) {
        cp_async16(sg.v + tt * vp + jj, a.v + at, in);
        if (reverse) cp_async16(sg.d + tt * vp + jj, a.dout + at, in);
      } else {
        cp_async4(sg.v + tt * vp + jj, a.v + at, in);
        if (reverse) cp_async4(sg.d + tt * vp + jj, a.dout + at, in);
      }
    }
  };
  // chunk c's start state (the block's rows) into cks, rows of dvc floats
  auto load_start = [&](int c) {
    const float* src = ck + c * plane;
    if (vec) {
      for (int x = tid * 4; x < RB * dvc; x += nt * 4) {
        const int i = x / dvc, jj = x % dvc;
        cp_async16(cks + x, src + (jj < dv ? i * dv + jj : 0), jj < dv);
      }
    } else {
      for (int x = tid; x < RB * dvc; x += nt) {
        const int i = x / dvc, jj = x % dvc;
        cks[x] = jj < dv ? __ldcg(src + i * dv + jj) : 0.f;
      }
    }
  };

  float s[R], g[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = (a.s0 != nullptr && col) ? a.s0[at_s + (r0 + i) * dv + j] : 0.f;
  }
  // walk 1: forward from s0, keeping the state at each chunk's start;
  // chunk c + 1's inputs arrive while chunk c is walked
  if (chunks > 1) {
    load(0, false);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    if (col) {
#pragma unroll
      for (int i = 0; i < R; ++i) ck[c * plane + (r0 + i) * dv + j] = s[i];
    }
    if (c == chunks - 1) break;
    if (c + 2 < chunks) {
      load(c + 1, false);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage sg = stage(c);
    walk<RB, R>(s, sg.w, sg.k, sg.v, nullptr, c_len, false, r0, j, vp,
                tstride, pt);
    __syncthreads();                           // before the stage refills
  }
  __syncthreads();                             // the checkpoints, block-wide

#pragma unroll
  for (int i = 0; i < R; ++i) {
    g[i] = (a.ds_t != nullptr && col) ? a.ds_t[at_s + (r0 + i) * dv + j]
                                      : 0.f;
  }
  float du_acc = 0.f;                          // thread i < RB: du's row i
  const int warp = tid / kWarp, lane = tid % kWarp, n_warps = nt / kWarp;
  if (chunks > 0) {
    load(chunks - 1, true);
    load_start(chunks - 1);
    cp_async_commit();
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * c_len;
    const int n = min(c_len, t_len - t0);
    const Stage sg = stage(c);
    float* dvm = dvs + (c & 1) * c_len * dvc;  // this chunk's dv shares
    // chunk c - 1's inputs arrive while this one is walked and summed; its
    // start state once this one's has been read
    if (c > 0) {
      load(c - 1, true);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = cks[(r0 + i) * dvc + j];
    // walk 2, the chain: the chunk's states S_{t-1}, then G_t backwards,
    // each thread its own elements
    const int own = r0 * pt + j;               // this thread's first element
    walk<RB, R>(s, sg.w, sg.k, sg.v, sb + own, n, false, r0, j, vp, tstride,
                pt);
    walk<RB, R>(g, sg.w, sg.r, sg.d, gb + own, n, true, r0, j, vp, tstride,
                pt);
    // the u terms' two dot products a step, 8 lanes a step (lane g the
    // terms g, g + 8, ..., then a fixed tree over the 8)
    if (with_u) {
      const int g8 = lane % 8;
      for (int t8 = warp * 4; t8 < n; t8 += n_warps * 4) {
        const int tt = t8 + lane / 8;
        float x = 0.f, y = 0.f;
        if (tt < n) {
          for (int jj = g8; jj < dv; jj += 8) {
            x = fmaf(sg.v[tt * vp + jj], sg.d[tt * vp + jj], x);
          }
          for (int i = g8; i < RB; i += 8) {
            y = fmaf(sg.r[tt * RB + i] * us[i], sg.k[tt * RB + i], y);
          }
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, o);
          y += __shfl_xor_sync(0xffffffffu, y, o);
        }
        if (g8 == 0 && tt < n) {
          vdo[tt] = x;
          ruk[tt] = y;
        }
      }
    }
    __syncthreads();
    if (c > 0) {
      load_start(c - 1);
      cp_async_commit();
    }
    // the sums, in a fixed order: dk, dw and dr of four rows at a step
    // (over the columns, four lanes an item); dv's share of a column at a
    // step (over the block's rows, a thread an item)
    const int items = n * (RB / 4);
    for (int b = 0; b < items * kLanes; b += nt) {
      const int q = b + tid, item = q / kLanes, l = q % kLanes;
      const bool active = item < items;
      const int tt = active ? item / (RB / 4) : 0;
      const int i = item % (RB / 4) * 4;
      const long long at = base_k + static_cast<long long>(t0 + tt) * DK + i;
      row_sums<RB>(active, tt, i, l, gb, sb, sg, us, vdo, with_u, dv, vp,
                   tstride, pt, a.dk + at, a.dw + at, a.dr + at);
    }
    for (int q = tid; q < n * dvc; q += nt) {
      const int tt = q / dvc, jj = q % dvc;
      const float* gc = gb + tt * tstride + jj;
      const float* kr = sg.k + tt * RB;
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < RB; i += 4) {
        float k4[4];
        load_v<4>(k4, kr + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) x = fmaf(gc[(i + e) * pt], k4[e], x);
      }
      if (with_u) x = fmaf(ruk[tt], sg.d[tt * vp + jj], x);
      dvm[q] = x;
    }
    if (with_u && tid < RB) {
      for (int tt = 0; tt < n; ++tt) {
        du_acc = fmaf(sg.r[tt * RB + tid] * sg.k[tt * RB + tid], vdo[tt],
                      du_acc);
      }
    }
    // dv: the cluster's shares in rank order, this block 1 / CL of them
    cluster.sync();
    for (int q = rank * nt + tid; q < n * dv; q += CL * nt) {
      const int tt = q / dv, jj = q % dv;
      float x = 0.f;
#pragma unroll
      for (int b = 0; b < CL; ++b) {
        x += cluster.map_shared_rank(dvm, b)[tt * dvc + jj];
      }
      a.dv[base_v + static_cast<long long>(t0 + tt) * dv + jj] = x;
    }
  }
  if (a.ds0 != nullptr && col) {
#pragma unroll
    for (int i = 0; i < R; ++i) a.ds0[at_s + (r0 + i) * dv + j] = g[i];
  }
  if (with_u && tid < RB) a.du_part[bh * DK + row0 + tid] = du_acc;
  cluster.sync();                    // no block leaves while read from
}

// One thread a (row of u, channel): the bh rows' du, h, h + u_rows, ...
// in that order.
__global__ void linear_scan_bwd_du_kernel(const float* __restrict__ du_part,
                                          float* __restrict__ du, int u_rows,
                                          int n_bh, int d_k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= u_rows * d_k) return;
  const int h = idx / d_k, i = idx % d_k;
  float x = 0.f;
  for (int bh = h; bh < n_bh; bh += u_rows) x += du_part[bh * d_k + i];
  du[idx] = x;
}

template <int DK>
int launch(const Args& a) {
  const int smem = (once_floats(DK, a.dv_n) +
                    chunk_len(DK, a.dv_n) * step_floats(DK, a.dv_n)) *
                   static_cast<int>(sizeof(float));
  const cudaError_t set = repro::once_per_device([] {
    return cudaFuncSetAttribute(linear_scan_bwd_kernel<DK>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.bh * cluster_of(DK)));
  cfg.blockDim = dim3(kSlices * cols(a.dv_n));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cluster_of(DK);   // a bh's row blocks
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, linear_scan_bwd_kernel<DK>, a);
  if (e != cudaSuccess || a.u == nullptr || a.du == nullptr) {
    return static_cast<int>(e);
  }
  linear_scan_bwd_du_kernel<<<(a.u_rows * DK + 127) / 128, 128, 0,
                              a.stream>>>(a.du_part, a.du, a.u_rows, a.bh,
                                          DK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch (scratch_floats floats): the state at each chunk's start
// ([BH][ceil(T / C)][Dk][Dv]) and, with u, each bh's du ([BH][Dk]), as
// linear_scan/ops.py bwd_scratch_floats counts them.
extern "C" int repro_linear_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    int u_rows, const void* s0, const void* dout, const void* ds_t,
    void* scratch, long long scratch_floats, void* dr, void* dk, void* dv,
    void* dw, void* du, void* ds0, int bh, int t_len, int d_k, int dv_n,
    void* stream) {
  if (bh < 1 || t_len < 0 || dv_n < 1 || dv_n > kMaxDv ||
      (u != nullptr && (u_rows < 1 || bh % u_rows != 0)) ||
      (d_k != 8 && d_k != 16 && d_k != 32 && d_k != 64 && d_k != 128) ||
      static_cast<long long>(bh) * cluster_of(d_k) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* ckpt = static_cast<float*>(scratch);
  const long long chunks =
      (t_len + chunk_len(d_k, dv_n) - 1) / chunk_len(d_k, dv_n);
  if (scratch_floats < bh * chunks * d_k * dv_n +
                           (u != nullptr ? static_cast<long long>(bh) * d_k
                                         : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), u_rows,
               static_cast<const float*>(s0), static_cast<const float*>(dout),
               static_cast<const float*>(ds_t), ckpt,
               ckpt + bh * chunks * d_k * dv_n, static_cast<float*>(dr),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(dw), static_cast<float*>(du),
               static_cast<float*>(ds0), bh, t_len, dv_n,
               static_cast<cudaStream_t>(stream)};
  switch (d_k) {
    case 8: return launch<8>(a);
    case 16: return launch<16>(a);
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    default: return launch<128>(a);
  }
}
