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
// All f32 and contiguous; u, s0, dS_T, du and ds0 may be null.
//
// What bounds it: at hymba-1.5b's training shape (BH 25, T 128, Dk 16,
// Dv 64) the function reads 2.2 MB and writes 1.3 MB (~1 us at HBM rate)
// and needs ~3 MFLOP; like the forward, it is bound by its chain of
// dependent steps in T, twice over (a forward pass to rebuild the states,
// then the reverse pass).
//
// Design (a simple body; the forward's chunked form is later work):
//  * S_{t-1} is needed at every reverse step.  The kernel re-runs the
//    forward from s0 itself and keeps the state at the start of every
//    chunk of C steps (C = 512 / Dk) in scratch; the reverse pass reloads a
//    chunk's start, recomputes its C states into shared memory, and walks
//    the chunk backwards.  Each chunk's r, k, w, v and do are first
//    staged in shared memory by the whole block (a step's reads would
//    otherwise each wait on L2).  The forward kernel is left exactly as
//    it is, so the serving path launches and times what it did.
//  * A block covers one bh and 32 columns of S (grid BH x ceil(Dv / 32)).
//    Column j of S and of G only ever meets column j of the inputs, so a
//    thread owns one column and R = min(Dk, 16) rows of it in registers;
//    Dk / R warps split the rows.  dv_t is then a sum over rows: per
//    thread, then over the warps in a fixed order through shared memory.
//  * dk_t, dw_t and dr_t are sums over columns: a shuffle reduction in
//    the warp, then over the column tiles in a second kernel, in tile
//    order.  The u terms need v_t . do_t over every column, so that kernel
//    adds them; a third sums du over t and the rows sharing u.  No float
//    atomics anywhere: two calls give the same bits.

#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kStateFloats = 16384;     // 64 KB of S_{t-1} a block

template <int DK>
struct Shape {
  static constexpr int R = DK < 16 ? DK : 16;     // rows a thread holds
  static constexpr int NS = DK / R;               // warps: row slices
  static constexpr int C = kStateFloats / (DK * kWarp);  // steps a chunk
  // S_{t-1} of a chunk, the dv partials, r . (u * k) a step, u's row,
  // and the chunk's r, k, w (C x DK each) and v, do (C x 32 each)
  static constexpr int FLOATS = C * DK * kWarp + NS * C * kWarp + C + DK +
                                3 * C * DK + 2 * C * kWarp;
  static constexpr int SMEM = FLOATS * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// part: [3][tiles][BH][T][DK] partial sums of dk, dw, dr over this tile's
// columns; ckpt: [BH][chunks][DK][Dv] the state at each chunk's start.
template <int DK>
__global__ void __launch_bounds__(Shape<DK>::NS * kWarp)
linear_scan_bwd_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ w,
                       const float* __restrict__ u, int u_rows,
                       const float* __restrict__ s0,
                       const float* __restrict__ dout,
                       const float* __restrict__ ds_t,
                       float* __restrict__ ckpt, float* __restrict__ part,
                       float* __restrict__ dv_out, float* __restrict__ ds0,
                       int n_bh, int t_len, int dv) {
  using Sh = Shape<DK>;
  constexpr int R = Sh::R, NS = Sh::NS, C = Sh::C;
  extern __shared__ float smem[];
  float* prev = smem;                          // [C][DK][32] S_{t-1}
  float* dvp = prev + C * DK * kWarp;          // [NS][C][32] dv partials
  float* ruk = dvp + NS * C * kWarp;           // [C] r_t . (u * k_t)
  float* us = ruk + C;                         // [DK] u's row
  float* rs = us + DK;                         // [C][DK] the chunk's r
  float* ks = rs + C * DK;                     // [C][DK] k
  float* ws = ks + C * DK;                     // [C][DK] w
  float* vs = ws + C * DK;                     // [C][32] v, this tile
  float* ds = vs + C * kWarp;                  // [C][32] do, this tile

  const int bh = blockIdx.x, tile = blockIdx.y, tiles = gridDim.y;
  const int slice = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int j = tile * kWarp + lane;
  const bool col = j < dv;
  const int i0 = slice * R;
  const long long base_k = static_cast<long long>(bh) * t_len * DK;
  const long long base_v = static_cast<long long>(bh) * t_len * dv;
  const int chunks = (t_len + C - 1) / C;
  float* ck = ckpt + static_cast<long long>(bh) * chunks * DK * dv;
  const long long plane = static_cast<long long>(n_bh) * t_len * DK;
  for (int i = threadIdx.x; i < DK; i += NS * kWarp) {
    us[i] = u != nullptr ? u[(bh % u_rows) * DK + i] : 0.f;
  }

  // the chunk at t0 into shared memory, every thread loading (zeros past
  // T and past Dv); r and do only for the reverse pass
  auto stage = [&](int t0, bool reverse) {
    const int n = min(C, t_len - t0) * DK;
    for (int x = threadIdx.x; x < C * DK; x += NS * kWarp) {
      const bool in = x < n;
      ks[x] = in ? k[base_k + static_cast<long long>(t0) * DK + x] : 0.f;
      ws[x] = in ? w[base_k + static_cast<long long>(t0) * DK + x] : 0.f;
      if (reverse) {
        rs[x] = in ? r[base_k + static_cast<long long>(t0) * DK + x] : 0.f;
      }
    }
    for (int x = threadIdx.x; x < C * kWarp; x += NS * kWarp) {
      const int tt = x / kWarp, jj = tile * kWarp + x % kWarp;
      const bool in = t0 + tt < t_len && jj < dv;
      const long long at = base_v + static_cast<long long>(t0 + tt) * dv + jj;
      vs[x] = in ? v[at] : 0.f;
      if (reverse) ds[x] = in ? dout[at] : 0.f;
    }
    __syncthreads();
  };

  float s[R], g[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = (s0 != nullptr && col)
               ? s0[(static_cast<long long>(bh) * DK + i0 + i) * dv + j]
               : 0.f;
  }
  // forward from s0, keeping the state at each chunk's start
  for (int c = 0; c < chunks; ++c) {
    if (col) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        ck[(static_cast<long long>(c) * DK + i0 + i) * dv + j] = s[i];
      }
    }
    if (c == chunks - 1) break;
    stage(c * C, false);
    for (int tt = 0; tt < C; ++tt) {
      const float vj = vs[tt * kWarp + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = ws[tt * DK + i0 + i] * s[i] + ks[tt * DK + i0 + i] * vj;
      }
    }
    __syncthreads();                           // before the next stage
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    g[i] = (ds_t != nullptr && col)
               ? ds_t[(static_cast<long long>(bh) * DK + i0 + i) * dv + j]
               : 0.f;
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * C;
    const int n = min(C, t_len - t0);
    stage(t0, true);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = col ? ck[(static_cast<long long>(c) * DK + i0 + i) * dv + j]
                 : 0.f;
    }
    // the chunk's states S_{t-1}, each thread its own column and rows
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * kWarp + lane];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        prev[(tt * DK + i0 + i) * kWarp + lane] = s[i];
        s[i] = ws[tt * DK + i0 + i] * s[i] + ks[tt * DK + i0 + i] * vj;
      }
    }
    // the chunk in reverse
    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float vj = vs[tt * kWarp + lane];
      const float doj = ds[tt * kWarp + lane];
      const float* rt = rs + tt * DK;
      const float* kt = ks + tt * DK;
      const float* wt = ws + tt * DK;
      if (u != nullptr && slice == 0) {
        float x = 0.f;
        for (int i = lane; i < DK; i += kWarp) x += rt[i] * us[i] * kt[i];
        x = warp_sum(x);
        if (lane == 0) ruk[tt] = x;
      }
      const long long at = (static_cast<long long>(bh) * t_len + t) * DK + i0;
      float pdv = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float sp = prev[(tt * DK + i0 + i) * kWarp + lane];
        pdv += g[i] * kt[i0 + i];
        const float a = warp_sum(g[i] * vj);      // dk over the tile
        const float b = warp_sum(g[i] * sp);      // dw
        const float e = warp_sum(sp * doj);       // dr
        if (lane == i) {
          part[(0 * tiles + tile) * plane + at + i] = a;
          part[(1 * tiles + tile) * plane + at + i] = b;
          part[(2 * tiles + tile) * plane + at + i] = e;
        }
      }
      dvp[(slice * C + tt) * kWarp + lane] = pdv;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        g[i] = wt[i0 + i] * g[i] + rt[i0 + i] * doj;
      }
    }
    __syncthreads();
    // dv_t: the row slices' partials in order, then the bonus term
    if (slice == 0 && col) {
      for (int tt = 0; tt < n; ++tt) {
        const long long o = base_v + static_cast<long long>(t0 + tt) * dv + j;
        float x = 0.f;
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) x += dvp[(sl * C + tt) * kWarp + lane];
        if (u != nullptr) x += ruk[tt] * ds[tt * kWarp + lane];
        dv_out[o] = x;
      }
    }
    __syncthreads();
  }
  if (ds0 != nullptr && col) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ds0[(static_cast<long long>(bh) * DK + i0 + i) * dv + j] = g[i];
    }
  }
}

// One thread a (bh, t): the column tiles' partials in tile order, plus
// the u terms (v_t . do_t kept in vdo for du).
__global__ void linear_scan_bwd_rows_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ u, int u_rows,
    const float* __restrict__ dout, const float* __restrict__ part,
    float* __restrict__ vdo, float* __restrict__ dr, float* __restrict__ dk,
    float* __restrict__ dw, int n_bh, int t_len, int d_k, int dv,
    int tiles) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long rows = static_cast<long long>(n_bh) * t_len;
  if (row >= rows) return;
  const long long plane = rows * d_k;
  float x = 0.f;
  const float* ub = nullptr;
  if (u != nullptr) {
    for (int j = 0; j < dv; ++j) x += v[row * dv + j] * dout[row * dv + j];
    vdo[row] = x;
    ub = u + (row / t_len % u_rows) * d_k;
  }
  for (int i = 0; i < d_k; ++i) {
    const long long at = row * d_k + i;
    float a = 0.f, b = 0.f, e = 0.f;
    for (int tl = 0; tl < tiles; ++tl) {
      a += part[(0 * tiles + tl) * plane + at];
      b += part[(1 * tiles + tl) * plane + at];
      e += part[(2 * tiles + tl) * plane + at];
    }
    if (ub != nullptr) {
      e += ub[i] * k[at] * x;
      a += r[at] * ub[i] * x;
    }
    dk[at] = a;
    dw[at] = b;
    dr[at] = e;
  }
}

// One thread a (row of u, channel): du summed over t, then over the rows
// bh = h, h + u_rows, ... in that order.
__global__ void linear_scan_bwd_du_kernel(const float* __restrict__ r,
                                          const float* __restrict__ k,
                                          const float* __restrict__ vdo,
                                          float* __restrict__ du, int u_rows,
                                          int n_bh, int t_len, int d_k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= u_rows * d_k) return;
  const int h = idx / d_k, i = idx % d_k;
  float x = 0.f;
  for (int bh = h; bh < n_bh; bh += u_rows) {
    for (int t = 0; t < t_len; ++t) {
      const long long row = static_cast<long long>(bh) * t_len + t;
      x += r[row * d_k + i] * k[row * d_k + i] * vdo[row];
    }
  }
  du[idx] = x;
}

struct Args {
  const float *r, *k, *v, *w, *u;
  int u_rows;
  const float *s0, *dout, *ds_t;
  float *scratch, *dr, *dk, *dv, *dw, *du, *ds0;
  int bh, t_len, dv_n;
  cudaStream_t stream;
};

template <int DK>
int launch(const Args& a) {
  using Sh = Shape<DK>;
  const cudaError_t set = repro::once_per_device([] {
    return cudaFuncSetAttribute(linear_scan_bwd_kernel<DK>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Sh::SMEM);
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tiles = (a.dv_n + kWarp - 1) / kWarp;
  const int chunks = (a.t_len + Sh::C - 1) / Sh::C;
  float* ckpt = a.scratch;
  float* part = ckpt + static_cast<long long>(a.bh) * chunks * DK * a.dv_n;
  float* vdo = part + 3LL * tiles * a.bh * a.t_len * DK;
  linear_scan_bwd_kernel<DK>
      <<<dim3(a.bh, tiles), Sh::NS * kWarp, Sh::SMEM, a.stream>>>(
          a.r, a.k, a.v, a.w, a.u, a.u_rows, a.s0, a.dout, a.ds_t, ckpt,
          part, a.dv, a.ds0, a.bh, a.t_len, a.dv_n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(a.bh) * a.t_len;
  if (rows > 0) {
    linear_scan_bwd_rows_kernel<<<static_cast<unsigned>((rows + 127) / 128),
                                  128, 0, a.stream>>>(
        a.r, a.k, a.v, a.u, a.u_rows, a.dout, part, vdo, a.dr, a.dk, a.dw,
        a.bh, a.t_len, DK, a.dv_n, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.u != nullptr && a.du != nullptr) {
    linear_scan_bwd_du_kernel<<<(a.u_rows * DK + 127) / 128, 128, 0,
                                a.stream>>>(a.r, a.k, vdo, a.du, a.u_rows,
                                            a.bh, a.t_len, DK);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // namespace

// scratch: floats for the chunk states, the column tiles' partials and
// v_t . do_t, as linear_scan/ops.py bwd_scratch_floats counts them.
extern "C" int repro_linear_scan_bwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    int u_rows, const void* s0, const void* dout, const void* ds_t,
    void* scratch, void* dr, void* dk, void* dv, void* dw, void* du,
    void* ds0, int bh, int t_len, int d_k, int dv_n, void* stream) {
  if (bh < 1 || t_len < 0 || dv_n < 1 || (dv_n + kWarp - 1) / kWarp > 65535 ||
      (u != nullptr && (u_rows < 1 || bh % u_rows != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), u_rows,
               static_cast<const float*>(s0), static_cast<const float*>(dout),
               static_cast<const float*>(ds_t), static_cast<float*>(scratch),
               static_cast<float*>(dr), static_cast<float*>(dk),
               static_cast<float*>(dv), static_cast<float*>(dw),
               static_cast<float*>(du), static_cast<float*>(ds0), bh, t_len,
               dv_n, static_cast<cudaStream_t>(stream)};
  switch (d_k) {
    case 8: return launch<8>(a);
    case 16: return launch<16>(a);
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 128: return launch<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
