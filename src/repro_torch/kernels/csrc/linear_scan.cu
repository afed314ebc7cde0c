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
// contiguous: r, k, w [BH, T, Dk], v and o [BH, T, Dv].
//
// What bounds it on an H100: the recurrence is sequential in T and does
// ~4 Dk Dv flops per step per head; at rwkv6-7b's prefill (64 heads, 128
// tokens, 64 x 64 state) that is 134 MFLOP over 8.6 MB of inputs, so the
// chain of dependent steps (latency), not bytes or flops, bounds it.
//
// What the design does about it: column j of S only ever meets column j of
// the update k^T v and produces o_t[j], so the columns are independent.
// Each thread owns one column of S in registers (Dk values), each block is
// one warp over 32 columns of one bh, and the grid covers BH x Dv/32: no
// reduction across threads, no barrier per step beyond a warp sync per
// chunk of r, k, w staged in shared memory (2048 values each).  The TPU
// kernel's chunk grid axis becomes that loop inside the block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

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

template <int DK>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, int u_rows, const float* s0, float* o,
           float* s_out, int bh, int t_len, int dv, cudaStream_t stream) {
  const dim3 grid(bh, (dv + kWarp - 1) / kWarp);
  linear_scan_kernel<DK><<<grid, kWarp, 0, stream>>>(
      r, k, v, w, u, u_rows, s0, o, s_out, t_len, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_linear_scan(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, int u_rows,
                                 const void* s0, void* o, void* s_out, int bh,
                                 int t_len, int dk, int dv, void* stream) {
  if (bh < 1 || t_len < 0 || dv < 1 || bh > 2147483647 / 2 ||
      (dv + kWarp - 1) / kWarp > 65535 || (u != nullptr && u_rows < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* of = static_cast<float*>(o);
  auto* so = static_cast<float*>(s_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 8: return launch<8>(rf, kf, vf, wf, uf, u_rows, sf, of, so, bh,
                             t_len, dv, s);
    case 16: return launch<16>(rf, kf, vf, wf, uf, u_rows, sf, of, so, bh,
                               t_len, dv, s);
    case 32: return launch<32>(rf, kf, vf, wf, uf, u_rows, sf, of, so, bh,
                               t_len, dv, s);
    case 64: return launch<64>(rf, kf, vf, wf, uf, u_rows, sf, of, so, bh,
                               t_len, dv, s);
    case 128: return launch<128>(rf, kf, vf, wf, uf, u_rows, sf, of, so, bh,
                                 t_len, dv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
