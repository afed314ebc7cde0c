// ScaleJoin blocked window band-join counts (the Q3/Q6 compare phase).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/window_join/window_join.py::window_join
//   (body _kernel; the reference wrapper sums the per-tile comps).
//
// Contract (same as the Pallas kernel and its ref.py):
//   counts[b, k] = #{r : st_tau[k,r] >= 0 && st_tau[k,r] + ws >= new_tau[b]
//                        && st_src[k,r] != new_src[b]
//                        && |new_pay[b,a] - st_pay[k,r,a]| <= band, a < n_attrs}
//   comps = #{(b, k, r) : the same without the band test}
// with int32 wrap-around in st_tau + ws, as the reference computes it.
//
// What bounds it on an H100: B*K*R pair tests (134M at B=512, K=1024,
// R=256), each a handful of integer compares and 2*n_attrs float ops, while
// the inputs are a few MB: the kernel is bound by instruction issue, not by
// bytes.
//
// What the design does about it: a block is 32 incoming tuples x 8 key
// rows.  The incoming tile (tau, src, first n_attrs payload columns) is
// staged once in shared memory; each warp owns one key row and its 32 lanes
// own 32 incoming tuples, so every stored-ring load is the same address
// across the warp (one broadcast transaction) and the band test runs only
// for live, fresh, opposite-stream pairs.  comps is reduced in the warp,
// then across the block, then one 64-bit atomicAdd per block.  Incoming
// lanes past B stage INF_TIME and are masked out of counts and comps.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileB = 32;   // lanes of a warp: one incoming tuple each
constexpr int kTileK = 8;    // warps of a block: one key row each
constexpr int kMaxAttrs = 8;

__global__ void __launch_bounds__(kTileB * kTileK)
window_join_kernel(const int32_t* __restrict__ new_tau,
                   const int32_t* __restrict__ new_src,
                   const float* __restrict__ new_pay, int b_total, int p,
                   const int32_t* __restrict__ st_tau,
                   const int32_t* __restrict__ st_src,
                   const float* __restrict__ st_pay, int k_total, int r_total,
                   int ws, float band, int n_attrs, int32_t* __restrict__ counts,
                   unsigned long long* __restrict__ comps) {
  __shared__ int s_tau[kTileB];
  __shared__ int s_src[kTileB];
  __shared__ float s_pay[kTileB][kMaxAttrs];
  __shared__ unsigned long long s_comps[kTileK];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b = blockIdx.x * kTileB + lane;
  const int k = blockIdx.y * kTileK + warp;

  if (warp == 0) {
    const bool in = b < b_total;
    s_tau[lane] = in ? new_tau[b] : INT_MAX;
    s_src[lane] = in ? new_src[b] : 0;
#pragma unroll
    for (int a = 0; a < kMaxAttrs; ++a) {
      s_pay[lane][a] = (in && a < n_attrs)
                           ? new_pay[static_cast<long long>(b) * p + a]
                           : 0.f;
    }
  }
  __syncthreads();

  unsigned long long opp_count = 0;
  if (k < k_total) {
    const int t_new = s_tau[lane];
    const int src_new = s_src[lane];
    float pay_new[kMaxAttrs];
#pragma unroll
    for (int a = 0; a < kMaxAttrs; ++a) pay_new[a] = s_pay[lane][a];

    const long long row = static_cast<long long>(k) * r_total;
    int count = 0;
    for (int r = 0; r < r_total; ++r) {
      const int t = st_tau[row + r];
      const int s = st_src[row + r];
      const int horizon = static_cast<int>(static_cast<unsigned>(t) +
                                           static_cast<unsigned>(ws));
      if (t >= 0 && horizon >= t_new && s != src_new) {
        ++opp_count;
        const float* sp = st_pay + (row + r) * p;
        bool ok = true;
#pragma unroll
        for (int a = 0; a < kMaxAttrs; ++a) {
          if (a < n_attrs) ok = ok && fabsf(pay_new[a] - sp[a]) <= band;
        }
        count += ok ? 1 : 0;
      }
    }
    if (b < b_total) counts[static_cast<long long>(b) * k_total + k] = count;
  }
  if (b >= b_total) opp_count = 0;

#pragma unroll
  for (int off = kTileB / 2; off > 0; off >>= 1) {
    opp_count += __shfl_down_sync(0xffffffffu, opp_count, off);
  }
  if (lane == 0) s_comps[warp] = opp_count;
  __syncthreads();
  if (warp == 0 && lane == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kTileK; ++i) total += s_comps[i];
    if (total) atomicAdd(comps, total);
  }
}

}  // namespace

extern "C" int repro_window_join(const void* new_tau, const void* new_src,
                                 const void* new_pay, int b, int p,
                                 const void* st_tau, const void* st_src,
                                 const void* st_pay, int k, int r, int ws,
                                 float band, int n_attrs, void* counts,
                                 void* comps, void* stream) {
  if (b < 0 || k < 0 || r < 0 || p < 1 || n_attrs < 0 ||
      n_attrs > kMaxAttrs || n_attrs > p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(comps, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(kTileB, kTileK);
  const dim3 grid((b + kTileB - 1) / kTileB, (k + kTileK - 1) / kTileK);
  window_join_kernel<<<grid, block, 0, st>>>(
      static_cast<const int32_t*>(new_tau), static_cast<const int32_t*>(new_src),
      static_cast<const float*>(new_pay), b, p,
      static_cast<const int32_t*>(st_tau), static_cast<const int32_t*>(st_src),
      static_cast<const float*>(st_pay), k, r, ws, band, n_attrs,
      static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(comps));
  return static_cast<int>(cudaGetLastError());
}
