// ScaleGate merge: total order, Definition-3 watermark and readiness of one
// tick, in one thread block.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/scalegate_merge/scalegate_merge.py::scalegate_merge
//   (body _kernel -> _sort_ready -> _cmp_exchange).
//
// Contract (same as the Pallas kernel and its ref.py): lanes are sorted by
// (tau, arrival lane) with invalid lanes keyed INF_TIME; the watermark is
// W = min_s max(-1, max{tau : src = s, valid}); ready = valid && tau <= W,
// in sorted order.
//
// What bounds it on an H100: a tick is a few thousand lanes, so the bytes
// (9 B in, 8 B out per lane) and the n log^2 n compare-exchanges of the
// network are microseconds of work at most; the kernel is bound by latency:
// one block, a barrier per network stage (91 stages at 8192 lanes).
//
// What the design does about it: the whole tick lives in shared memory as
// packed 64-bit keys ((uint32)(tau ^ 0x80000000) << 32 | lane), so each
// compare-exchange is one 64-bit compare on data that never leaves the SM,
// the sign flip makes negative taus sort right over the full int32 range,
// and the lane in the low word is the arrival tie-break (keys are unique).
// The watermark is folded in the same pass that builds the keys (shared
// per-source atomicMax, then one min).  At most 16384 lanes (128 KB of
// dynamic shared memory); the launcher refuses larger ticks.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = 16384;
constexpr int kMaxSources = 1024;
constexpr int kMinLanes = 128;

__global__ void __launch_bounds__(kThreads)
scalegate_merge_kernel(const int32_t* __restrict__ tau,
                       const int32_t* __restrict__ src,
                       const uint8_t* __restrict__ valid, int n, int n_pad,
                       int n_sources, int32_t* __restrict__ order,
                       int32_t* __restrict__ ready,
                       int32_t* __restrict__ wmark) {
  extern __shared__ unsigned long long keys[];
  __shared__ int src_max[kMaxSources];
  __shared__ int w_shared;
  const int tid = threadIdx.x;

  for (int s = tid; s < n_sources; s += blockDim.x) src_max[s] = -1;
  __syncthreads();

  for (int i = tid; i < n_pad; i += blockDim.x) {
    int t = INT_MAX;
    if (i < n && valid[i]) {
      t = tau[i];
      const int s = src[i];
      if (s >= 0 && s < n_sources) atomicMax(&src_max[s], t);
    }
    keys[i] = (static_cast<unsigned long long>(
                   static_cast<uint32_t>(t) ^ 0x80000000u) << 32) |
              static_cast<uint32_t>(i);
  }
  __syncthreads();

  if (tid == 0) {
    int w = INT_MAX;
    for (int s = 0; s < n_sources; ++s) w = min(w, src_max[s]);
    w_shared = w;
    wmark[0] = w;
  }

  // Bitonic network, ascending overall.  Pairs (i, i ^ j) with i < i ^ j;
  // the block of size k containing i sorts ascending iff bit k of i is 0.
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_pad; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i];
          const unsigned long long b = keys[p];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // Padding lanes carry (INF_TIME, lane >= n) keys and sort after every
  // real lane, so the first n sorted positions are the real lanes.
  const int w = w_shared;
  for (int i = tid; i < n; i += blockDim.x) {
    const int lane = static_cast<int>(keys[i] & 0xffffffffu);
    order[i] = lane;
    ready[i] = (valid[lane] && tau[lane] <= w) ? 1 : 0;
  }
}

}  // namespace

extern "C" int repro_scalegate_merge(const void* tau, const void* src,
                                     const void* valid, int n, int n_sources,
                                     void* order, void* ready, void* wmark,
                                     void* stream) {
  if (n < 1 || n > kMaxLanes || n_sources < 1 || n_sources > kMaxSources) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_pad = kMinLanes;
  while (n_pad < n) n_pad <<= 1;
  const int smem = n_pad * static_cast<int>(sizeof(unsigned long long));
  cudaError_t err = cudaFuncSetAttribute(
      scalegate_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n_pad < kThreads ? n_pad : kThreads;
  scalegate_merge_kernel<<<1, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tau), static_cast<const int32_t*>(src),
      static_cast<const uint8_t*>(valid), n, n_pad, n_sources,
      static_cast<int32_t*>(order), static_cast<int32_t*>(ready),
      static_cast<int32_t*>(wmark));
  return static_cast<int>(cudaGetLastError());
}
