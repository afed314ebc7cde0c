// ScaleGate merge: total order, watermark and readiness of one tick (flat
// entry) or of one root round over stacked leaf chunk rows (stacked entry).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/scalegate_merge/scalegate_merge.py::scalegate_merge
//   (body _kernel -> _sort_ready -> _cmp_exchange) and
//   src/repro/kernels/scalegate_merge/scalegate_merge.py::scalegate_merge_stacked
//   (body _stacked_kernel -> _sort_ready).
// As there, both entries share one sort body; they differ only in the gate:
//   flat:    W = min_s max(-1, max{tau : src = s, valid})   (Definition 3)
//   stacked: W = min(reports), the leaves' pre-masked reported frontiers
//            (INF_TIME for inactive leaves): Definition 3 one level up.
// Contract (same as the Pallas kernels and ref.py): lanes are sorted by
// (tau, arrival lane) with invalid lanes keyed INF_TIME (for the stacked
// entry the arrival lane is the row-major flat index); ready = valid &&
// tau <= W, in sorted order.
//
// What bounds it on an H100: a tick or a root round is a few thousand to a
// few tens of thousands of lanes, so the bytes (5 B in, 8 B out per lane)
// and the n log^2 n compare-exchanges of the network are microseconds of
// work at most; the kernel is bound by latency: a barrier per network stage.
//
// What the design does about it: lanes become packed 64-bit keys
// ((uint32)(tau ^ 0x80000000) << 32 | lane), so each compare-exchange is one
// 64-bit compare, the sign flip makes negative taus sort right over the
// full int32 range, and the lane in the low word is the arrival tie-break
// (keys are unique).  Up to kTile lanes (128 KB of dynamic shared memory)
// the whole buffer sorts in one block that also folds the watermark and
// emits order/ready: one launch.  Past one tile (a root round whose leaves
// forwarded more than a chunk, or a pipeline buffer fed by such a round) the
// bitonic network is split by stride: each block sorts one tile in shared
// memory; every merge level k > kTile then runs its strides >= kTile as
// compare-exchange passes over the keys in global memory and finishes its
// strides < kTile in shared memory, one tile per block; the last finishing
// pass emits.  The watermark then comes from a one-block kernel launched
// first.  At most kMaxLanes lanes; the launchers refuse larger buffers.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

using Key = unsigned long long;

constexpr int kThreads = 1024;
constexpr int kTile = 16384;        // lanes one block sorts in shared memory
constexpr int kMaxLanes = 1 << 20;
constexpr int kMaxSources = 1024;
constexpr int kMaxReports = 128;
constexpr int kMinLanes = 128;

// The gate of one call: per-source fold (flat) or report min (stacked).
struct Gate {
  const int32_t* src;       // flat: source id per lane; stacked: nullptr
  int n_sources;
  const int32_t* reports;   // stacked: per-leaf reported frontiers
  int n_reports;
};

__device__ __forceinline__ Key pack(int32_t tau, bool valid, int lane) {
  const uint32_t t = valid ? static_cast<uint32_t>(tau) : INT_MAX;
  return (static_cast<Key>(t ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(lane);
}

// The watermark of one call, computed by one whole block over lanes
// [0, n); every thread returns it.
__device__ int block_watermark(const int32_t* __restrict__ tau,
                               const uint8_t* __restrict__ valid, int n,
                               const Gate& g) {
  __shared__ int src_max[kMaxSources];
  __shared__ int w_shared;
  const int tid = threadIdx.x;
  if (g.reports != nullptr) {
    if (tid == 0) {
      int w = INT_MAX;
      for (int r = 0; r < g.n_reports; ++r) w = min(w, g.reports[r]);
      w_shared = w;
    }
    __syncthreads();
    return w_shared;
  }
  for (int s = tid; s < g.n_sources; s += blockDim.x) src_max[s] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    if (valid[i]) {
      const int s = g.src[i];
      if (s >= 0 && s < g.n_sources) atomicMax(&src_max[s], tau[i]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int w = INT_MAX;
    for (int s = 0; s < g.n_sources; ++s) w = min(w, src_max[s]);
    w_shared = w;
  }
  __syncthreads();
  return w_shared;
}

// Pair t of a stage with stride j: the lower lane i (bit j clear) and its
// partner i + j.
__device__ __forceinline__ int pair_lo(int t, int j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// The shared sort body: bitonic stages of levels k_lo..k_hi with strides
// min(k, tile) / 2 .. 1 over one tile of keys in shared memory whose first
// lane has global index base.  A block of size k sorts ascending iff bit k
// of the global index is 0, so tiles sorted here merge across tiles later.
__device__ void sort_tile(Key* keys, int tile, int base, int k_lo, int k_hi) {
  const int half = tile >> 1;
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = min(k, tile) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = pair_lo(t, j);
        const Key a = keys[i];
        const Key b = keys[i + j];
        const bool up = ((base + i) & k) == 0;
        if ((a > b) == up) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Write order/ready for the sorted positions of one tile.  Padding lanes
// carry (INF_TIME, lane >= n) keys and sort after every real lane, so the
// first n sorted positions are the real lanes.
__device__ void emit_tile(const Key* keys, int tile, int base, int n,
                          const int32_t* __restrict__ tau,
                          const uint8_t* __restrict__ valid, int w,
                          int32_t* __restrict__ order,
                          int32_t* __restrict__ ready) {
  for (int i = threadIdx.x; i < tile && base + i < n; i += blockDim.x) {
    const int lane = static_cast<int>(keys[i] & 0xffffffffu);
    order[base + i] = lane;
    ready[base + i] = (valid[lane] && tau[lane] <= w) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
watermark_kernel(const int32_t* __restrict__ tau,
                 const uint8_t* __restrict__ valid, int n, Gate g,
                 int32_t* __restrict__ wmark) {
  const int w = block_watermark(tau, valid, n, g);
  if (threadIdx.x == 0) wmark[0] = w;
}

// Build and sort one tile of keys.  With one tile (gridDim.x == 1) this is
// the whole call: it also folds the watermark and emits.
__global__ void __launch_bounds__(kThreads)
tile_sort_kernel(const int32_t* __restrict__ tau,
                 const uint8_t* __restrict__ valid, int n, int tile, Gate g,
                 Key* __restrict__ keys_g, int32_t* __restrict__ order,
                 int32_t* __restrict__ ready, int32_t* __restrict__ wmark) {
  extern __shared__ Key keys[];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int lane = base + i;
    keys[i] = lane < n ? pack(tau[lane], valid[lane], lane)
                       : pack(0, false, lane);
  }
  __syncthreads();
  sort_tile(keys, tile, base, 2, tile);
  if (gridDim.x == 1) {
    const int w = block_watermark(tau, valid, n, g);
    if (threadIdx.x == 0) wmark[0] = w;
    emit_tile(keys, tile, 0, n, tau, valid, w, order, ready);
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys_g[base + i] = keys[i];
}

// One stage (level k, stride j >= tile) in global memory, a thread per pair.
__global__ void merge_pass_kernel(Key* __restrict__ keys, int n_pad, int k,
                                  int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (n_pad >> 1)) return;
  const int i = pair_lo(t, j);
  const Key a = keys[i];
  const Key b = keys[i + j];
  const bool up = (i & k) == 0;
  if ((a > b) == up) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// The strides below the tile of level k, one tile per block; the last
// level (k == n_pad) emits instead of storing the keys back.
__global__ void __launch_bounds__(kThreads)
tile_merge_kernel(Key* __restrict__ keys_g, int n_pad, int tile, int k,
                  const int32_t* __restrict__ tau,
                  const uint8_t* __restrict__ valid, int n,
                  const int32_t* __restrict__ wmark,
                  int32_t* __restrict__ order, int32_t* __restrict__ ready) {
  extern __shared__ Key keys[];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[i] = keys_g[base + i];
  __syncthreads();
  sort_tile(keys, tile, base, k, k);
  if (k == n_pad) {
    emit_tile(keys, tile, base, n, tau, valid, wmark[0], order, ready);
    return;
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys_g[base + i] = keys[i];
}

int padded(int n) {
  int n_pad = kMinLanes;
  while (n_pad < n) n_pad <<= 1;
  return n_pad;
}

cudaError_t launch(const int32_t* tau, const uint8_t* valid, int n,
                   const Gate& g, Key* keys_g, int32_t* order,
                   int32_t* ready, int32_t* wmark, cudaStream_t stream) {
  const int n_pad = padded(n);
  const int tile = n_pad < kTile ? n_pad : kTile;
  const int n_tiles = n_pad / tile;
  if (n_tiles > 1 && keys_g == nullptr) return cudaErrorInvalidValue;
  const int smem = tile * static_cast<int>(sizeof(Key));
  const int threads = (tile >> 1) < kThreads ? (tile >> 1) : kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (n_tiles > 1) {
    err = cudaFuncSetAttribute(
        tile_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    watermark_kernel<<<1, kThreads, 0, stream>>>(tau, valid, n, g, wmark);
  }
  tile_sort_kernel<<<n_tiles, threads, smem, stream>>>(
      tau, valid, n, tile, g, keys_g, order, ready, wmark);
  for (int k = tile << 1; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      const int pairs = n_pad >> 1;
      merge_pass_kernel<<<(pairs + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(keys_g, n_pad, k, j);
    }
    tile_merge_kernel<<<n_tiles, threads, smem, stream>>>(
        keys_g, n_pad, tile, k, tau, valid, n, wmark, order, ready);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_scalegate_merge(const void* tau, const void* src,
                                     const void* valid, int n, int n_sources,
                                     void* keys, void* order, void* ready,
                                     void* wmark, void* stream) {
  if (n < 1 || n > kMaxLanes || n_sources < 1 || n_sources > kMaxSources) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Gate g{static_cast<const int32_t*>(src), n_sources, nullptr, 0};
  return static_cast<int>(launch(
      static_cast<const int32_t*>(tau), static_cast<const uint8_t*>(valid), n,
      g, static_cast<Key*>(keys), static_cast<int32_t*>(order),
      static_cast<int32_t*>(ready), static_cast<int32_t*>(wmark),
      static_cast<cudaStream_t>(stream)));
}

extern "C" int repro_scalegate_merge_stacked(const void* tau,
                                             const void* valid, int n,
                                             const void* reports,
                                             int n_reports, void* keys,
                                             void* order, void* ready,
                                             void* wmark, void* stream) {
  if (n < 1 || n > kMaxLanes || n_reports < 1 || n_reports > kMaxReports) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Gate g{nullptr, 0, static_cast<const int32_t*>(reports), n_reports};
  return static_cast<int>(launch(
      static_cast<const int32_t*>(tau), static_cast<const uint8_t*>(valid), n,
      g, static_cast<Key*>(keys), static_cast<int32_t*>(order),
      static_cast<int32_t*>(ready), static_cast<int32_t*>(wmark),
      static_cast<cudaStream_t>(stream)));
}
