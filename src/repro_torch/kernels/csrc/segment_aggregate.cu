// Keyed windowed segment-reduce: out = acc, then out[k, s, :] += vals[n, :]
// for every hit n with keys[n] = k, slots[n] = s (the Q1 wordcount /
// paircount update phase).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_aggregate/segment_aggregate.py::segment_aggregate
//   (body _kernel).
//
// Contract (same as the Pallas kernel and its ref.py): out-of-place, acc is
// only read; a hit whose key is -1 or outside [0, K) is dropped, and so is
// a slot outside [0, S) (the core never produces one).
//
// What bounds it on an H100: one Q1 tick is 25k-50k hits (12 B each) into
// a 64 KB accumulator, well under a megabyte, so neither bytes nor
// arithmetic: launches and the latency of dependent memory operations.
// Two costs come on top on the main path: out-of-place needs acc copied
// to out before any add (each VSN instance starts from the same shared
// state), which a kernel that adds in place makes a second device
// operation; and Q1's keys are Zipf(1.3), so the instance that owns the top
// word sends a thousand and more adds a call to one address, which the L2
// slice that holds it runs one after another.
//
// What the design does about it:
//  - Accumulators of up to kMaxCluster x kBlockCells cells (1 MB; Q1's is
//    64 KB): one launch of one thread-block cluster.  Each block copies
//    its tile of key rows (the TPU kernel's own split) from acc to out;
//    a cluster barrier (release/acquire at cluster scope) orders every
//    copy before any add; then each block reads its share of the hits,
//    four at a time with 16-byte loads, and adds them into out with
//    global float reductions, which L2 performs natively.  One device
//    operation, no clone.  (Holding the tiles in shared memory and adding
//    through distributed shared memory was measured first: a float add
//    into shared memory retries a compare-and-swap under contention, and
//    took 8x the time of global reductions at Q1's Zipf shape.)
//  - With one column (counts), each warp keeps the cell most of its lanes
//    hit in a register sum across all its hits and adds it to out once
//    (see add_hits), so the Zipf head costs one add per warp, not one per
//    hit.
//  - Larger accumulators: a device copy acc -> out, then a grid of blocks
//    adds the hits with the same code.  Two device operations; no size is
//    refused.
//
// Float adds land in an order that varies from run to run (reductions and
// the warp sums): the result is exact for integer-valued
// contributions below 2^24 (counts), and equal to a sequential sum up to
// reordering otherwise.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;             // non-portable above 8
constexpr int kBlockCells = 16384;          // a block's tile of the cluster
constexpr unsigned kFull = 0xffffffffu;

// Sum of x over the warp's 32 lanes, in every lane (a butterfly).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Four consecutive hits, one lane's group.
struct Hits {
  int key[4], slot[4];
  float val[4];                    // w == 1 only
};

// Group i0 / 4 of the hits (past n: dead).  vec: keys and slots (and vals
// when w == 1) are 16-byte aligned.
__device__ __forceinline__ Hits load_hits(const int32_t* __restrict__ keys,
                                          const int32_t* __restrict__ slots,
                                          const float* __restrict__ vals,
                                          int n, int w, bool vec,
                                          long long i0) {
  Hits h;
  if (vec && i0 + 3 < n) {
    const int4 k4 = *reinterpret_cast<const int4*>(keys + i0);
    const int4 s4 = *reinterpret_cast<const int4*>(slots + i0);
    h.key[0] = k4.x; h.key[1] = k4.y; h.key[2] = k4.z; h.key[3] = k4.w;
    h.slot[0] = s4.x; h.slot[1] = s4.y; h.slot[2] = s4.z; h.slot[3] = s4.w;
    const float4 v4 = w == 1 ? *reinterpret_cast<const float4*>(vals + i0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    h.val[0] = v4.x; h.val[1] = v4.y; h.val[2] = v4.z; h.val[3] = v4.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = i0 + j < n;
      h.key[j] = in ? keys[i0 + j] : -1;
      h.slot[j] = in ? slots[i0 + j] : 0;
      h.val[j] = (in && w == 1) ? vals[i0 + j] : 0.f;
    }
  }
  return h;
}

// Add the hits into out: hit groups of four, one group a lane, the warp's
// 32 groups contiguous (warp `warp_id` of `n_warps`); `first` holds the
// lane's first group, loaded by the caller.
//
// With one column the warp keeps one cell, `hot`, in a register sum:
// each round (32 hits, one a lane) the hits on it are summed across the
// warp and added to the register, and the rest go to out as reductions.
// The cell is the first other live cell of a round that two or more lanes
// hit, taken when more lanes hit it than the cached one (the cached sum is
// then added to out); at the end the sum is added once.  Under Zipf keys
// the top word becomes one add per warp, and no round needs more than
// ballots and one shuffle to find out (__match_any_sync, which groups
// every cell, was measured slower than the adds it saves).
__device__ __forceinline__ void add_hits(const int32_t* __restrict__ keys,
                                         const int32_t* __restrict__ slots,
                                         const float* __restrict__ vals,
                                         float* __restrict__ out, int n, int w,
                                         int k, int s, bool vec,
                                         long long warp_id, long long n_warps,
                                         Hits hits) {
  const int lane = threadIdx.x & 31;
  const long long n_groups = (static_cast<long long>(n) + 3) / 4;
  int hot = -1;                    // the same in every lane of the warp
  float hot_sum = 0.f;
  for (long long gw = warp_id * 32; gw < n_groups; gw += n_warps * 32) {
    const long long i0 = (gw + lane) * 4;
    if (gw != warp_id * 32) hits = load_hits(keys, slots, vals, n, w, vec, i0);
    const int* kk = hits.key;
    const int* ss = hits.slot;
    const float* vv = hits.val;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = kk[j] >= 0 && kk[j] < k && ss[j] >= 0 && ss[j] < s;
      const int cell = ok ? (kk[j] * s + ss[j]) * w : -1;
      if (w != 1) {                           // w is uniform
        for (int c = 0; c < w && ok; ++c) {
          atomicAdd(out + cell + c, vals[(i0 + j) * w + c]);
        }
        continue;
      }
      const unsigned others = __ballot_sync(kFull, ok && cell != hot);
      if (others) {
        const int cand = __shfl_sync(kFull, cell, __ffs(others) - 1);
        const int n_cand = __popc(__ballot_sync(kFull, cell == cand));
        const int n_hot = __popc(__ballot_sync(kFull, ok && cell == hot));
        if (n_cand >= 2 && n_cand > n_hot) {
          if (hot >= 0 && lane == 0) atomicAdd(out + hot, hot_sum);
          hot = cand;
          hot_sum = 0.f;
        }
      }
      const bool on_hot = ok && cell == hot;
      if (__any_sync(kFull, on_hot)) hot_sum += warp_sum(on_hot ? vv[j] : 0.f);
      if (ok && !on_hot) atomicAdd(out + cell, vv[j]);
    }
  }
  if (hot >= 0 && lane == 0) atomicAdd(out + hot, hot_sum);
}

// The whole call in one cluster: block `rank` copies key rows
// [rank * rows, (rank + 1) * rows) of acc to out, then adds its hits.
__global__ void __launch_bounds__(kThreads)
segment_aggregate_cluster_kernel(const int32_t* __restrict__ keys,
                                 const int32_t* __restrict__ slots,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ acc,
                                 float* __restrict__ out, int n, int w, int k,
                                 int s, int rows, bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row_cells = static_cast<long long>(s) * w;
  const long long lo = min(static_cast<long long>(rank) * rows,
                           static_cast<long long>(k)) * row_cells;
  const long long hi = min(static_cast<long long>(rank + 1) * rows,
                           static_cast<long long>(k)) * row_cells;
  const long long warp_id = static_cast<long long>(rank) * kWarps +
                            (threadIdx.x >> 5);
  // the lane's first hits are in flight during the copy and the barrier
  const Hits first = load_hits(keys, slots, vals, n, w, vec,
                               (warp_id * 32 + (threadIdx.x & 31)) * 4);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) out[i] = acc[i];
  cluster.sync();                  // every copy lands before any add
  add_hits(keys, slots, vals, out, n, w, k, s, vec, warp_id,
           static_cast<long long>(cluster.num_blocks()) * kWarps, first);
}

// Past one cluster: out already holds acc; the hits add into it.
__global__ void __launch_bounds__(kThreads)
segment_aggregate_global_kernel(const int32_t* __restrict__ keys,
                                const int32_t* __restrict__ slots,
                                const float* __restrict__ vals,
                                float* __restrict__ out, int n, int w, int k,
                                int s, bool vec) {
  const long long warp_id = static_cast<long long>(blockIdx.x) * kWarps +
                            (threadIdx.x >> 5);
  add_hits(keys, slots, vals, out, n, w, k, s, vec, warp_id,
           static_cast<long long>(gridDim.x) * kWarps,
           load_hits(keys, slots, vals, n, w, vec,
                     (warp_id * 32 + (threadIdx.x & 31)) * 4));
}

// The cluster kernel's function attribute, set once per process (a
// function-local static is initialised once, thread-safely).
cudaError_t set_attributes() {
  static const cudaError_t err = cudaFuncSetAttribute(
      segment_aggregate_cluster_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// cluster > 0: one cluster of that many blocks, each copying ceil(k /
// cluster) key rows (at most kBlockCells cells); cluster == 0: the copy and
// the global kernel.  out must not overlap acc.
extern "C" int repro_segment_aggregate(const void* keys, const void* slots,
                                       const void* vals, const void* acc,
                                       void* out, int n, int w, int k, int s,
                                       int cluster, void* stream) {
  if (n < 0 || w < 1 || k < 1 || s < 1 || cluster < 0 ||
      cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* kp = static_cast<const int32_t*>(keys);
  const auto* sp = static_cast<const int32_t*>(slots);
  const auto* vp = static_cast<const float*>(vals);
  const auto* ap = static_cast<const float*>(acc);
  auto* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(keys) && aligned16(slots) &&
                   (w != 1 || aligned16(vals));
  if (cluster > 0) {
    const int rows = (k + cluster - 1) / cluster;
    if (static_cast<long long>(rows) * s * w > kBlockCells) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = set_attributes();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, segment_aggregate_cluster_kernel, kp, sp, vp, ap, op, n, w, k,
        s, rows, vec);
    // a refused launch's error is also the thread's last error: clear it
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
  }
  cudaError_t e = cudaMemcpyAsync(out, acc,
                                  static_cast<size_t>(k) * s * w * sizeof(float),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = (static_cast<long long>(n) + 3) / 4;
  if (groups == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (groups + kThreads - 1) / kThreads;
  segment_aggregate_global_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                    st>>>(kp, sp, vp, op, n, w, k, s, vec);
  return static_cast<int>(cudaGetLastError());
}
