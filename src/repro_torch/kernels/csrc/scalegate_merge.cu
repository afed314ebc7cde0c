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
// and the n log n comparisons are under a microsecond of work; the kernel
// is bound by latency: the launches, barriers, and chains of dependent
// shared-memory loads on its critical path.  A bitonic network in one
// block (the first design) spent a block barrier on each of its log^2 n
// stages, on one or two SMs, over lanes padded to a power of two, in up to
// four launches.
//
// What the design does about it (the cluster path, up to 16 x kShare =
// 65,536 lanes): one launch of one thread-block cluster of up to 16 blocks,
// each holding a contiguous share of at most kShare lanes in its shared
// memory.  Lanes become packed 64-bit keys ((uint32)(tau ^ 0x80000000) << 32
// | lane): one compare each, negative taus sort right, and the lane in the
// low word is the arrival tie-break, so keys are unique and merge path needs
// no tie rule.  Keys whose high word is INF_TIME (invalid lanes, and valid
// lanes at tau INT_MAX) are never sorted: they go to positions [n_finite, n)
// in lane order, from a prefix count over the cluster, written coalesced.
// A block compacts its finite keys; each warp that holds some sorts its 256
// in registers (bitonic: strides under 8 inside a thread, the others by
// shuffles, no barrier); the warps' runs merge by merge path in shared
// memory (each thread finds its co-rank by binary search), one barrier a
// round and only as many rounds as the block's finite keys need.  The
// blocks' runs then merge in log2(cluster) rounds through distributed
// shared memory: two warps find where the block's slice of the merged run
// begins and ends in the partners' runs, 32 split points a step (a remote
// load is a round trip of ~500 cycles); the block copies those keys with
// every load in flight, merges them locally and writes its slice into its
// other buffer; then the cluster synchronises.  No global scratch, no
// padding.  The watermark is folded in the same launch (per-source maxima
// in each block's shared memory, one atomic per source per warp, reduced
// across the cluster by every block).  Past 65,536 lanes a multi-block
// bitonic path remains: tiles sorted in shared memory, strides of a tile or
// more as passes over keys in global memory, 64-bit positions, so it takes
// any N up to 2^31 - 1 lanes (its key scratch: N rounded up to a power of
// two).
//
// Sources: n_sources = 0 skips the fold (W = INT_MAX, the minimum over no
// source): ScaleGate's push computes its watermark elsewhere and asks only
// for the order.  Up to kMaxSources the per-source maxima live in shared
// memory; past it in a global scratch of n_sources ints that the launch
// initialises and folds into with global atomics, so every n_sources >= 0
// is taken.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

namespace cg = cooperative_groups;
using Key = unsigned long long;

// the cluster path
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // keys a thread sorts
constexpr int kShare = kThreads * kItems;      // lanes a block holds
constexpr int kSlots = kShare + kShare / 16;   // a buffer, padded
constexpr int kMaxCluster = 16;                // non-portable above 8
constexpr int kClusterSmem = 2 * kSlots * static_cast<int>(sizeof(Key));
// the multi-block path
constexpr int kTileThreads = 1024;
constexpr int kTile = 16384;        // lanes one block sorts in shared memory
constexpr int kTileSmem = kTile * static_cast<int>(sizeof(Key));
constexpr int kMaxSources = 1024;  // a shared-memory fold; past it, global
constexpr int kMaxReports = 128;
constexpr uint32_t kInfHigh = 0xffffffffu;     // pack's high word at INT_MAX
constexpr Key kSentinel = ~0ull;               // after every real key

// The gate of one call: per-source fold (flat) or report min (stacked).
struct Gate {
  const int32_t* src;       // flat: source id per lane; stacked: nullptr
  int n_sources;            // flat: 0 = no fold (W = INT_MAX)
  int* fold;                // flat, n_sources > kMaxSources: [n_sources]
  const int32_t* reports;   // stacked: per-leaf reported frontiers
  int n_reports;
};

__device__ __forceinline__ Key pack(int32_t tau, bool valid, int lane) {
  const uint32_t t = valid ? static_cast<uint32_t>(tau) : INT_MAX;
  return (static_cast<Key>(t ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(lane);
}

__device__ __forceinline__ int32_t key_tau(Key k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u);
}

// ---------------------------------------------------------------------------
// the cluster path
// ---------------------------------------------------------------------------

// The slot of key i in a block's buffer: one pad after every 16 keys, so a
// warp storing or loading its threads' 8 consecutive keys each touches 16
// distinct 8-byte banks per half-warp (unpadded, 2: a 16-way conflict).
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

__device__ __forceinline__ void order2(Key& a, Key& b) {
  const Key lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// Bitonic sort of one thread's keys; unrolled, the indices are constants
// and the keys stay in registers.
__device__ __forceinline__ void sort_items(Key (&k)[kItems]) {
#pragma unroll
  for (int size = 2; size <= kItems; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) {
            order2(k[i], k[j]);
          } else {
            order2(k[j], k[i]);
          }
        }
      }
    }
  }
}

// One compare-exchange in direction up (up: the smaller key to a).
__device__ __forceinline__ void order2_dir(Key& a, Key& b, bool up) {
  const Key lo = a < b ? a : b;
  const Key hi = a < b ? b : a;
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// Bitonic sort of a warp's 256 keys, lane l holding warp positions
// [8 l, 8 l + 8): strides under 8 inside a thread, the others between
// lanes by shuffles; no shared memory and no barrier.
__device__ __forceinline__ void warp_sort(Key (&k)[kItems]) {
  const int lane = threadIdx.x & 31;
  sort_items(k);                   // ascending runs of 8
  if (lane & 1) {                  // odd lanes descending: bitonic 16s
#pragma unroll
    for (int x = 0; x < kItems / 2; ++x) {
      const Key t = k[x];
      k[x] = k[kItems - 1 - x];
      k[kItems - 1 - x] = t;
    }
  }
#pragma unroll
  for (int size = 2 * kItems; size <= 32 * kItems; size <<= 1) {
    const bool up = (lane & (size / kItems)) == 0;
#pragma unroll
    for (int stride = size >> 1; stride >= kItems; stride >>= 1) {
      const int m = stride / kItems;
      const bool take_min = ((lane & m) == 0) == up;
#pragma unroll
      for (int x = 0; x < kItems; ++x) {
        const Key p = __shfl_xor_sync(0xffffffffu, k[x], m);
        k[x] = (k[x] < p) == take_min ? k[x] : p;
      }
    }
#pragma unroll
    for (int stride = kItems >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int x = 0; x < kItems; ++x) {
        if ((x & stride) == 0) order2_dir(k[x], k[x | stride], up);
      }
    }
  }
}

// Merge path: how many of the first d keys of merge(a, b) come from a.
// Keys are unique but for the block sort's sentinels, which are equal and
// interchangeable; ties go to b, as in merge_items.
template <class A, class B>
__device__ __forceinline__ int co_rank(const A& a, int la, const B& b,
                                       int lb, int d) {
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) < b(d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The kItems keys of merge(a, b) from a[i] and b[j] on (sentinels past the
// ends); the next key of each run is loaded while the current one is used.
template <class A, class B>
__device__ __forceinline__ void merge_items(const A& a, int la, const B& b,
                                            int lb, int i, int j,
                                            Key (&out)[kItems]) {
  Key ka = i < la ? a(i) : kSentinel;
  Key kb = j < lb ? b(j) : kSentinel;
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    const bool take_a = ka < kb;
    out[x] = take_a ? ka : kb;
    if (take_a) {
      ++i;
      ka = i < la ? a(i) : kSentinel;
    } else {
      ++j;
      kb = j < lb ? b(j) : kSentinel;
    }
  }
}

// co_rank by one whole warp: each step tests 32 split points at once (one
// round trip of dependent loads per step, not one per halving), so a
// search over remote shared memory takes log32 of the range in trips.
// Every lane returns the result.
template <class A, class B>
__device__ __forceinline__ int warp_co_rank(const A& a, int la, const B& b,
                                            int lb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - lb);
  int hi = min(d, la);
  while (lo < hi) {
    const int span = hi - lo;
    const int i = lo + lane * span / 32;
    const bool below = a(i) < b(d - 1 - i);
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int new_lo = c > 0 ? lo + (c - 1) * span / 32 + 1 : lo;
    hi = c < 32 ? lo + c * span / 32 : hi;
    lo = new_lo;
  }
  return lo;
}

// The per-source maximum of tau, folded into src_max: one atomic per
// source present in the warp (s < 0: nothing to fold).
__device__ __forceinline__ void fold_warp(int* src_max, int s, int t) {
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  const int mx = __reduce_max_sync(peers, t);
  if (s >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicMax(&src_max[s], mx);
  }
}

// Exclusive prefix sum of v over the block's threads; total gets the sum.
__device__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// The minimum of v over the block's threads, returned to every thread.
__device__ int block_min(int v, int* warp_mins) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if ((threadIdx.x & 31) == 0) warp_mins[threadIdx.x >> 5] = v;
  __syncthreads();
  int w = INT_MAX;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) w = min(w, warp_mins[i]);
  return w;
}

// Lanes [rank * share, (rank + 1) * share) of n belong to cluster block rank.
__device__ __forceinline__ int share_lanes(int rank, int share, int n) {
  return max(0, min(share, n - rank * share));
}

// The whole call in one cluster whose blocks each hold share lanes.
__global__ void __launch_bounds__(kThreads)
scalegate_cluster_kernel(const int32_t* __restrict__ tau,
                         const uint8_t* __restrict__ valid, int n, int share,
                         Gate g, int32_t* __restrict__ order,
                         int32_t* __restrict__ ready,
                         int32_t* __restrict__ wmark) {
  extern __shared__ Key bufs[];            // two buffers of kSlots keys
  __shared__ int part[2];                  // a cluster round's co-ranks
  __shared__ int src_max[kMaxSources];     // flat: this block's fold
  __shared__ int warp_sums[kWarps];
  __shared__ int warp_mins[kWarps];
  __shared__ int finite_count;             // read by the whole cluster
  __shared__ int counts[kMaxCluster];      // every block's finite keys

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int base = rank * share;
  const int lanes = share_lanes(rank, share, n);
  const bool flat = g.reports == nullptr;
  const bool fold = flat && g.n_sources > 0;
  const bool global_fold = g.n_sources > kMaxSources;
  if (global_fold) {
    // every block clears its share of the scratch before any block folds
    for (int s = rank * kThreads + tid; s < g.n_sources;
         s += n_blocks * kThreads) {
      g.fold[s] = -1;
    }
    cluster.sync();
  } else if (fold) {
    for (int s = tid; s < g.n_sources; s += kThreads) src_max[s] = -1;
    __syncthreads();
  }

  // 1. This thread's kItems lanes of the share, in lane order; the fold.
  Key k[kItems];
  int src_of[kItems];                      // flat: a lane's source, or -1
  uint32_t inf_lanes = 0, inf_valid = 0;   // bit x: lane x keyed INF_TIME
  int n_fin = 0;
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    const int i = tid * kItems + x;
    k[x] = kSentinel;
    src_of[x] = -1;
    if (i < lanes) {
      const int lane = base + i;
      const bool v = valid[lane] != 0;
      k[x] = pack(tau[lane], v, lane);
      if (static_cast<uint32_t>(k[x] >> 32) == kInfHigh) {
        inf_lanes |= 1u << x;
        inf_valid |= static_cast<uint32_t>(v) << x;
      } else {
        ++n_fin;
      }
      if (fold && v) {
        const int s = g.src[lane];
        src_of[x] = s < g.n_sources ? s : -1;
      }
    }
  }
  if (fold) {
    // A thread whose valid lanes share one source folds them first; a warp
    // with a thread of two sources folds lane by lane.
    int* const maxima = global_fold ? g.fold : src_max;
    int s0 = -1, m0 = INT_MIN;
    bool mixed = false;
#pragma unroll
    for (int x = 0; x < kItems; ++x) {
      if (src_of[x] < 0) continue;
      if (s0 < 0) s0 = src_of[x];
      if (src_of[x] == s0) {
        m0 = max(m0, key_tau(k[x]));
      } else {
        mixed = true;
      }
    }
    if (!__any_sync(0xffffffffu, mixed)) {
      fold_warp(maxima, s0, m0);
    } else {
#pragma unroll
      for (int x = 0; x < kItems; ++x) {
        fold_warp(maxima, src_of[x], key_tau(k[x]));
      }
    }
  }
  const int n_inf = __popc(inf_lanes);
  int totals;
  const int before = block_scan(n_fin | (n_inf << 16), warp_sums, totals);
  const int fin_before = before & 0xffff, inf_before = before >> 16;
  const int f = totals & 0xffff;           // this block's finite keys

  // 2. The finite keys, compacted into the second buffer, then kItems per
  // thread back into registers (sentinels past f).
  Key* const cur = bufs;
  Key* const nxt = bufs + kSlots;
  int c = fin_before;
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    if (tid * kItems + x < lanes && !(inf_lanes >> x & 1)) {
      nxt[slot(c++)] = k[x];
    }
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    const int i = tid * kItems + x;
    k[x] = i < f ? nxt[slot(i)] : kSentinel;
  }

  // 3. Each warp that holds finite keys sorts its 256 in registers; then
  // the warps' runs merge in shared memory, pairs of runs per round, only
  // over the threads that hold finite keys (rounded up to a power of
  // two).  A thread writes only its own slots, and groups nest, so one
  // barrier per round suffices.
  if ((tid >> 5) * 32 * kItems < f) warp_sort(k);
  const int holders = (f + kItems - 1) / kItems;
  const int rounds = holders <= 1 ? 0 : 32 - __clz(holders - 1);
  const bool active = tid < (1 << rounds);
  for (int r = 5; r < rounds; ++r) {
    Key* const buf = bufs + (r & 1) * kSlots;
    if (active) {
#pragma unroll
      for (int x = 0; x < kItems; ++x) buf[slot(tid * kItems + x)] = k[x];
    }
    __syncthreads();
    if (active) {
      const int run = kItems << r;
      const int first = tid >> (r + 1) << (r + 1);
      const int a0 = first * kItems, b0 = a0 + run;
      const auto a = [buf, a0](int i) { return buf[slot(a0 + i)]; };
      const auto b = [buf, b0](int i) { return buf[slot(b0 + i)]; };
      const int d = (tid - first) * kItems;
      const int i = co_rank(a, run, b, run, d);
      merge_items(a, run, b, run, i, d - i, k);
    }
  }
  __syncthreads();                 // the last round's reads are done
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    if (tid * kItems + x < f) cur[slot(tid * kItems + x)] = k[x];
  }
  if (tid == 0) finite_count = f;
  cluster.sync();

  // 4. Every block's count, and the watermark from every block's fold.
  if (tid < n_blocks) counts[tid] = *cluster.map_shared_rank(&finite_count,
                                                             tid);
  int m = INT_MAX;
  if (global_fold) {                       // the atomics are done (L2)
    for (int s = tid; s < g.n_sources; s += kThreads) {
      m = min(m, __ldcg(g.fold + s));
    }
  } else if (fold) {
    for (int s = tid; s < g.n_sources; s += kThreads) {
      int mx = -1;
      for (int b = 0; b < n_blocks; ++b) {
        mx = max(mx, *cluster.map_shared_rank(src_max + s, b));
      }
      m = min(m, mx);
    }
  } else if (!flat) {
    for (int r = tid; r < g.n_reports; r += kThreads) m = min(m, g.reports[r]);
  }
  const int w = block_min(m, warp_mins);   // its barrier publishes counts

  // 5. The cluster's runs merge in pairs, log2(n_blocks) rounds.  A run of
  // `width` blocks' keys lies at virtual positions [first * share, ...),
  // position p in block p / share at p % share.  Each block finds where
  // its own positions of the merged run begin and end in the two input
  // runs (two warps, in remote shared memory), copies those keys into its
  // other buffer with every load in flight at once, merges them there by
  // merge path and writes them back in place.
  Key* src_buf = cur;
  Key* dst_buf = nxt;
  for (int width = 1; width < n_blocks; width <<= 1) {
    const int first = rank / (2 * width) * (2 * width);
    const int mid = first + width;
    int la = 0, lb = 0;
    for (int b = first; b < min(mid, n_blocks); ++b) la += counts[b];
    for (int b = mid; b < min(mid + width, n_blocks); ++b) lb += counts[b];
    const int d_lo = (rank - first) * share;
    const int n_out = max(0, min(share, la + lb - d_lo));
    const auto at = [&cluster, src_buf, share](int p) {
      return *cluster.map_shared_rank(src_buf + slot(p % share), p / share);
    };
    const int a0 = first * share, b0 = mid * share;
    const auto a = [&at, a0](int i) { return at(a0 + i); };
    const auto b = [&at, b0](int i) { return at(b0 + i); };
    if (n_out > 0 && tid < 64) {
      const int i = warp_co_rank(a, la, b, lb, d_lo + (tid >> 5) * n_out);
      if ((tid & 31) == 0) part[tid >> 5] = i;
    }
    __syncthreads();
    const int i_lo = part[0], na = part[1] - part[0];
    const int j_lo = d_lo - i_lo;
#pragma unroll
    for (int x = 0; x < kItems; ++x) {
      const int q = x * kThreads + tid;
      if (q < n_out) k[x] = q < na ? a(i_lo + q) : b(j_lo + q - na);
    }
#pragma unroll
    for (int x = 0; x < kItems; ++x) {
      const int q = x * kThreads + tid;
      if (q < n_out) dst_buf[slot(q)] = k[x];
    }
    __syncthreads();
    const int d = tid * kItems;
    if (d < n_out) {
      const auto sa = [dst_buf](int i) { return dst_buf[slot(i)]; };
      const auto sb = [dst_buf, na](int i) { return dst_buf[slot(na + i)]; };
      const int i = co_rank(sa, na, sb, n_out - na, d);
      merge_items(sa, na, sb, n_out - na, i, d - i, k);
    }
    __syncthreads();
    if (d < n_out) {
#pragma unroll
      for (int x = 0; x < kItems; ++x) {
        if (d + x < n_out) dst_buf[slot(d + x)] = k[x];
      }
    }
    cluster.sync();                // also: no block leaves while read from
    Key* const t = src_buf;
    src_buf = dst_buf;
    dst_buf = t;
  }

  // 6. Emit: this block's positions of the sorted finite keys, then its
  // INF_TIME lanes at [n_finite + those of lower blocks + ..., n).
  int n_finite = 0, inf_lower = 0;
  for (int b = 0; b < n_blocks; ++b) {
    n_finite += counts[b];
    if (b < rank) inf_lower += share_lanes(b, share, n) - counts[b];
  }
  const int mine = max(0, min(share, n_finite - base));
  for (int i = tid; i < mine; i += kThreads) {
    const Key key = src_buf[slot(i)];
    order[base + i] = static_cast<int32_t>(key & 0xffffffffu);
    ready[base + i] = key_tau(key) <= w ? 1 : 0;
  }
  // The INF_TIME lanes, compacted in lane order into the free buffer (no
  // block reads another's after the last cluster barrier) with the valid
  // bit on top, then written out coalesced.
  int* const inf_stage = reinterpret_cast<int*>(dst_buf);
  int c_inf = inf_before;
#pragma unroll
  for (int x = 0; x < kItems; ++x) {
    if (inf_lanes >> x & 1) {
      inf_stage[c_inf++] = (base + tid * kItems + x) |
                           static_cast<int>((inf_valid >> x & 1) << 31);
    }
  }
  __syncthreads();
  const int inf_at = n_finite + inf_lower;
  for (int i = tid; i < totals >> 16; i += kThreads) {
    const int e = inf_stage[i];
    order[inf_at + i] = e & INT_MAX;
    ready[inf_at + i] = e < 0 && w == INT_MAX ? 1 : 0;
  }
  if (rank == 0 && tid == 0) wmark[0] = w;
}

// ---------------------------------------------------------------------------
// the multi-block path (past 65,536 lanes)
// ---------------------------------------------------------------------------

// The watermark of one call, computed by one whole block over lanes [0, n).
__global__ void __launch_bounds__(kTileThreads)
scalegate_watermark_kernel(const int32_t* __restrict__ tau,
                           const uint8_t* __restrict__ valid, int n, Gate g,
                           int32_t* __restrict__ wmark) {
  __shared__ int src_max[kMaxSources];
  __shared__ int warp_mins[kTileThreads / 32];
  const int tid = threadIdx.x;
  int m = INT_MAX;
  if (g.reports != nullptr) {
    for (int r = tid; r < g.n_reports; r += blockDim.x) {
      m = min(m, g.reports[r]);
    }
  } else if (g.n_sources > kMaxSources) {
    for (int s = tid; s < g.n_sources; s += blockDim.x) g.fold[s] = -1;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      if (valid[i]) {
        const int s = g.src[i];
        if (s >= 0 && s < g.n_sources) atomicMax(&g.fold[s], tau[i]);
      }
    }
    __syncthreads();
    for (int s = tid; s < g.n_sources; s += blockDim.x) {
      m = min(m, __ldcg(g.fold + s));
    }
  } else if (g.n_sources > 0) {
    for (int s = tid; s < g.n_sources; s += blockDim.x) src_max[s] = -1;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      if (valid[i]) {
        const int s = g.src[i];
        if (s >= 0 && s < g.n_sources) atomicMax(&src_max[s], tau[i]);
      }
    }
    __syncthreads();
    for (int s = tid; s < g.n_sources; s += blockDim.x) {
      m = min(m, src_max[s]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if ((tid & 31) == 0) warp_mins[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    int w = INT_MAX;
    for (int i = 0; i < kTileThreads / 32; ++i) w = min(w, warp_mins[i]);
    wmark[0] = w;
  }
}

// Pair t of a stage with stride j: the lower lane i (bit j clear) and its
// partner i + j.  Positions are 64-bit: the padded length reaches 2^31.
__device__ __forceinline__ long long pair_lo(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Bitonic stages of levels k_lo..k_hi with strides min(k, kTile) / 2 .. 1
// over one tile of keys in shared memory whose first lane has global index
// base.  A block of size k sorts ascending iff bit k of the global index
// is 0, so tiles sorted here merge across tiles later.
__device__ void sort_tile(Key* keys, long long base, long long k_lo,
                          long long k_hi) {
  constexpr int half = kTile >> 1;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = static_cast<int>(min(k, static_cast<long long>(kTile))) >> 1;
         j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = static_cast<int>(pair_lo(t, j));
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

// Build and sort one tile of keys; padding lanes (>= n) are keyed
// (INF_TIME, lane) and sort after every real lane.
__global__ void __launch_bounds__(kTileThreads)
scalegate_tile_sort_kernel(const int32_t* __restrict__ tau,
                           const uint8_t* __restrict__ valid, int n,
                           Key* __restrict__ keys_g) {
  extern __shared__ Key keys[];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const long long lane = base + i;
    keys[i] = lane < n ? pack(tau[lane], valid[lane], static_cast<int>(lane))
                       : pack(0, false, static_cast<int>(lane));
  }
  __syncthreads();
  sort_tile(keys, base, 2, kTile);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    keys_g[base + i] = keys[i];
  }
}

// One stage (level k, stride j >= kTile) in global memory, a thread per pair.
__global__ void scalegate_pass_kernel(Key* __restrict__ keys, long long n_pad,
                                      long long k, long long j) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (n_pad >> 1)) return;
  const long long i = pair_lo(t, j);
  const Key a = keys[i];
  const Key b = keys[i + j];
  const bool up = (i & k) == 0;
  if ((a > b) == up) {
    keys[i] = b;
    keys[i + j] = a;
  }
}

// The strides below the tile of level k, one tile per block; the last
// level (k == n_pad) emits the first n sorted positions instead of storing
// the keys back.
__global__ void __launch_bounds__(kTileThreads)
scalegate_tile_merge_kernel(Key* __restrict__ keys_g, long long n_pad,
                            long long k, const int32_t* __restrict__ tau,
                            const uint8_t* __restrict__ valid, int n,
                            const int32_t* __restrict__ wmark,
                            int32_t* __restrict__ order,
                            int32_t* __restrict__ ready) {
  extern __shared__ Key keys[];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    keys[i] = keys_g[base + i];
  }
  __syncthreads();
  sort_tile(keys, base, k, k);
  if (k < n_pad) {
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      keys_g[base + i] = keys[i];
    }
    return;
  }
  const int w = wmark[0];
  for (int i = threadIdx.x; i < kTile && base + i < n; i += blockDim.x) {
    const int lane = static_cast<int>(keys[i] & 0xffffffffu);
    order[base + i] = lane;
    ready[base + i] = (valid[lane] && tau[lane] <= w) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The kernels' function attributes, set once per device (they belong to
// the current device); the first error, if any.
cudaError_t set_attributes() {
  return repro::once_per_device([] {
    cudaError_t e = cudaFuncSetAttribute(
        scalegate_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(scalegate_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(scalegate_tile_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileSmem);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(scalegate_tile_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileSmem);
    }
    return e;
  });
}

cudaLaunchConfig_t cluster_config(int cluster, cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A refused launch's error is also the thread's last error: clear it, so
// the next launcher does not report it again.
cudaError_t launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

cudaError_t launch_cluster(const int32_t* tau, const uint8_t* valid, int n,
                           int cluster, const Gate& g, int32_t* order,
                           int32_t* ready, int32_t* wmark,
                           cudaStream_t stream) {
  const int share = (n + cluster - 1) / cluster;
  if (cluster > kMaxCluster || share > kShare) return cudaErrorInvalidValue;
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, &attr, stream);
  return launched(cudaLaunchKernelEx(&cfg, scalegate_cluster_kernel, tau,
                                     valid, n, share, g, order, ready,
                                     wmark));
}

cudaError_t launch_multi_block(const int32_t* tau, const uint8_t* valid,
                               int n, const Gate& g, Key* keys_g,
                               int32_t* order, int32_t* ready, int32_t* wmark,
                               cudaStream_t stream) {
  if (n <= kTile || keys_g == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return err;
  long long n_pad = kTile;
  while (n_pad < n) n_pad <<= 1;
  const int n_tiles = static_cast<int>(n_pad / kTile);
  scalegate_watermark_kernel<<<1, kTileThreads, 0, stream>>>(tau, valid, n,
                                                              g, wmark);
  scalegate_tile_sort_kernel<<<n_tiles, kTileThreads, kTileSmem, stream>>>(
      tau, valid, n, keys_g);
  for (long long k = kTile << 1; k <= n_pad; k <<= 1) {
    for (long long j = k >> 1; j >= kTile; j >>= 1) {
      const long long pairs = n_pad >> 1;
      scalegate_pass_kernel<<<
          static_cast<unsigned>((pairs + kTileThreads - 1) / kTileThreads),
          kTileThreads, 0, stream>>>(keys_g, n_pad, k, j);
    }
    scalegate_tile_merge_kernel<<<n_tiles, kTileThreads, kTileSmem, stream>>>(
        keys_g, n_pad, k, tau, valid, n, wmark, order, ready);
  }
  return cudaGetLastError();
}

// cluster > 0: one cluster of that many blocks; cluster == 0: the
// multi-block path (keys: its n_pad-key scratch).
int launch(const void* tau, const void* valid, int n, int cluster,
           const Gate& g, void* keys, void* order, void* ready, void* wmark,
           void* stream) {
  const auto* t = static_cast<const int32_t*>(tau);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int32_t*>(order);
  auto* r = static_cast<int32_t*>(ready);
  auto* w = static_cast<int32_t*>(wmark);
  auto* s = static_cast<cudaStream_t>(stream);
  if (n < 1 || cluster < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cluster > 0
          ? launch_cluster(t, v, n, cluster, g, o, r, w, s)
          : launch_multi_block(t, v, n, g, static_cast<Key*>(keys), o, r, w,
                               s));
}

}  // namespace

// fold: n_sources ints of global scratch, needed past kMaxSources sources.
extern "C" int repro_scalegate_merge(const void* tau, const void* src,
                                     const void* valid, int n, int n_sources,
                                     void* fold, int cluster, void* keys,
                                     void* order, void* ready, void* wmark,
                                     void* stream) {
  if (n_sources < 0 || (n_sources > kMaxSources && fold == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Gate g{static_cast<const int32_t*>(src), n_sources,
               static_cast<int*>(fold), nullptr, 0};
  return launch(tau, valid, n, cluster, g, keys, order, ready, wmark, stream);
}

extern "C" int repro_scalegate_merge_stacked(const void* tau,
                                             const void* valid, int n,
                                             const void* reports,
                                             int n_reports, int cluster,
                                             void* keys, void* order,
                                             void* ready, void* wmark,
                                             void* stream) {
  if (n_reports < 1 || n_reports > kMaxReports) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Gate g{nullptr, 0, nullptr, static_cast<const int32_t*>(reports),
               n_reports};
  return launch(tau, valid, n, cluster, g, keys, order, ready, wmark, stream);
}

// How many clusters of `cluster` blocks of the cluster merge the card can
// hold at once (0: such a cluster cannot be scheduled), or -cudaError.
extern "C" int repro_scalegate_max_clusters(int cluster) {
  const cudaError_t err = set_attributes();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, &attr, nullptr);
  int count = 0;
  const cudaError_t e = launched(cudaOccupancyMaxActiveClusters(
      &count, reinterpret_cast<const void*>(scalegate_cluster_kernel), &cfg));
  return e == cudaSuccess ? count : -static_cast<int>(e);
}
