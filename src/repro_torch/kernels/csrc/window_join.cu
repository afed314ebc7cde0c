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
// R=256), each two integer compares, 2*n_attrs float ops and two counter
// adds, while the inputs are a few MB: the kernel is bound by instruction
// issue, not by bytes.  So every instruction that is not a pair test
// (loads, address arithmetic, per-entry work) has to be shared by many
// pairs.
//
// What the design does about it:
//  - A block is kWarps key rows (one a warp) x 32 * kTuples incoming
//    tuples.  Each thread holds kTuples incoming tuples in registers (tau,
//    src, the first n_attrs payload columns, two counters each), so one
//    stored entry, read once by a thread, serves kTuples pair tests;
//    per-entry work (the horizon st_tau + ws, emptiness) is done once per
//    entry.  kTuples is 8, or 2 where 8 would leave SMs without a block
//    (small calls such as Q3's are latency-bound: more blocks win).
//    The pair test is chained predicates, no branches: emptiness folds
//    into the horizon (INT_MIN, exact for incoming tau above it; a block
//    that holds an incoming INT_MIN tests emptiness apart), and the main
//    path's two columns go through pair2 (PTX), 8 instructions a pair.
//  - A warp stages its row in chunks of kChunk entries (tau, src and the
//    first n_attrs payload columns, transposed to one array per column) in
//    shared memory with cp.async, double-buffered: chunk c + 1 is in flight
//    while chunk c is compared.  All lanes of the warp read the same entry,
//    so each 16-byte shared load is a broadcast of 4 entries.  A row's last
//    chunk is compared only as far as its entries go (to a multiple of 4).
//  - A chunk in which no entry is live and fresh for the warp's earliest
//    incoming tuple is skipped whole (all empty, or every horizon below
//    it): such pairs add to neither counts nor comps, so the skip is
//    exact.  Rings older than their window have such runs; the bench
//    shape, all fresh, does not.
//  - The pair test itself is exact at the edges: the horizon wraps as
//    int32, stored tau < 0 is empty whatever its horizon, and incoming
//    lanes past B (staged as INF_TIME, as the Pallas wrapper pads) keep
//    their own counters, which are neither stored nor summed into comps.
//  - counts go through shared memory and out as one 32-byte segment per
//    incoming tuple; comps is reduced per warp and block, then one 64-bit
//    atomicAdd per block.
// Any n_attrs <= P is taken, as the reference kernel unrolls any: the first
// kMaxAttrs columns are a template argument (Q3 and Q6 use 2); past them a
// second body reads the remaining columns from global memory for the pairs
// that pass the first ones.  Every block sits on grid axis x (its 2^31 - 1
// limit), incoming tiles fastest, so any K; B and R need not be multiples
// of any tile.
//
// A second entry below, window_join_emit, is the fast join tick's phase 1
// with its emission.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // key rows a block, one a warp
constexpr int kChunk = 32;                 // stored entries a stage, one a lane
constexpr int kMaxAttrs = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int horizon(int tau, int ws) {
  return static_cast<int>(static_cast<unsigned>(tau) +
                          static_cast<unsigned>(ws));
}

template <class V>
__device__ __forceinline__ auto lane_of(const V& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The pair test of the main path (two payload columns) as predicates:
// opp += (hl >= tn && s != sn); cnt += that && |q0 - p0| <= band &&
// |q1 - p1| <= band.  hl is the stored entry's horizon, INT_MIN when it is
// empty, which is exact for tn above INT_MIN.  Two integer and two float
// compares chained through predicates, two subtracts, two predicated adds.
__device__ __forceinline__ void pair2(int hl, int s, float p0, float p1,
                                      int tn, int sn, float q0, float q1,
                                      float band, int& cnt, unsigned& opp) {
  asm("{\n\t"
      ".reg .pred po, pm;\n\t"
      ".reg .f32 d;\n\t"
      "setp.ge.s32 po, %2, %4;\n\t"
      "setp.ne.and.s32 po, %3, %5, po;\n\t"
      "sub.f32 d, %6, %8;\n\t"
      "abs.f32 d, d;\n\t"
      "setp.le.and.f32 pm, d, %10, po;\n\t"
      "sub.f32 d, %7, %9;\n\t"
      "abs.f32 d, d;\n\t"
      "setp.le.and.f32 pm, d, %10, pm;\n\t"
      "@po add.s32 %1, %1, 1;\n\t"
      "@pm add.s32 %0, %0, 1;\n\t"
      "}"
      : "+r"(cnt), "+r"(opp)
      : "r"(hl), "r"(s), "r"(tn), "r"(sn), "f"(q0), "f"(q1), "f"(p0),
        "f"(p1), "f"(band));
}

// kNA: payload columns unrolled (n_attrs, or kMaxAttrs when kWide);
// kWide: n_attrs > kMaxAttrs, the rest read from global memory;
// kTuples: incoming tuples a thread holds (a block holds 32 x kTuples).
template <int kNA, bool kWide, int kTuples>
__global__ void __launch_bounds__(kWarps * 32)
window_join_kernel(const int32_t* __restrict__ new_tau,
                   const int32_t* __restrict__ new_src,
                   const float* __restrict__ new_pay, int b_total, int p,
                   const int32_t* __restrict__ st_tau,
                   const int32_t* __restrict__ st_src,
                   const float* __restrict__ st_pay, int k_total, int r_total,
                   int ws, float band, int n_attrs, int b_tiles,
                   int32_t* __restrict__ counts,
                   unsigned long long* __restrict__ comps) {
  constexpr int kCols = kNA > 0 ? kNA : 1;
  constexpr int kTileB = 32 * kTuples;
  __shared__ __align__(16) int s_tau[kWarps][2][kChunk];
  __shared__ __align__(16) int s_src[kWarps][2][kChunk];
  __shared__ __align__(16) float s_pay[kWarps][2][kCols][kChunk];
  __shared__ int s_counts[kTileB][kWarps + 1];     // padded: no conflicts
  __shared__ unsigned long long s_comps[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = static_cast<int>(blockIdx.x % b_tiles) * kTileB;
  const int k0 = static_cast<int>(blockIdx.x / b_tiles) * kWarps;
  const int k = k0 + warp;

  // The thread's incoming tuples b0 + j * 32 + lane; those past B stage
  // INF_TIME and are dropped at the end.
  int tn[kTuples], sn[kTuples], cnt[kTuples];
  unsigned opp[kTuples];
  float pn[kTuples][kCols];
#pragma unroll
  for (int j = 0; j < kTuples; ++j) {
    const int b = b0 + j * 32 + lane;
    const bool in = b < b_total;
    tn[j] = in ? new_tau[b] : INT_MAX;
    sn[j] = in ? new_src[b] : 0;
#pragma unroll
    for (int a = 0; a < kCols; ++a) {
      pn[j][a] = (in && a < kNA) ? new_pay[static_cast<long long>(b) * p + a]
                                 : 0.f;
    }
    cnt[j] = 0;
    opp[j] = 0u;
  }

  // Emptiness folds into the horizon (INT_MIN) unless an incoming tau is
  // INT_MIN itself; such a block keeps the test with emptiness apart.
  bool has_min = false;
#pragma unroll
  for (int j = 0; j < kTuples; ++j) has_min |= tn[j] == INT_MIN;
  const bool folded = !__syncthreads_or(has_min);

  if (k < k_total) {                      // warp-uniform
    int min_tn = tn[0];
#pragma unroll
    for (int j = 1; j < kTuples; ++j) min_tn = min(min_tn, tn[j]);
    min_tn = __reduce_min_sync(kFull, min_tn);

    const long long row = static_cast<long long>(k) * r_total;
    const int n_chunks = (r_total + kChunk - 1) / kChunk;
    // Lane `lane` stages entry c * kChunk + lane of the row into buffer
    // buf; an entry past R stages as empty (tau -1).
    const auto stage = [&](int c, int buf) {
      const int r = c * kChunk + lane;
      if (r < r_total) {
        const long long e = row + r;
        cp_async4(&s_tau[warp][buf][lane], st_tau + e);
        cp_async4(&s_src[warp][buf][lane], st_src + e);
#pragma unroll
        for (int a = 0; a < kNA; ++a) {
          cp_async4(&s_pay[warp][buf][a][lane], st_pay + e * p + a);
        }
      } else {
        s_tau[warp][buf][lane] = -1;
      }
      cp_async_commit();
    };

    if (n_chunks > 0) stage(0, 0);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_chunks) {
        stage(c + 1, buf ^ 1);
      } else {
        cp_async_commit();                // keeps one group per chunk
      }
      cp_async_wait_one();                // chunk c has landed
      __syncwarp();
      const int t_own = s_tau[warp][buf][lane];
      // the chunk's staged entries, to a multiple of 4 (the rest empty)
      const int n_e = min(kChunk, (r_total - c * kChunk + 3) & ~3);
      const auto compare = [&](auto folded_t) {
        constexpr bool kFolded = decltype(folded_t)::value;
#pragma unroll 2
        for (int e4 = 0; e4 < n_e; e4 += 4) {
          const int4 t4 = *reinterpret_cast<const int4*>(&s_tau[warp][buf][e4]);
          const int4 s4 = *reinterpret_cast<const int4*>(&s_src[warp][buf][e4]);
          float4 p4[kCols];
#pragma unroll
          for (int a = 0; a < kNA; ++a) {
            p4[a] = *reinterpret_cast<const float4*>(&s_pay[warp][buf][a][e4]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = lane_of(t4, e);
            const int s = lane_of(s4, e);
            const int h = horizon(t, ws);
            const bool live = t >= 0;
            const int hl = live ? h : INT_MIN;
#pragma unroll
            for (int j = 0; j < kTuples; ++j) {
              if constexpr (kFolded && kNA == 2 && !kWide) {
                pair2(hl, s, lane_of(p4[0], e), lane_of(p4[1], e), tn[j],
                      sn[j], pn[j][0], pn[j][1], band, cnt[j], opp[j]);
                continue;
              }
              // & not &&: predicates, no branches
              const bool o = (kFolded ? hl >= tn[j] : live & (h >= tn[j])) &
                             (s != sn[j]);
              bool m = o;
#pragma unroll
              for (int a = 0; a < kNA; ++a) {
                m = m & (fabsf(pn[j][a] - lane_of(p4[a], e)) <= band);
              }
              if (kWide && m) {
                const float* sp = st_pay + (row + c * kChunk + e4 + e) * p;
                const float* mp =
                    new_pay +
                    static_cast<long long>(min(b0 + j * 32 + lane,
                                               b_total - 1)) * p;
                for (int a = kMaxAttrs; a < n_attrs && m; ++a) {
                  m = fabsf(mp[a] - sp[a]) <= band;
                }
              }
              cnt[j] += m;
              opp[j] += o;
            }
          }
        }
      };
      if (__any_sync(kFull, t_own >= 0 && horizon(t_own, ws) >= min_tn)) {
        if (folded) {
          compare(std::true_type());
        } else {
          compare(std::false_type());
        }
      }
      __syncwarp();                       // buf is read: it may be restaged
    }
  }

  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < kTuples; ++j) {
    s_counts[j * 32 + lane][warp] = cnt[j];
    if (b0 + j * 32 + lane < b_total) mine += opp[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mine += __shfl_down_sync(kFull, mine, off);
  }
  if (lane == 0) s_comps[warp] = mine;
  __syncthreads();
  for (int i = threadIdx.x; i < kTileB * kWarps; i += kWarps * 32) {
    const int b = b0 + i / kWarps;
    const int kk = k0 + i % kWarps;
    if (b < b_total && kk < k_total) {
      counts[static_cast<long long>(b) * k_total + kk] =
          s_counts[i / kWarps][i % kWarps];
    }
  }
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kWarps; ++i) total += s_comps[i];
    if (total) atomicAdd(comps, total);
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, const float*, int, int,
                        const int32_t*, const int32_t*, const float*, int, int,
                        int, float, int, int, int32_t*, unsigned long long*);

template <int kT, int... kNA>
Kernel pick(int n_attrs, std::integer_sequence<int, kNA...>) {
  static const Kernel table[] = {window_join_kernel<kNA, false, kT>...};
  return n_attrs <= kMaxAttrs ? table[n_attrs]
                              : window_join_kernel<kMaxAttrs, true, kT>;
}

// 8 tuples a thread when that still gives every SM a block, else 2 (small
// shapes such as Q3's B 256, K 512 are latency-bound: more blocks).
int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return count;
}

}  // namespace

extern "C" int repro_window_join(const void* new_tau, const void* new_src,
                                 const void* new_pay, int b, int p,
                                 const void* st_tau, const void* st_src,
                                 const void* st_pay, int k, int r, int ws,
                                 float band, int n_attrs, void* counts,
                                 void* comps, void* stream) {
  const long long k_tiles = (k + kWarps - 1) / kWarps;
  const int tuples = (b + 255) / 256 * k_tiles >= sm_count() ? 8 : 2;
  const long long b_tiles = (b + 32 * tuples - 1) / (32 * tuples);
  if (b < 0 || k < 0 || r < 0 || p < 1 || n_attrs < 0 || n_attrs > p ||
      b_tiles * k_tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(comps, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const auto attrs = std::make_integer_sequence<int, kMaxAttrs + 1>();
  const Kernel kernel =
      tuples == 8 ? pick<8>(n_attrs, attrs) : pick<2>(n_attrs, attrs);
  kernel<<<static_cast<unsigned>(b_tiles * k_tiles), kWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(new_tau), static_cast<const int32_t*>(new_src),
      static_cast<const float*>(new_pay), b, p,
      static_cast<const int32_t*>(st_tau), static_cast<const int32_t*>(st_src),
      static_cast<const float*>(st_pay), k, r, ws, band, n_attrs,
      static_cast<int>(b_tiles), static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(comps));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// window_join_emit: ScaleJoin's phase-1 compare and its ordered emission
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel.  The reference computes phase 1 of its fast
// join tick (src/repro/core/join.py tick_fast) as XLA operations on dense
// [B, K, R] masks, and the port did the same in PyTorch: once an instance
// and epoch phase (32 times a Q3 tick), over every stored slot (B 32 x K
// 4,096 x R 160), before masking the result to the instance's own rows.
// This kernel is one instance's phase 1:
//   comps = #{(b, k, r) : live[b] && resp[k] && st_tau[k,r] >= 0
//                         && st_tau[k,r] + ws >= new_tau[b] (int32 wrap)
//                         && st_src[k,r] != new_src[b]}
//   n1    = #{the same && |new_pay[b,a] - st_pay[k,r,a]| <= band, a < n_attrs}
//   rows  = the flat indices b*K*R + k*R + r of the first min(n1, out_cap)
//           of those hits in ascending order, -1 past them
// (torch.nonzero_static's lanes), the same numbers as its plain version.
//
// What bounds it on an H100: the instance's stored rows, read once (tau,
// stream and the payload: 36 B an entry at Q3's P 7), ~22 MB for the whole
// 600,000-tuple window over a phase's 16 calls, ~7 us at 3.35 TB/s; the
// pair tests (B per stored entry, ~10 instructions each) take about as
// long.  Hits are rare: ~4e-6 of Q3's pairs.
//
// What the design does about it:
//  - A block of 16 warps takes a tile of 32 key rows and 32 incoming
//    tuples, one a lane, held in registers.  A ballot of resp over the
//    tile names its rows: a row outside resp is never read, and an instance with none
//    costs its launch and its resp bytes.  The (row, chunk of 32 entries)
//    items of the tile's rows are dealt over the block's warps, so the
//    few rows an instance holds in a tile (K / n_active, round-robin) keep
//    them busy; the loads of a chunk are latency-bound, so the warps, not
//    one warp's depth, hide them.
//  - A warp stages a chunk (tau, stream, the first n_attrs <= 8 payload
//    columns; one entry a lane, one array a field) in shared memory and
//    loads its next item into registers while it compares this one; every
//    lane reads the same entries, 16-byte broadcasts of 4.  A chunk with
//    no entry live and fresh for the warp's earliest live tuple is skipped
//    whole.  Columns past the 8th are read from global memory for the pairs
//    that pass the first ones.
//  - The emission is exact and ordered, and no atomic decides an order:
//    each block writes its hits per (tuple, tile), its comps and its hits'
//    rows, up to 64, sorted (rank sort in shared memory; the rows are
//    distinct, so the order is the rows').  The last block to finish (a
//    ticket counter, zeroed by the launcher) sums comps, scans the counts
//    in (b, tile) order and copies each list's rows from its (b, tile)
//    offsets, a block's list a thread.  A block with more than 64 hits
//    keeps no list: the last block reads its tile again, counts the hits
//    per row and writes them in (b, k, r) order; only such tiles, among
//    the first out_cap hits, are read twice.
//  - One launch and one 4-byte memset a call, no host read and no shape
//    that depends on the data: it runs inside a captured CUDA graph.

namespace {

constexpr int kEmitWarps = 16;
constexpr int kEmitThreads = kEmitWarps * 32;
constexpr int kScanItems = 16;             // counts a thread scans a round
constexpr int kTileRows = 32;              // key rows a tile, one a lane's resp
constexpr int kEmitChunk = 32;             // stored entries an item, one a lane
constexpr int kStagedCols = 8;             // payload columns staged
constexpr int kListCap = 64;               // hits a block keeps in order

struct EmitArgs {
  const int32_t* new_tau;
  const int32_t* new_src;
  const float* new_pay;
  const uint8_t* new_live;
  const int32_t* st_tau;
  const int32_t* st_src;
  const float* st_pay;
  const uint8_t* resp;
  int b_total, p, k_total, r_total, ws, n_attrs, out_cap, n_tiles, b_tiles;
  float band;
  int32_t* counts;                 // [b_total, n_tiles] hits, then first lane
  int32_t* need;                   // [n_tiles] the tile is revisited
  int32_t* n_list;                 // [grid] hits a block found
  long long* lists;                // [grid, kListCap] a block's rows, in order
  unsigned long long* comps_part;  // [grid]
  unsigned* ticket;
  long long* rows;
  int32_t* n1;
  long long* comps;
};

// kNA: the payload columns compared, 2 (Q3's), or -1 for n_attrs at run
// time (up to kStagedCols staged, the rest from global memory).
template <int kNA>
__host__ __device__ constexpr int cols_of() {
  return kNA >= 0 ? kNA : kStagedCols;
}

template <int kCols>
struct alignas(16) EmitStage {
  int t[kEmitChunk];
  int s[kEmitChunk];
  float pay[kCols][kEmitChunk];
};

template <int kCols>
struct Incoming {
  int tn, sn;
  bool live;
  float pn[kCols];
};

template <int kCols>
struct Entry {
  int t, s;
  float pay[kCols];
};

template <int kCols>
__device__ __forceinline__ Incoming<kCols> load_incoming(const EmitArgs& a,
                                                         int b, int staged) {
  Incoming<kCols> in;
  const bool ok = b < a.b_total;
  in.live = ok && a.new_live[b] != 0;
  in.tn = ok ? a.new_tau[b] : INT_MAX;
  in.sn = ok ? a.new_src[b] : 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    in.pn[c] = (ok && c < staged)
                   ? a.new_pay[static_cast<long long>(b) * a.p + c] : 0.f;
  }
  return in;
}

// Entry r of row k (empty past R).
template <int kCols>
__device__ __forceinline__ Entry<kCols> load_entry(const EmitArgs& a, int k,
                                                   int r, int staged) {
  Entry<kCols> e;
  const bool in = r < a.r_total;
  const long long i = static_cast<long long>(k) * a.r_total + r;
  e.t = in ? __ldg(a.st_tau + i) : -1;
  e.s = in ? __ldg(a.st_src + i) : 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    e.pay[c] = (in && c < staged) ? __ldg(a.st_pay + i * a.p + c) : 0.f;
  }
  return e;
}

template <int kCols>
__device__ __forceinline__ void stage_entry(EmitStage<kCols>& st,
                                            const Entry<kCols>& e, int lane) {
  st.t[lane] = e.t;
  st.s[lane] = e.s;
#pragma unroll
  for (int c = 0; c < kCols; ++c) st.pay[c][lane] = e.pay[c];
}

// The tile's resp rows as a bit a lane.
__device__ __forceinline__ unsigned tile_mask(const EmitArgs& a, int k0,
                                              int lane) {
  const int k = k0 + lane;
  return __ballot_sync(kFull, k < a.k_total && a.resp[k] != 0);
}

// The n-th (from 0) set bit of mask, warp-wide.
__device__ __forceinline__ int nth_row(unsigned mask, int n, int lane) {
  const bool pick = ((mask >> lane) & 1u) &&
                    __popc(mask & ((1u << lane) - 1u)) == n;
  return __ffs(__ballot_sync(kFull, pick)) - 1;
}

// The lane's tuple against the chunk's first n_e staged entries (a
// multiple of 4; entries past R are staged empty), in entry order:
// on_pair(e, opp, hit).  entry0 is the chunk's first stored entry.
template <int kNA, class F>
__device__ __forceinline__ void compare_chunk(
    const EmitStage<cols_of<kNA>()>& st, int n_e,
    const Incoming<cols_of<kNA>()>& in, const EmitArgs& a, int staged,
    long long entry0, int b, F&& on_pair) {
  constexpr int kCols = cols_of<kNA>();
#pragma unroll 2
  for (int e4 = 0; e4 < n_e; e4 += 4) {
    const int4 t4 = *reinterpret_cast<const int4*>(&st.t[e4]);
    const int4 s4 = *reinterpret_cast<const int4*>(&st.s[e4]);
    float4 p4[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      p4[c] = *reinterpret_cast<const float4*>(&st.pay[c][e4]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = lane_of(t4, q);
      // & not &&: predicates, no branches
      const bool o = (t >= 0) & (horizon(t, a.ws) >= in.tn) &
                     (lane_of(s4, q) != in.sn);
      bool m = o;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (kNA >= 0 || c < staged) {
          m = m & (fabsf(in.pn[c] - lane_of(p4[c], q)) <= a.band);
        }
      }
      if (kNA < 0 && a.n_attrs > kStagedCols && m && in.live) {
        const float* sp = a.st_pay + (entry0 + e4 + q) * a.p;
        const float* np = a.new_pay + static_cast<long long>(b) * a.p;
        for (int c = kStagedCols; c < a.n_attrs && m; ++c) {
          m = fabsf(np[c] - sp[c]) <= a.band;
        }
      }
      on_pair(e4 + q, o, m);
    }
  }
}

// Every pair of the lane's tuple with the tile's resp rows, the (row,
// chunk) items dealt over the warps: on_pair(row rank, k, r, opp, hit).
template <int kNA, class F>
__device__ __forceinline__ void walk_tile(const EmitArgs& a, int k0,
                                          unsigned mask,
                                          const Incoming<cols_of<kNA>()>& in,
                                          int b, int staged,
                                          EmitStage<cols_of<kNA>()>& st,
                                          F&& on_pair) {
  constexpr int kCols = cols_of<kNA>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_chunks = (a.r_total + kEmitChunk - 1) / kEmitChunk;
  const int n_items = __popc(mask) * n_chunks;
  const int min_tn = __reduce_min_sync(kFull, in.live ? in.tn : INT_MAX);
  const auto fetch = [&](int item) {
    const int k = k0 + nth_row(mask, item / n_chunks, lane);
    return load_entry<kCols>(a, k, item % n_chunks * kEmitChunk + lane,
                             staged);
  };
  Entry<kCols> next;
  if (warp < n_items) next = fetch(warp);
  for (int item = warp; item < n_items; item += kEmitWarps) {
    stage_entry(st, next, lane);
    const int t_own = next.t;
    __syncwarp();
    if (item + kEmitWarps < n_items) next = fetch(item + kEmitWarps);
    const int ri = item / n_chunks;
    const int r0 = item % n_chunks * kEmitChunk;
    if (__any_sync(kFull, t_own >= 0 && horizon(t_own, a.ws) >= min_tn)) {
      const int k = k0 + nth_row(mask, ri, lane);
      compare_chunk<kNA>(
          st, min(kEmitChunk, (a.r_total - r0 + 3) & ~3), in, a, staged,
          static_cast<long long>(k) * a.r_total + r0, b,
          [&](int e, bool o, bool m) { on_pair(ri, k, r0 + e, o, m); });
    }
    __syncwarp();                         // st is read: it may be restaged
  }
}

// Exclusive prefix of v over the block; total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kEmitWarps; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  __syncthreads();
  return base + x - v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

template <int kNA>
__global__ void __launch_bounds__(kEmitThreads)
window_join_emit_kernel(const EmitArgs a) {
  constexpr int kCols = cols_of<kNA>();
  __shared__ EmitStage<kCols> s_stage[kEmitWarps];
  __shared__ int s_cnt[kTileRows][33];      // padded: no bank conflicts
  __shared__ int s_pos[kTileRows][33];
  __shared__ long long s_hits[kListCap];
  __shared__ unsigned long long s_sum[kEmitWarps];
  __shared__ int s_scan[kEmitWarps];
  __shared__ int s_flag[kEmitThreads];
  __shared__ int s_nhits;
  __shared__ bool s_last;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int staged = kNA >= 0 ? kNA : min(a.n_attrs, kStagedCols);
  const long long kr = static_cast<long long>(a.k_total) * a.r_total;

  // -- pass 1: this block's tile and 32 tuples: hits, their rows, comps ---
  {
    const int tile = blockIdx.x / a.b_tiles;
    const int bt = blockIdx.x % a.b_tiles;
    const int b = bt * 32 + lane;
    const int k0 = tile * kTileRows;
    const unsigned mask = tile_mask(a, k0, lane);
    Incoming<kCols> in{};                 // a tile with no row reads none
    if (mask) in = load_incoming<kCols>(a, b, staged);
    if (threadIdx.x == 0) s_nhits = 0;
    __syncthreads();
    int cnt = 0;
    unsigned opp = 0;
    walk_tile<kNA>(a, k0, mask, in, b, staged,
                   s_stage[warp], [&](int, int k, int r, bool o, bool m) {
                     cnt += m;
                     opp += o;
                     if (m && in.live) {      // rare: kept unordered
                       const int slot = atomicAdd(&s_nhits, 1);
                       if (slot < kListCap) {
                         s_hits[slot] =
                             b * kr + static_cast<long long>(k) * a.r_total + r;
                       }
                     }
                   });
    s_cnt[warp][lane] = in.live ? cnt : 0;
    const unsigned long long sum = warp_sum(in.live ? opp : 0u);
    if (lane == 0) s_sum[warp] = sum;
    __syncthreads();
    if (warp == 0) {
      int hits = 0;
#pragma unroll
      for (int w = 0; w < kEmitWarps; ++w) hits += s_cnt[w][lane];
      if (b < a.b_total) {
        a.counts[static_cast<long long>(b) * a.n_tiles + tile] = hits;
      }
      if (lane == 0) {
        unsigned long long total = 0;
        for (int w = 0; w < kEmitWarps; ++w) total += s_sum[w];
        a.comps_part[blockIdx.x] = total;
        a.n_list[blockIdx.x] = s_nhits;
        if (bt == 0) a.need[tile] = 0;
      }
    }
    // the block's rows in order (rows are distinct: a rank sort); a block
    // with more than kListCap hits keeps none and is revisited below
    const int n_hits = s_nhits;
    if (n_hits <= kListCap && threadIdx.x < n_hits) {
      const long long v = s_hits[threadIdx.x];
      int rank = 0;
      for (int j = 0; j < n_hits; ++j) rank += s_hits[j] < v;
      a.lists[static_cast<long long>(blockIdx.x) * kListCap + rank] = v;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  // -- the last block: comps, the scan, the lanes past n1 -----------------
  unsigned long long part = 0;
  int found = 0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += kEmitThreads) {
    part += __ldcg(a.comps_part + i);
    found |= __ldcg(a.n_list + i);
  }
  part = warp_sum(part);
  if (lane == 0) s_sum[warp] = part;
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kEmitWarps; ++w) total += s_sum[w];
    *a.comps = static_cast<long long>(total);
    if (!found) *a.n1 = 0;
  }
  if (!found) {                 // no hit (an instance with no row): no rows
    for (int i = threadIdx.x; i < a.out_cap; i += kEmitThreads) a.rows[i] = -1;
    return;
  }
  // counts in (b, tile) order, in rounds of kScanItems a thread (its own
  // run, loaded at once): each (b, tile) with a hit among the first
  // out_cap gets its first lane, the rest -1; a tile whose block kept no
  // list is revisited
  const long long n_counts = static_cast<long long>(a.b_total) * a.n_tiles;
  int n1 = 0;
  for (long long r0 = 0; r0 < n_counts; r0 += kEmitThreads * kScanItems) {
    const long long lo = r0 + threadIdx.x * kScanItems;
    int v[kScanItems];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = lo + j < n_counts ? __ldcg(a.counts + lo + j) : 0;
      run += v[j];
    }
    int total = 0;
    int off = n1 + block_exclusive_scan(run, s_scan, total);
    n1 += total;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const long long i = lo + j;
      if (i >= n_counts) break;
      const bool first = v[j] > 0 && off < a.out_cap;
      a.counts[i] = first ? off : -1;
      const int tile = static_cast<int>(i % a.n_tiles);
      const int blk = tile * a.b_tiles + static_cast<int>(i / a.n_tiles) / 32;
      if (first && __ldcg(a.n_list + blk) > kListCap) a.need[tile] = 1;
      off += v[j];
    }
  }
  if (threadIdx.x == 0) *a.n1 = n1;
  for (int i = min(n1, a.out_cap) + threadIdx.x; i < a.out_cap;
       i += kEmitThreads) {
    a.rows[i] = -1;
  }
  __syncthreads();

  // -- the last block: each list's rows from its (b, tile) first lanes ----
  for (int blk = threadIdx.x; blk < static_cast<int>(gridDim.x);
       blk += kEmitThreads) {
    const int n = __ldcg(a.n_list + blk);
    if (n > kListCap) continue;
    const int tile = blk / a.b_tiles;
    long long cur = -1;
    int pos = -1;
    for (int i = 0; i < n; ++i) {
      const long long row = __ldcg(a.lists + static_cast<long long>(blk) *
                                                 kListCap + i);
      const long long b = row / kr;
      if (b != cur) {
        cur = b;
        pos = __ldcg(a.counts + b * a.n_tiles + tile);
      }
      if (pos >= 0 && pos < a.out_cap) a.rows[pos++] = row;
    }
  }

  // -- the last block: the rows of each tile revisited (its block's hits
  // past kListCap), counted again per row, then written in order ---------
  const int n_chunks = (a.r_total + kEmitChunk - 1) / kEmitChunk;
  for (int base = 0; base < a.n_tiles; base += kEmitThreads) {
    const int t = base + threadIdx.x;
    s_flag[threadIdx.x] = t < a.n_tiles && __ldcg(a.need + t);
    __syncthreads();
    for (int j = 0; j < kEmitThreads && base + j < a.n_tiles; ++j) {
      if (!s_flag[j]) continue;             // block-uniform
      const int tile = base + j;
      const int k0 = tile * kTileRows;
      const unsigned mask = tile_mask(a, k0, lane);
      const int n_rows = __popc(mask);
      for (int bt = 0; bt < a.b_tiles; ++bt) {
        if (__ldcg(a.n_list + tile * a.b_tiles + bt) <= kListCap) continue;
        const int b = bt * 32 + lane;
        const int first =
            b < a.b_total
                ? __ldcg(a.counts + static_cast<long long>(b) * a.n_tiles +
                         tile)
                : -1;
        if (!__syncthreads_or(first >= 0)) continue;
        const Incoming<kCols> in = load_incoming<kCols>(a, b, staged);
        for (int i = threadIdx.x; i < kTileRows * 33; i += kEmitThreads) {
          (&s_cnt[0][0])[i] = 0;
        }
        __syncthreads();
        // the hits per (row, tuple), then each row's first lane
        walk_tile<kNA>(a, k0, mask, in, b, staged, s_stage[warp],
                       [&](int ri, int, int, bool, bool m) {
                         if (m && in.live) atomicAdd(&s_cnt[ri][lane], 1);
                       });
        __syncthreads();
        if (warp == 0) {
          int pos = first;
          for (int ri = 0; ri < n_rows; ++ri) {
            s_pos[ri][lane] = pos;
            pos += s_cnt[ri][lane];
          }
        }
        __syncthreads();
        // a warp a row, its entries in order
        for (int ri = warp; ri < n_rows; ri += kEmitWarps) {
          int pos = s_pos[ri][lane];
          const bool want = in.live && first >= 0 && s_cnt[ri][lane] > 0 &&
                            pos < a.out_cap;
          if (!__any_sync(kFull, want)) continue;
          const int k = k0 + nth_row(mask, ri, lane);
          const long long row0 =
              b * kr + static_cast<long long>(k) * a.r_total;
          for (int c = 0; c < n_chunks; ++c) {
            const int r0 = c * kEmitChunk;
            stage_entry(s_stage[warp],
                        load_entry<kCols>(a, k, r0 + lane, staged), lane);
            __syncwarp();
            compare_chunk<kNA>(
                s_stage[warp], min(kEmitChunk, (a.r_total - r0 + 3) & ~3),
                in, a, staged, static_cast<long long>(k) * a.r_total + r0, b,
                [&](int e, bool, bool m) {
                  if (want && m) {
                    if (pos < a.out_cap) a.rows[pos] = row0 + r0 + e;
                    ++pos;
                  }
                });
            __syncwarp();
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();                      // s_flag is read
  }
}

}  // namespace

extern "C" int repro_window_join_emit(
    const void* new_tau, const void* new_src, const void* new_pay,
    const void* new_live, int b, int p, const void* st_tau,
    const void* st_src, const void* st_pay, const void* resp, int k, int r,
    int ws, float band, int n_attrs, int out_cap, void* scratch,
    long long scratch_bytes, void* rows, void* n1, void* comps,
    void* stream) {
  if (b < 0 || k < 0 || r < 0 || p < 1 || n_attrs < 0 || n_attrs > p ||
      out_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = std::max(1LL, (k + kTileRows - 1LL) / kTileRows);
  const long long b_tiles = std::max(1LL, (b + 31LL) / 32);
  const long long grid = n_tiles * b_tiles;
  // comps_part [grid] u64, lists [grid, kListCap] i64, counts [max(b, 1),
  // n_tiles], n_list [grid], need [n_tiles], ticket: ops.py's
  // emit_scratch_bytes
  const long long need_bytes =
      grid * 8 * (1 + kListCap) +
      (std::max(b, 1) * n_tiles + grid + n_tiles + 1) * 4;
  if (grid > INT_MAX || scratch_bytes < need_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EmitArgs a;
  a.new_tau = static_cast<const int32_t*>(new_tau);
  a.new_src = static_cast<const int32_t*>(new_src);
  a.new_pay = static_cast<const float*>(new_pay);
  a.new_live = static_cast<const uint8_t*>(new_live);
  a.st_tau = static_cast<const int32_t*>(st_tau);
  a.st_src = static_cast<const int32_t*>(st_src);
  a.st_pay = static_cast<const float*>(st_pay);
  a.resp = static_cast<const uint8_t*>(resp);
  a.b_total = b;
  a.p = p;
  a.k_total = k;
  a.r_total = r;
  a.ws = ws;
  a.n_attrs = n_attrs;
  a.out_cap = out_cap;
  a.n_tiles = static_cast<int>(n_tiles);
  a.b_tiles = static_cast<int>(b_tiles);
  a.band = band;
  a.comps_part = static_cast<unsigned long long*>(scratch);
  a.lists = reinterpret_cast<long long*>(a.comps_part + grid);
  a.counts = reinterpret_cast<int32_t*>(a.lists + grid * kListCap);
  a.n_list = a.counts + std::max(b, 1) * n_tiles;
  a.need = a.n_list + grid;
  a.ticket = reinterpret_cast<unsigned*>(a.need + n_tiles);
  a.rows = static_cast<long long*>(rows);
  a.n1 = static_cast<int32_t*>(n1);
  a.comps = static_cast<long long*>(comps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = n_attrs == 2 ? window_join_emit_kernel<2>
                                   : window_join_emit_kernel<-1>;
  kernel<<<static_cast<unsigned>(grid), kEmitThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
