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
