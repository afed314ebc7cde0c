// Keyed windowed segment-reduce: acc[k, s, :] += vals[n, :] for every hit n
// with keys[n] = k, slots[n] = s (the Q1 wordcount/paircount update phase).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/segment_aggregate/segment_aggregate.py::segment_aggregate
//   (body _kernel).
//
// Contract (same as the Pallas kernel and its ref.py): a hit whose key is
// -1 or outside [0, K) is dropped; a slot outside [0, S) is dropped too
// (the core never produces one).  acc is updated in place.
//
// What bounds it on an H100: one Q1 tick is ~50k hits (12 B each) into a
// 64 KB accumulator, so it moves well under a megabyte; it is bound by
// memory latency and launch time, not by arithmetic.
//
// What the design does about it: the TPU form builds a [K*S, N] one-hot per
// key tile and contracts it on the MXU, which at K = 4096 would be a dense
// matrix of 200M elements for 50k real updates.  Here each thread owns one
// (hit, column) pair and does one atomicAdd into its cell: work and traffic
// are proportional to the hits, and the accumulator stays in L2.  Float
// atomics land in an order that varies from run to run: the result is
// exact for integer-valued contributions below 2^24 (counts), and equal to
// a sequential sum up to reordering otherwise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_aggregate_kernel(const int32_t* __restrict__ keys,
                         const int32_t* __restrict__ slots,
                         const float* __restrict__ vals,
                         float* __restrict__ acc, int n, int w, int k, int s) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n) * w) return;
  const int row = static_cast<int>(i / w);
  const int col = static_cast<int>(i % w);
  const int key = keys[row];
  const int slot = slots[row];
  if (key < 0 || key >= k || slot < 0 || slot >= s) return;
  atomicAdd(acc + (static_cast<long long>(key) * s + slot) * w + col, vals[i]);
}

}  // namespace

extern "C" int repro_segment_aggregate(const void* keys, const void* slots,
                                       const void* vals, void* acc, int n,
                                       int w, int k, int s, void* stream) {
  if (n < 0 || w < 1 || k < 1 || s < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(n) * w;
  if (items == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (items + kThreads - 1) / kThreads;
  segment_aggregate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(slots),
      static_cast<const float*>(vals), static_cast<float*>(acc), n, w, k, s);
  return static_cast<int>(cudaGetLastError());
}
