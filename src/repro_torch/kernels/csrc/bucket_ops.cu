// Bucket occupancy and Definition-4 support for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in repro/kernels/bucket_ops.py:
//   slot_counts        (body _counts_kernel) - histogram of a batch's
//                      (n, t) slot matrix into (n_slots,) counts;
//   bucket_core_stats  (body _stats_kernel)  - gather sizes[slots] and
//                      reduce to support = #{i : size >= k}, core =
//                      support > 0.
// An id outside [0, n_slots) (resp. [0, nb)) contributes nothing.
//
// Bound: bytes, and at the main path's shapes (1000 x 10 slots) launch
// latency.  slot_counts reads n*t ints and writes n_slots ints;
// bucket_core_stats reads n*t ints plus the sizes it gathers and writes
// 2n ints.
//
// slot_counts: the TPU kernel adds into one output block across its
// sequential grid steps.  Hopper blocks run in parallel and in no order,
// so here the caller zeroes the output and every thread atomicAdds into
// global memory.  Integer atomics commute, so the histogram does not
// depend on the order.  Privatising the histogram in shared memory is
// left for later.
//
// bucket_core_stats: the TPU kernel copies all of `sizes` into VMEM for
// every block.  At the main path's state size that vector is hundreds of
// KB to MB, more than a block's 227 KB of shared memory, so here each
// thread owns one point, loops over its t slots and gathers the sizes
// through the read-only cache (__ldg).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void slot_counts_kernel(const int32_t* __restrict__ slots,
                                   long long m, int n_slots,
                                   int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += stride) {
    const int32_t s = slots[i];
    if (s >= 0 && s < n_slots) atomicAdd(out + s, 1);
  }
}

__global__ void bucket_core_stats_kernel(const int32_t* __restrict__ slots,
                                         const int32_t* __restrict__ sizes,
                                         int n, int t, int nb, int k,
                                         int32_t* __restrict__ support,
                                         int32_t* __restrict__ core) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int32_t* row = slots + p * t;
  int32_t c = 0;
  for (int i = 0; i < t; ++i) {
    const int32_t s = row[i];
    if (s >= 0 && s < nb && __ldg(sizes + s) >= k) ++c;
  }
  support[p] = c;
  core[p] = c > 0 ? 1 : 0;
}

}  // namespace

// slots (m,) i32 -> out (n_slots,) i32, which the caller has zeroed.
// Returns cudaGetLastError().
extern "C" int slot_counts_launch(const int32_t* slots, long long m,
                                  int n_slots, int32_t* out, void* stream) {
  const int threads = 256;
  const long long want = (m + threads - 1) / threads;
  const unsigned blocks =
      static_cast<unsigned>(want < 65535 ? (want > 0 ? want : 1) : 65535);
  slot_counts_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, m, n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

// slots (n, t) i32, sizes (nb,) i32 -> support (n,) i32, core (n,) i32.
// Returns cudaGetLastError().
extern "C" int bucket_core_stats_launch(const int32_t* slots,
                                        const int32_t* sizes, int n, int t,
                                        int nb, int k, int32_t* support,
                                        int32_t* core, void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  bucket_core_stats_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      slots, sizes, n, t, nb, k, support, core);
  return static_cast<int>(cudaGetLastError());
}
