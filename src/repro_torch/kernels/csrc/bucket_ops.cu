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
// Two forms.  The standalone kernels keep the Pallas kernels' contracts
// (ops.slot_counts, ops.bucket_core_stats).  The engine's insert batch
// runs both as ONE cooperative launch, bucket_insert_pass: the histogram
// is added into the caller's device size table in place, a grid-wide
// barrier, then every thread copies the new sizes and gathers the
// support against them, into one packed output [sizes (nb) | support
// (n)] that a single download returns.  The sampled-core engine's insert
// batch (core.approx) takes the pass's masked route,
// bucket_insert_pass_masked: a second table, the sampled sizes, gains the
// histogram of the rows a byte mask selects, in the same atomic loop, and
// every row's support is gathered against it; the output is [sizes |
// sampled sizes | support].  The reference runs that batch as three
// kernel calls (slot_counts of every row, slot_counts of the sampled rows,
// bucket_core_stats against the sampled sizes).
//
// Bound: launch latency.  At the main path's shapes (1000 x 10 slots,
// 3,756 slots) the insert pass moves ~80 KB (the ids once, the size table
// read once and its touched entries written, the packed output written):
// 0.024 us at 3.35 TB/s, against ~2 us of launch a kernel (each of the
// two standalone kernels took 1.8-2.1 us on the device there).  What the
// engine lost was host round trips: a pageable upload of the ids, a
// zero-fill launch, a synchronising download of the counts, a pageable
// upload of the whole size table, a second synchronising download.  The
// insert pass keeps the size table on the card (its host copy updated
// from the download) and the ids and output in persistent buffers, so a
// batch costs one upload from pinned memory, one launch and one
// synchronising download, and allocates nothing.
//
// slot_counts: the TPU kernel adds into one output block across its
// sequential grid steps.  Hopper blocks run in parallel and in no order,
// so every thread atomicAdds into global memory.  Integer atomics
// commute, so the histogram does not depend on the order.  The histogram
// is not privatised in shared memory: at ~2 us a launch there is nothing
// for it to win.
//
// bucket_core_stats: the TPU kernel copies all of `sizes` into VMEM for
// every block.  At the main path's state size that vector is hundreds of
// KB to MB, more than a block's 227 KB of shared memory, so here each
// thread owns one point, loops over its t slots and gathers the sizes
// (through the read-only cache where the sizes are an input; through L2
// in the insert pass, where the same launch wrote them).
//
// The insert pass's barrier: cooperative_groups' grid sync under
// cudaLaunchCooperativeKernel, which guarantees that the grid is
// co-resident.  The grid is sized from the occupancy calculator times the
// SM count and capped by the work; each phase is a grid-stride loop.
// Grid sync needs no relocatable device code (only multi-grid sync
// does), so the sources keep their one-step build.

#include <cooperative_groups.h>
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

// slots (n, t) i32; sizes (nb,) i32, updated in place.  kMasked = false:
// out (nb + n,) i32 = [sizes | support against sizes].  kMasked = true:
// core_sizes (nb,) i32 is updated in place too, from the rows whose mask
// byte is not 0, and out (2 nb + n,) i32 = [sizes | core sizes | support
// against core sizes] (the sampled-core engine: every row in the sizes,
// the sampled rows in the core sizes, every row's support on the latter).
template <bool kMasked>
__global__ void bucket_insert_pass_kernel(const int32_t* __restrict__ slots,
                                          const uint8_t* __restrict__ mask,
                                          int n, int t,
                                          int32_t* __restrict__ sizes,
                                          int32_t* __restrict__ core_sizes,
                                          int nb, int k,
                                          int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long m = static_cast<long long>(n) * t;
  for (long long i = tid; i < m; i += stride) {
    const int32_t s = slots[i];
    if (s >= 0 && s < nb) {
      atomicAdd(sizes + s, 1);
      if (kMasked && mask[i / t]) atomicAdd(core_sizes + s, 1);
    }
  }
  cooperative_groups::this_grid().sync();
  // the tables were written by this launch: read them through L2
  // (__ldcg), never through the non-coherent read-only path
  const int32_t* gate = kMasked ? core_sizes : sizes;
  int32_t* support = out + (kMasked ? 2LL * nb : static_cast<long long>(nb));
  for (long long s = tid; s < nb; s += stride) {
    out[s] = __ldcg(sizes + s);
    if (kMasked) out[nb + s] = __ldcg(core_sizes + s);
  }
  for (long long p = tid; p < n; p += stride) {
    const int32_t* row = slots + p * t;
    int32_t c = 0;
    for (int i = 0; i < t; ++i) {
      const int32_t s = row[i];
      if (s >= 0 && s < nb && __ldcg(gate + s) >= k) ++c;
    }
    support[p] = c;
  }
}

// One cooperative launch of bucket_insert_pass_kernel<kMasked>; returns its
// error code (or cudaGetLastError()).
template <bool kMasked>
int launch_insert_pass(const int32_t* slots, const uint8_t* mask, int n,
                       int t, int32_t* sizes, int32_t* core_sizes, int nb,
                       int k, int32_t* out, void* stream) {
  const int threads = 256;
  // co-resident blocks a device: occupancy x SMs, looked up once a device
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bucket_insert_pass_kernel<kMasked>, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms <= 0)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = per_sm * sms;
  }
  const long long work =
      static_cast<long long>(n) * t > nb ? static_cast<long long>(n) * t : nb;
  long long want = (work + threads - 1) / threads;
  if (want < 1) want = 1;
  const unsigned blocks = static_cast<unsigned>(
      want < resident[dev] ? want : resident[dev]);
  void* args[] = {&slots, &mask, &n, &t, &sizes, &core_sizes, &nb, &k, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bucket_insert_pass_kernel<kMasked>),
      dim3(blocks), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// slots (n, t) i32, sizes (nb,) i32 on the card -> sizes += the batch's
// histogram (in place), out (nb + n,) = [new sizes | support].  One
// cooperative launch; returns its error code (or cudaGetLastError()).
extern "C" int bucket_insert_pass_launch(const int32_t* slots, int n, int t,
                                         int32_t* sizes, int nb, int k,
                                         int32_t* out, void* stream) {
  return launch_insert_pass<false>(slots, nullptr, n, t, sizes, nullptr, nb,
                                   k, out, stream);
}

// The sampled-core route: slots (n, t) i32, mask (n,) u8, sizes and
// core_sizes (nb,) i32 on the card -> sizes += the histogram of every
// row, core_sizes += that of the rows whose mask byte is not 0 (both in
// place), out (2 nb + n,) = [new sizes | new core sizes | support against
// the new core sizes, every row].  One cooperative launch; returns its
// error code (or cudaGetLastError()).
extern "C" int bucket_insert_pass_masked_launch(
    const int32_t* slots, const uint8_t* mask, int n, int t, int32_t* sizes,
    int32_t* core_sizes, int nb, int k, int32_t* out, void* stream) {
  return launch_insert_pass<true>(slots, mask, n, t, sizes, core_sizes, nb,
                                  k, out, stream);
}
