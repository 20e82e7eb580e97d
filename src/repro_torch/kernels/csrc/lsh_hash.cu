// Grid-LSH bucket keys for a batch of points, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lsh_hash.py::lsh_hash
// (body _kernel).  out[p, i, f] = avalanche(sum_j code[p, i, j] *
// mixers[f, i, j]) with code = floor((x[p, j] + eta[i]) * inv_cell) and
// every integer step wrapping mod 2^32.
//
// Two entry points.  lsh_hash_launch keeps the Pallas kernel's contract
// (ops.lsh_hash).  lsh_hash_resolve_launch is the engine's hash pass: the
// same keys, and for each (point, table) key the slot a device mirror of
// the engine's bucket directory holds for it (-1 for a miss), in one
// cooperative launch that first applies the directory's pending updates.
//
// Bound: bytes.  Per point it reads d floats and writes 2t ints (3t with
// the slots); the t*d multiply-adds are a few operations per byte, far
// below the card's ridge.  At the main path's batch (1000 x 10, t = 10)
// the whole call moves ~120 KB (the resolve pass ~178 KB with the ~1,000
// directory cells its probes read), so the launch itself is what the
// card waits on.  What the engine lost was host work around it: a
// pageable upload, an allocation, a synchronising download, then a sort
// and a Python dict lookup of every key on the host.  The resolve pass
// answers the lookups of keys the directory already holds on the card
// (about 98% of them after the first batches), so the host resolves only
// the misses, and a batch costs one upload (points and pending updates,
// from pinned memory), one launch and one download.
//
// Keys: one thread per (point, table), a loop over d.  Consecutive
// threads share a point, so the d floats of x come through L1 once per
// warp.  The add and the multiply are __fadd_rn / __fmul_rn so that nvcc
// can neither contract them into an FMA nor reorder them: the f32
// rounding of (x + eta) then (* inv_cell) is what the plain version and
// the TPU kernel compute.  The multiply-accumulate and the murmur3-style
// avalanche run in uint32_t, where wrap-around and the logical right
// shift are defined, and the result is reinterpreted as int32.
//
// The directory: an open-addressing table of cap cells (a power of two)
// in device memory, each cell four int32 [key a, key b, table, slot],
// slot -1 for an empty cell and -2 for a tombstone; one 16-byte load
// reads a cell.  A (table, key) probes linearly from the low bits of key
// a, which the avalanche has already mixed.  The host keeps the load
// (live cells and tombstones) at most one half, so every probe meets an
// empty cell; every loop is bounded by cap all the same.
//
// The updates: (u, 4) cells [key a, key b, table, slot], slot -1 for an
// erase; each (table, key) appears at most once (the host nets an erase
// and a reinsert of one key into one update).  They must be in place
// before any probe, and blocks run in no order, so the pass is one
// cooperative launch with grid-wide barriers (cooperative_groups' grid
// sync under cudaLaunchCooperativeKernel, no relocatable device code):
//   1a. each update searches its key among the live cells; found, it
//       overwrites the slot (a tombstone for an erase) and marks itself
//       applied in the update list.  No key word changes in this phase,
//       so a search never reads a cell that another thread is writing.
//   1b. each unapplied insert claims the first empty or tombstone cell
//       of its chain with atomicCAS on the slot word (to -3, busy), then
//       writes the cell.  Every key here is absent from the table (1a
//       searched its whole chain), and no thread compares keys in this
//       phase, so a half-written cell is never read as a match.
//   2.  keys and probes, reading the cells through L2 (__ldcg): the same
//       launch wrote them, so the non-coherent read-only path is out.
// With no update the two barriers are skipped.  One barrier would do if
// a search could tell a cell being claimed from a live one (acquire /
// release ordering on the slot word); the second keeps both phases free
// of that.  On an H100 the update phases and both barriers add ~2.8 us
// to the ~2.9 us a launch takes on the device at the main path's batch,
// against ~0.4 ms of host time a pass.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTombstone = -2;
constexpr int32_t kBusy = -3;

// The reference's finalizer constants, repro/kernels/ref.py MIX_A =
// -1975444243 and MIX_B = -1029739211, as uint32 (its comments name
// murmur3's 0x85EBCA6D / 0xC2B2AE35; the values below are what it uses).
__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= 0x8A411CEDu;
  h ^= h >> 13;
  h *= 0xC29F6D35u;
  h ^= h >> 16;
  return h;
}

// The two key words of point p in table i.
__device__ __forceinline__ void grid_key(const float* __restrict__ x,
                                         const float* __restrict__ eta,
                                         const int32_t* __restrict__ mixers,
                                         float inv_cell, int d, int t,
                                         long long p, int i, int32_t* a,
                                         int32_t* b) {
  const float e = eta[i];
  const float* xp = x + p * d;
  const int32_t* ma = mixers + static_cast<long long>(i) * d;
  const int32_t* mb = mixers + static_cast<long long>(t + i) * d;
  uint32_t acc_a = 0u, acc_b = 0u;
  for (int j = 0; j < d; ++j) {
    const float q = floorf(__fmul_rn(__fadd_rn(xp[j], e), inv_cell));
    const uint32_t c = static_cast<uint32_t>(static_cast<int32_t>(q));
    acc_a += c * static_cast<uint32_t>(ma[j]);
    acc_b += c * static_cast<uint32_t>(mb[j]);
  }
  *a = static_cast<int32_t>(avalanche(acc_a));
  *b = static_cast<int32_t>(avalanche(acc_b));
}

__global__ void lsh_hash_kernel(const float* __restrict__ x,
                                const float* __restrict__ eta,
                                const int32_t* __restrict__ mixers,
                                float inv_cell, int n, int d, int t,
                                int32_t* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(n) * t) return;
  const long long p = tid / t;
  const int i = static_cast<int>(tid - p * t);
  grid_key(x, eta, mixers, inv_cell, d, t, p, i, out + tid * 2,
           out + tid * 2 + 1);
}

// Position of the live cell holding (table, a, b), or -1, reading
// through L2; at most cap cells.  Its slot goes to *slot (-1 if none).
__device__ __forceinline__ long long find_live(const int4* dir,
                                               uint32_t mask, int32_t table,
                                               int32_t a, int32_t b,
                                               int32_t* slot) {
  uint32_t pos = static_cast<uint32_t>(a) & mask;
  *slot = -1;
  for (uint32_t step = 0; step <= mask; ++step) {
    const int4 c = __ldcg(dir + pos);
    if (c.w == kEmpty) return -1;
    if (c.w >= 0 && c.x == a && c.y == b && c.z == table) {
      *slot = c.w;
      return pos;
    }
    pos = (pos + 1) & mask;
  }
  return -1;
}

// x (n, d) f32, eta (t,) f32, mixers (2, t, d) i32; dir (cap, 4) i32
// updated in place; upd (u, 4) i32, consumed; out (3 n t,) i32 = [keys
// (n, t, 2) | slots (n, t)].
__global__ void lsh_hash_resolve_kernel(const float* __restrict__ x,
                                        const float* __restrict__ eta,
                                        const int32_t* __restrict__ mixers,
                                        float inv_cell, int n, int d, int t,
                                        int4* dir, int cap, int4* upd,
                                        int n_upd,
                                        int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  if (n_upd > 0) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    // 1a. updates of keys the table holds
    for (long long u = tid; u < n_upd; u += stride) {
      const int4 e = upd[u];
      int32_t held;
      const long long pos = find_live(dir, mask, e.z, e.x, e.y, &held);
      if (pos >= 0) {
        reinterpret_cast<int32_t*>(dir + pos)[3] = e.w >= 0 ? e.w : kTombstone;
        reinterpret_cast<int32_t*>(upd + u)[2] = -1;  // applied
      }
    }
    grid.sync();
    // 1b. inserts of keys it does not hold; this thread's own marks are
    //     visible to it
    for (long long u = tid; u < n_upd; u += stride) {
      const int4 e = upd[u];
      if (e.z < 0 || e.w < 0) continue;  // applied, or an erase of nothing
      uint32_t pos = static_cast<uint32_t>(e.x) & mask;
      for (uint32_t step = 0; step <= mask; ++step) {
        int32_t* cell = reinterpret_cast<int32_t*>(dir + pos);
        const int32_t s = __ldcg(cell + 3);
        if ((s == kEmpty || s == kTombstone) &&
            atomicCAS(cell + 3, s, kBusy) == s) {
          cell[0] = e.x;
          cell[1] = e.y;
          cell[2] = e.z;
          cell[3] = e.w;
          break;
        }
        pos = (pos + 1) & mask;
      }
    }
    grid.sync();
  }
  // 2. keys, then the probe
  const long long m = static_cast<long long>(n) * t;
  for (long long q = tid; q < m; q += stride) {
    const long long p = q / t;
    const int i = static_cast<int>(q - p * t);
    int32_t a, b;
    grid_key(x, eta, mixers, inv_cell, d, t, p, i, &a, &b);
    out[2 * q] = a;
    out[2 * q + 1] = b;
    int32_t slot;
    find_live(dir, mask, i, a, b, &slot);
    out[2 * m + q] = slot;
  }
}

}  // namespace

// x (n, d) f32, eta (t,) f32, mixers (2, t, d) i32 -> out (n, t, 2) i32,
// all contiguous on the current device.  Returns cudaGetLastError().
extern "C" int lsh_hash_launch(const float* x, const float* eta,
                               const int32_t* mixers, float inv_cell, int n,
                               int d, int t, int32_t* out, void* stream) {
  const int threads = 256;
  const long long work = static_cast<long long>(n) * t;
  const unsigned blocks = static_cast<unsigned>((work + threads - 1) / threads);
  lsh_hash_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, eta, mixers, inv_cell, n, d, t, out);
  return static_cast<int>(cudaGetLastError());
}

// x (n, d) f32, eta (t,) f32, mixers (2, t, d) i32; dir (cap, 4) i32 with
// cap a power of two, 16-byte aligned, updated in place; upd (n_upd, 4)
// i32, 16-byte aligned, consumed; out (3 n t,) i32 = [keys | slots].
// One cooperative launch; returns its error code (or cudaGetLastError()).
extern "C" int lsh_hash_resolve_launch(const float* x, const float* eta,
                                       const int32_t* mixers, float inv_cell,
                                       int n, int d, int t, int32_t* dir,
                                       int cap, int32_t* upd, int n_upd,
                                       int32_t* out, void* stream) {
  const int threads = 256;
  if (cap <= 0 || (cap & (cap - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // co-resident blocks a device: occupancy x SMs, looked up once a device.
  // Host threads may make their first call at once (a sharded index fans
  // out to its shards on a pool): each that finds 0 computes the same value
  // and stores it, so an atomic cell is all the cache needs.
  static std::atomic<int> resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int co_resident = resident[dev].load(std::memory_order_acquire);
  if (co_resident == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lsh_hash_resolve_kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms <= 0)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    co_resident = per_sm * sms;
    resident[dev].store(co_resident, std::memory_order_release);
  }
  const long long m = static_cast<long long>(n) * t;
  const long long work = m > n_upd ? m : n_upd;
  long long want = (work + threads - 1) / threads;
  if (want < 1) want = 1;
  const unsigned blocks = static_cast<unsigned>(
      want < co_resident ? want : co_resident);
  int4* dir4 = reinterpret_cast<int4*>(dir);
  int4* upd4 = reinterpret_cast<int4*>(upd);
  void* args[] = {&x, &eta, &mixers, &inv_cell, &n, &d, &t,
                  &dir4, &cap, &upd4, &n_upd, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lsh_hash_resolve_kernel), dim3(blocks),
      dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
