// Grid-LSH bucket keys for a batch of points, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lsh_hash.py::lsh_hash
// (body _kernel).  out[p, i, f] = avalanche(sum_j code[p, i, j] *
// mixers[f, i, j]) with code = floor((x[p, j] + eta[i]) * inv_cell) and
// every integer step wrapping mod 2^32.
//
// Bound: bytes.  Per point it reads d floats and writes 2t ints; the t*d
// multiply-adds are a few operations per byte, far below the card's
// ridge.  At the main path's batch (1000 x 10, t = 10) the whole call
// moves ~120 KB, so the launch itself is what the card waits on.
//
// Design: one thread per (point, table), a loop over d.  Consecutive
// threads share a point, so the d floats of x come through L1 once per
// warp.  The add and the multiply are __fadd_rn / __fmul_rn so that nvcc
// can neither contract them into an FMA nor reorder them: the f32
// rounding of (x + eta) then (* inv_cell) is what the plain version and
// the TPU kernel compute.  The multiply-accumulate and the murmur3-style
// avalanche run in uint32_t, where wrap-around and the logical right
// shift are defined, and the result is reinterpreted as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
  int32_t* o = out + tid * 2;
  o[0] = static_cast<int32_t>(avalanche(acc_a));
  o[1] = static_cast<int32_t>(avalanche(acc_b));
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
