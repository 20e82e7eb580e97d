// Exact eps-neighbour counts for Hopper (sm_90a): the O(n^2 d) step of
// exact DBSCAN.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_dist.py::
// eps_neighbor_counts (body _kernel).  out[i] = #{j < n : d2(i, j) <= thr}
// with d2 = (s_i + s_j) - 2 * dot_ij, s_i = sum_k x_ik * x_ik and
// dot_ij = sum_k x_ik * x_jk, each sum taken for k = 0..d-1, every product
// and sum rounded to f32 on its own; thr = float32(eps*eps + 1e-6) comes
// from the wrapper.  This is the order of the plain version
// repro_torch/kernels/ref.py::eps_neighbor_counts, bit for bit.
//
// Bound: operations.  Per pair the kernel does d multiplies and d adds for
// the dot, then an add, a multiply, a subtract, a compare and a count:
// n^2 (2d + 4) scalar f32/int operations against 4 n (d + 1) bytes moved.
// The products may not become FMAs (the counts at the eps boundary depend
// on every rounding), and the tensor cores would round through TF32, so
// the ceiling is the card's non-FMA scalar rate.
//
// Design (simple and right first; no symmetry, no wgmma/TMA):
//   * a pre-pass computes the n norms s_i into scratch;
//   * the main kernel gives each 256-thread block a 64-row tile and sweeps
//     a strided set of 64-column tiles; each thread owns 4 x 4 pairs
//     (rows ty + 16 a, columns tx + 16 b) and keeps their partial dots in
//     registers while d is staged through shared memory in chunks of
//     KC, so d is not limited by shared memory and the k order holds;
//   * __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting a
//     multiply and an add into an FMA;
//   * columns >= n are masked out, and rows >= n are never written, as the
//     TPU kernel masks its padding;
//   * each thread counts across its columns, the 16 threads of a row
//     reduce by warp shuffles, and one integer atomicAdd per row and block
//     lands in the zero-filled output, exact in any order.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;        // rows and columns of a block's tile
constexpr int KC = 16;          // dimensions staged per chunk
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 pairs each
constexpr int TARGET_BLOCKS = 2048;

__global__ void eps_neighbor_counts_norms_kernel(const float* __restrict__ x,
                                                 int n, int d,
                                                 float* __restrict__ norms) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xi = x + i * d;
  float s = 0.0f;
  for (int k = 0; k < d; ++k) s = __fadd_rn(s, __fmul_rn(xi[k], xi[k]));
  norms[i] = s;
}

__global__ void __launch_bounds__(THREADS)
eps_neighbor_counts_kernel(const float* __restrict__ x,
                           const float* __restrict__ norms, int n, int d,
                           float thr, int32_t* __restrict__ out) {
  // transposed tiles [k][row]; the +1 keeps the transposing stores free
  // of bank conflicts
  __shared__ float as[KC][TILE + 1];
  __shared__ float bs[KC][TILE + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_tiles = (n + TILE - 1) / TILE;

  for (int rt = blockIdx.y; rt < n_tiles; rt += gridDim.y) {
    const int r0 = rt * TILE;
    float si[4];
    int cnt[4] = {0, 0, 0, 0};
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + ty + 16 * a;
      si[a] = r < n ? norms[r] : 0.0f;
    }
    for (int ct = blockIdx.x; ct < n_tiles; ct += gridDim.x) {
      const int c0 = ct * TILE;
      float acc[4][4];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      for (int k0 = 0; k0 < d; k0 += KC) {
        const int kc = min(KC, d - k0);
        __syncthreads();  // the previous chunk's reads are done
        for (int e = tid; e < TILE * KC; e += THREADS) {
          const int r = e / KC;
          const int kk = e % KC;
          const bool kin = kk < kc;
          const int ra = r0 + r;
          const int rb = c0 + r;
          as[kk][r] = kin && ra < n
              ? x[static_cast<long long>(ra) * d + k0 + kk] : 0.0f;
          bs[kk][r] = kin && rb < n
              ? x[static_cast<long long>(rb) * d + k0 + kk] : 0.0f;
        }
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          float av[4], bv[4];
          for (int a = 0; a < 4; ++a) av[a] = as[kk][ty + 16 * a];
          for (int b = 0; b < 4; ++b) bv[b] = bs[kk][tx + 16 * b];
          for (int a = 0; a < 4; ++a)
            for (int b = 0; b < 4; ++b)
              acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(av[a], bv[b]));
        }
      }
      for (int b = 0; b < 4; ++b) {
        const int c = c0 + tx + 16 * b;
        if (c >= n) continue;
        const float sj = norms[c];
        for (int a = 0; a < 4; ++a) {
          const float d2 = __fsub_rn(__fadd_rn(si[a], sj),
                                     __fmul_rn(2.0f, acc[a][b]));
          cnt[a] += d2 <= thr;
        }
      }
    }
    // the 16 threads of a row group are one half of a warp
    for (int a = 0; a < 4; ++a) {
      int c = cnt[a];
      for (int off = 8; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      const int r = r0 + ty + 16 * a;
      if (tx == 0 && r < n && c) atomicAdd(out + r, c);
    }
  }
}

}  // namespace

// x (n, d) f32 contiguous, norms (n,) f32 scratch, out (n,) i32 filled
// with zeros by the caller, all on the current device; n >= 1, d >= 1.
// Returns cudaGetLastError().
extern "C" int eps_neighbor_counts_launch(const float* x, int n, int d,
                                          float thr, float* norms,
                                          int32_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  eps_neighbor_counts_norms_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                                     s>>>(x, n, d, norms);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int rows = std::min(n_tiles, 65535);
  // split the column sweep only as far as it takes to fill the card
  const int cols =
      std::max(1, std::min(n_tiles, (TARGET_BLOCKS + rows - 1) / rows));
  eps_neighbor_counts_kernel<<<dim3(cols, rows), THREADS, 0, s>>>(
      x, norms, n, d, thr, out);
  return static_cast<int>(cudaGetLastError());
}
