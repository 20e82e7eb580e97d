// Exact eps-neighbour counts for Hopper (sm_90a): the O(n^2 d) step of
// exact DBSCAN.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_dist.py::
// eps_neighbor_counts (body _kernel).  out[i] = #{j < n : d2(i, j) <= thr}
// with d2 = (s_i + s_j) - 2 * dot_ij, s_i = sum_k x_ik * x_ik and
// dot_ij = sum_k x_ik * x_jk, each sum taken for k = 0..d-1, every product
// and sum rounded to f32 on its own; thr = float32(eps*eps + 1e-6) comes
// from the wrapper.  This is the order of the plain version
// repro_torch/kernels/ref.py::eps_neighbor_counts, bit for bit.  Two
// rewrites keep it: each sum starts from its first product (0 + p is p
// but for the sign of a zero, which no later add, the subtraction or the
// compare can see), and the count matrix is symmetric bit for bit
// (dot_ij and dot_ji round the same products in the same k order, and
// s_i + s_j rounds as s_j + s_i), so each unordered pair is evaluated
// once and credited to both of its points.
//
// Bound: operations.  Per unordered pair d multiplies and d - 1 adds for
// the dot, then an add, a multiply, a subtract, a compare and a count:
// n(n+1)/2 (2d + 5) scalar operations against 4 n (d + 1) bytes moved.
// The products may not become FMAs (the counts at the eps boundary depend
// on every rounding: __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from
// contracting them), and the tensor cores would round through TF32, so
// the ceiling is the card's non-FMA scalar rate, one f32 operation a lane
// and clock.  The design spends the issue slots on that arithmetic:
//
//   * pre-pass: one thread a point writes a transposed, padded copy xT
//     (d, n_pad) and the norms s_i (+inf past n), n_pad = 128 * T;  each
//     k row of a 128-point tile is then one contiguous 512-byte segment.
//     An infinite norm makes every padded pair's d2 inf (or NaN), which
//     fails the compare, so no pair needs a bounds check;
//   * symmetric schedule: the T(T+1)/2 tile pairs I <= J of 128 x 128
//     are numbered row-major in 64 bits; a persistent grid of about
//     2 blocks an SM takes equal contiguous ranges (plan() in
//     pairwise_dist.py), so the load is even to one tile pair and a
//     block walks consecutive J of one row tile I;
//   * register blocking: 256 threads as 16 x 16, each owning 8 x 8 pairs
//     (rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, columns likewise with
//     tx); a k step reads 4 float4 from shared memory for 64 multiplies
//     and 64 adds; the sums stay in 64 registers;
//   * staging: d <= 64 stays whole in shared memory.  The row tile and
//     its norms are loaded when I changes; the next column tile and its
//     norms are copied by cp.async (16 bytes a copy) into a two-stage
//     ring while the current one is computed, one __syncthreads a tile
//     pair.  d > 64 goes through the same ring in chunks of 32 k rows of
//     both tiles, ascending, so the k order holds;
//   * counts: a diagonal tile credits rows only, an off-diagonal one rows
//     and columns.  Row hits are reduced over the 16 threads of a row by
//     shuffles into a shared per-row sum, flushed with one atomicAdd a
//     row when I changes; column hits are reduced over the two rows of
//     threads in a warp by shuffles, over the 8 warps through shared
//     memory, and flushed with one atomicAdd a column and tile pair by
//     the next step.  Integer atomics are exact in any order.
//
// Shared memory: 4 (3 d + 20) 128 bytes whole (108,544 at d = 64),
// 75,776 chunked; two blocks an SM fit the 228 KB either way.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;         // rows and columns of a tile pair
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 pairs each
constexpr int WARPS = THREADS / 32;
constexpr int SEGS = TILE / 4;    // 16-byte copies in a k row of a tile
constexpr int D_WHOLE = 64;       // d held whole in shared memory
constexpr int KC = 32;            // k rows a stage holds above D_WHOLE
constexpr unsigned FULL = 0xffffffffu;

// the plan's shared-memory bytes (pairwise_dist.py::smem_bytes)
constexpr long long smem_bytes(bool whole, int d) {
  return 4LL * TILE * ((whole ? 3LL * d : 4LL * KC) + 4 + 2 * WARPS);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// index of the pair (i, i) in the row-major triangle of T tiles
__device__ __forceinline__ long long row_start(int i, int T) {
  return static_cast<long long>(i) * T -
         static_cast<long long>(i) * (i - 1) / 2;
}

// the tile pair (I, J), I <= J, numbered p (pairwise_dist.py::pair_of)
__device__ __forceinline__ void pair_of(long long p, int T, int& I,
                                        int& J) {
  const double b = 2.0 * T + 1.0;
  int i = static_cast<int>(
      floor((b - sqrt(b * b - 8.0 * static_cast<double>(p))) * 0.5));
  i = max(0, min(i, T - 1));
  while (i > 0 && row_start(i, T) > p) --i;
  while (i + 1 < T && row_start(i + 1, T) <= p) ++i;
  I = i;
  J = i + static_cast<int>(p - row_start(i, T));
}

// kn k rows of tile `tile`, from k row k0 of xT, into dst[kn][TILE]
__device__ __forceinline__ void load_tile(float* dst, const float* xT,
                                          long long n_pad, int tile, int k0,
                                          int kn) {
  const float* src = xT + static_cast<long long>(k0) * n_pad +
                     static_cast<long long>(tile) * TILE;
  for (int e = threadIdx.x; e < kn * SEGS; e += THREADS) {
    const int k = e / SEGS;
    const int q = (e % SEGS) * 4;
    cp_async16(dst + k * TILE + q, src + k * n_pad + q);
  }
}

__device__ __forceinline__ void load_norms(float* dst, const float* norms,
                                           int tile) {
  if (threadIdx.x < SEGS)
    cp_async16(dst + threadIdx.x * 4,
               norms + static_cast<long long>(tile) * TILE + threadIdx.x * 4);
}

// the 8 values a thread owns at p: p[0..3] and p[64..67]
__device__ __forceinline__ void frag(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 64);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc[a][b] over kn k rows of a (rows) and b (columns), TILE apart;
// `first` starts each sum from its first product
__device__ __forceinline__ void mac(float (&acc)[8][8], const float* a,
                                   const float* b, int kn, bool first) {
  int k = 0;
  if (first) {
    float av[8], bv[8];
    frag(av, a);
    frag(bv, b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmul_rn(av[i], bv[j]);
    k = 1;
  }
#pragma unroll 2
  for (; k < kn; ++k) {
    float av[8], bv[8];
    frag(av, a + k * TILE);
    frag(bv, b + k * TILE);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
  }
}

// keep one half of v (the upper where `hi`) and add the partner lane's
__device__ __forceinline__ int halve(int lo_v, int hi_v, bool hi, int mask) {
  const int recv = __shfl_xor_sync(FULL, hi ? lo_v : hi_v, mask);
  return (hi ? hi_v : lo_v) + recv;
}

__global__ void eps_neighbor_counts_prepare_kernel(
    const float* __restrict__ x, int n, int d, long long n_pad,
    float* __restrict__ xT, float* __restrict__ norms) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  if (i < n) {
    const float* xi = x + i * d;
    float v = xi[0];
    float s = __fmul_rn(v, v);
    xT[i] = v;
    for (int k = 1; k < d; ++k) {
      v = xi[k];
      s = __fadd_rn(s, __fmul_rn(v, v));
      xT[k * n_pad + i] = v;
    }
    norms[i] = s;
  } else {
    for (int k = 0; k < d; ++k) xT[k * n_pad + i] = 0.0f;
    norms[i] = INFINITY;
  }
}

template <bool kWhole>
__global__ void __launch_bounds__(THREADS, 2)
eps_neighbor_counts_kernel(const float* __restrict__ xT,
                           const float* __restrict__ norms, int n, int d,
                           long long n_pad, int T, long long pairs,
                           float thr, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int CK = kWhole ? d : KC;  // k rows of a column stage
  float* rowN = smem;              // [TILE] norms of the row tile
  float* colN = rowN + TILE;       // [2][TILE] norms of the column stages
  int* rowAcc = reinterpret_cast<int*>(colN + 2 * TILE);  // [TILE]
  int* colPart = rowAcc + TILE;    // [2][WARPS][TILE] column hits a warp
  // whole: [d][TILE], kept for a run of J; chunked: [2][KC][TILE] ring
  float* rowT = reinterpret_cast<float*>(colPart + 2 * WARPS * TILE);
  float* colT = rowT + (kWhole ? d : 2 * KC) * TILE;  // [2][CK][TILE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nch = kWhole ? 1 : (d + KC - 1) / KC;

  const long long p0 = pairs * blockIdx.x / gridDim.x;
  const long long p1 = pairs * (blockIdx.x + 1) / gridDim.x;
  if (p0 >= p1) return;

  int I, J;
  pair_of(p0, T, I, J);
  int c = 0, stage = 0, rowI = -1, prevJ = 0;
  bool prevOff = false;
  long long p = p0;
  float acc[8][8];

  // step (I, J, chunk cc) into ring stage s; the whole row tile is loaded
  // apart, when I changes
  auto issue = [&](int s, int i, int j, int cc) {
    const int k0 = kWhole ? 0 : cc * KC;
    const int kn = kWhole ? d : min(KC, d - k0);
    if (!kWhole) load_tile(rowT + s * KC * TILE, xT, n_pad, i, k0, kn);
    load_tile(colT + s * CK * TILE, xT, n_pad, j, k0, kn);
    load_norms(colN + s * TILE, norms, j);
    cp_async_commit();
  };
  // column hits of the pair before this one (buffer `buf`) to out
  auto flush_cols = [&](int buf, int j) {
    if (tid < TILE) {
      const int* src = colPart + buf * WARPS * TILE + tid;
      int v = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += src[w * TILE];
      const long long col = static_cast<long long>(j) * TILE + tid;
      if (v && col < n) atomicAdd(out + col, v);
    }
  };

  issue(0, I, J, 0);
  while (p < p1) {
    cp_async_wait_all();
    __syncthreads();  // stage `stage` landed; the last step's reads done
    const long long pp = p - p0;
    if (c == 0) {
      if (prevOff) flush_cols(static_cast<int>((pp - 1) & 1), prevJ);
      if (I != rowI) {  // a new row tile: flush the old one's rows
        if (tid < TILE) {
          const long long row = static_cast<long long>(rowI) * TILE + tid;
          if (rowI >= 0 && rowAcc[tid] && row < n)
            atomicAdd(out + row, rowAcc[tid]);
          rowAcc[tid] = 0;
        }
        if (kWhole) load_tile(rowT, xT, n_pad, I, 0, d);
        load_norms(rowN, norms, I);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        rowI = I;
      }
    }
    // prefetch the next step into the other stage
    int cn = c + 1, In = I, Jn = J;
    long long pn = p;
    if (cn == nch) {
      cn = 0;
      ++pn;
      if (++Jn == T) Jn = ++In;
    }
    if (pn < p1) issue(stage ^ 1, In, Jn, cn);

    const int k0 = kWhole ? 0 : c * KC;
    const int kn = kWhole ? d : min(KC, d - k0);
    const float* a = (kWhole ? rowT : rowT + stage * KC * TILE) + ty * 4;
    const float* b = colT + stage * CK * TILE + tx * 4;
    mac(acc, a, b, kn, c == 0);

    if (c == nch - 1) {  // epilogue: compare and count
      float si[8], sj[8];
      frag(si, rowN + ty * 4);
      frag(sj, colN + stage * TILE + tx * 4);
      int rc[8], cc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rc[i] = cc[i] = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d2 = __fsub_rn(__fadd_rn(si[i], sj[j]),
                                     __fmul_rn(2.0f, acc[i][j]));
          if (d2 <= thr) {
            ++rc[i];
            ++cc[j];
          }
        }
      // rows: reduce-scatter over the 16 threads of a row (lane bits
      // 3..0); lane pair (2m, 2m+1) ends with the sum of row r
      {
        const bool h3 = tx & 8, h2 = tx & 4, h1 = tx & 2;
        int v4[4], v2[2];
#pragma unroll
        for (int j = 0; j < 4; ++j) v4[j] = halve(rc[j], rc[j + 4], h3, 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) v2[j] = halve(v4[j], v4[j + 2], h2, 4);
        int v1 = halve(v2[0], v2[1], h1, 2);
        v1 += __shfl_xor_sync(FULL, v1, 1);
        const int r = (h3 ? 4 : 0) + (h2 ? 2 : 0) + (h1 ? 1 : 0);
        if (!(tx & 1) && v1) rowAcc[(r & 4 ? 64 : 0) + ty * 4 + (r & 3)] += v1;
      }
      if (I != J) {  // columns: the two rows of threads in a warp (lane
                     // bit 4), then the warps through colPart
        const bool hi = lane >= 16;
        int keep[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) keep[j] = halve(cc[j], cc[j + 4], hi, 16);
        int* dst = colPart + (static_cast<int>(pp & 1) * WARPS + warp) * TILE +
                   (hi ? 64 : 0) + tx * 4;
        *reinterpret_cast<int4*>(dst) =
            make_int4(keep[0], keep[1], keep[2], keep[3]);
      }
      prevOff = I != J;
      prevJ = J;
    }
    p = pn;
    c = cn;
    I = In;
    J = Jn;
    stage ^= 1;
  }
  __syncthreads();
  if (prevOff) flush_cols(static_cast<int>((p1 - 1 - p0) & 1), prevJ);
  if (tid < TILE) {
    const long long row = static_cast<long long>(rowI) * TILE + tid;
    if (rowAcc[tid] && row < n) atomicAdd(out + row, rowAcc[tid]);
  }
}

}  // namespace

// x (n, d) f32 contiguous, scratch ((d + 1) * 128 * n_tiles,) f32, out
// (n,) i32 filled with zeros by the caller, all on the current device;
// the rest is pairwise_dist.plan(n, d), checked here against n and d.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan that does
// not fit n and d).
extern "C" int eps_neighbor_counts_launch(const float* x, int n, int d,
                                          float thr, float* scratch,
                                          int32_t* out, int whole, int kc,
                                          int n_tiles, long long pairs,
                                          int grid, int smem, void* stream) {
  const long long T = n_tiles;
  if (n < 1 || d < 1 || T != (n + TILE - 1LL) / TILE ||
      pairs != T * (T + 1) / 2 || grid < 1 || grid > pairs ||
      whole != (d <= D_WHOLE ? 1 : 0) || kc != (whole ? d : KC) ||
      smem != smem_bytes(whole, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pad = T * TILE;
  float* xT = scratch;
  float* norms = scratch + d * n_pad;
  eps_neighbor_counts_prepare_kernel<<<
      static_cast<unsigned>((n_pad + THREADS - 1) / THREADS), THREADS, 0,
      s>>>(x, n, d, n_pad, xT, norms);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const auto kernel = whole ? eps_neighbor_counts_kernel<true>
                            : eps_neighbor_counts_kernel<false>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  kernel<<<grid, THREADS, smem, s>>>(xT, norms, n, d, n_pad, n_tiles, pairs,
                                     thr, out);
  return static_cast<int>(cudaGetLastError());
}
