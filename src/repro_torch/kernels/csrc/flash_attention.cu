// GQA flash attention for Hopper (sm_90a), the f32 route: online softmax
// over key tiles with causal and sliding-window masks, f32 scores and
// accumulators on the CUDA cores.  It serves every f32 ops.attention call
// on the card; bf16 goes to the tensor-core kernel in
// flash_attention_sm90.cu.  A bf16 or TF32 tensor-core product cannot
// hold the f32 function's 2e-5 tolerance, so this route keeps f32 FMAs.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel).  For query row i of head h (q_pos =
// i + q_offset) and key j of kv head h / (hq / hkv):
//   s_ij = (q_i . k_j) * scale                     (f32)
//   mask = j < skv, and q_pos >= j when causal, and q_pos - j < window
//          when a window is set; a masked score is -1e30 (not -inf)
//   running (m, l, acc) per row in f32, p re-masked to 0, and
//   out_i = acc / l (l == 0 gives 0).
// The plain version is repro_torch/kernels/ref.py::attention; the two sum
// in different f32 orders, so they agree to the reference tests'
// tolerances, not bit for bit.
//
// Bound: operations.  Per unmasked (query, key) pair and head the kernel
// needs 2 dh multiply-adds (q.k and p.v), 4 dh flops, against one read
// of q, k, v and one write of the output, here on the CUDA cores in f32
// (67 TFLOP/s on an H100 SXM).
//
// Design (simple and right first):
//   * one block of 256 threads per (b*hq, 64-row query tile); the query
//     tile is staged once into shared memory and stays there;
//   * the block walks 64-key tiles of its kv head; tiles that are wholly
//     masked (above the causal diagonal, or before the window of every
//     row of the tile) are skipped, which changes no output: with a
//     window of 1024 at 4,096 tokens a local layer reads ~17 tiles a
//     query tile instead of up to 64;
//   * K and then V of a tile go through one shared-memory buffer, rows
//     padded to a multiple of 4 floats + 4 so that float4 reads of 16
//     consecutive rows hit distinct banks;
//   * thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16a (a < 4):
//     for S = Q K^T it owns keys tx + 16b (b < 4), 16 scores in
//     registers; the 16 threads of a row are one half-warp, so the row
//     max and row sum of the online softmax are shuffles, and m, l and
//     the rescale alpha stay in registers; p goes through shared memory
//     to the P V product, where the thread owns head dims
//     4 (tx + 16 j) .. +3 of its 4 rows, the accumulator in registers;
//   * head_dim is a template bucket DHP in {64, 128, 192, 256} with the
//     real dh <= DHP padded with zeros, so any dh <= 256 runs; ragged
//     query and key lengths are masked (zero rows in shared memory,
//     mask on the key position, rows >= sq never written).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // keys of a tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PLD = BK + 1;   // row stride of the p tile
constexpr float NEG_INF = -1e30f;

// rows [r0, r0 + 64) of a (n_rows, dh) matrix -> dst[64][DHP + 4], zero
// beyond n_rows and dh
template <int DHP>
__device__ __forceinline__ void stage(const float* __restrict__ src, int r0,
                                      int n_rows, int dh,
                                      float* __restrict__ dst) {
  constexpr int LD = DHP + 4;
  for (int e = threadIdx.x; e < 64 * DHP; e += THREADS) {
    const int r = e / DHP;
    const int c = e % DHP;
    const int gr = r0 + r;
    float x = 0.0f;
    if (gr < n_rows && c < dh)
      x = src[static_cast<long long>(gr) * dh + c];
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DHP>
__global__ void __launch_bounds__(THREADS, DHP <= 128 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int hq,
                       int hkv, int sq, int skv, int dh, int causal,
                       int has_window, int window, int q_offset,
                       float scale) {
  constexpr int LD = DHP + 4;
  constexpr int NJ = DHP / 64;  // float4 column groups of the P V product
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* kv = qs + BQ * LD;                     // [BK][LD], K then V
  float* ps = kv + BK * LD;                     // [BQ][PLD]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + static_cast<long long>(bh) * sq * dh;
  const float* kb = k + static_cast<long long>(kvh) * skv * dh;
  const float* vb = v + static_cast<long long>(kvh) * skv * dh;

  stage<DHP>(qb, q0, sq, dh, qs);

  // keys any row of this tile may see; tiles outside are wholly masked
  const long long q_lo = static_cast<long long>(q0) + q_offset;
  const long long q_hi = static_cast<long long>(min(q0 + BQ, sq)) - 1 +
                         q_offset;
  long long k_lo = 0;
  long long k_hi = skv;
  if (has_window && q_lo - window + 1 > 0) k_lo = q_lo - window + 1;
  if (causal && q_hi + 1 < k_hi) k_hi = q_hi + 1;

  long long q_pos[4];
  float m[4], l[4];
  float acc[4][NJ][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    q_pos[a] = q_lo + ty + 16 * a;
    m[a] = NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][j][c] = 0.0f;
  }

  for (long long k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's P V reads are done
    stage<DHP>(kb, static_cast<int>(k0), skv, dh, kv);
    __syncthreads();

    // S = Q K^T for rows ty + 16a, keys tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
    for (int d = 0; d < dh; d += 4) {
      float4 qv[4], kx[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * LD + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kx[b] = *reinterpret_cast<const float4*>(kv + (tx + 16 * b) * LD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qv[a].x, kx[b].x, s[a][b]);
          s[a][b] = fmaf(qv[a].y, kx[b].y, s[a][b]);
          s[a][b] = fmaf(qv[a].z, kx[b].z, s[a][b]);
          s[a][b] = fmaf(qv[a].w, kx[b].w, s[a][b]);
        }
    }

    // mask, then the online-softmax update of each row (a half-warp)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long kp = k0 + tx + 16 * b;
        ok[b] = kp < skv && (!causal || q_pos[a] >= kp) &&
                (!has_window || q_pos[a] - kp < window);
        s[a][b] = ok[b] ? s[a][b] * scale : NEG_INF;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_cur = fmaxf(m[a], half_warp_max(mx));
      const float alpha = expf(m[a] - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = ok[b] ? expf(s[a][b] - m_cur) : 0.0f;
        ps[(ty + 16 * a) * PLD + tx + 16 * b] = p;
        sum += p;
      }
      l[a] = l[a] * alpha + half_warp_sum(sum);
      m[a] = m_cur;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][j][c] *= alpha;
    }
    __syncthreads();  // every read of K is done and p is written
    stage<DHP>(vb, static_cast<int>(k0), skv, dh, kv);
    __syncthreads();

    // acc += P V for rows ty + 16a, dims 4 (tx + 16 j) .. + 3
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = ps[(ty + 16 * a) * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vx =
            *reinterpret_cast<const float4*>(kv + c * LD + 4 * (tx + 16 * j));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][j][0] = fmaf(p[a], vx.x, acc[a][j][0]);
          acc[a][j][1] = fmaf(p[a], vx.y, acc[a][j][1]);
          acc[a][j][2] = fmaf(p[a], vx.z, acc[a][j][2]);
          acc[a][j][3] = fmaf(p[a], vx.w, acc[a][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= sq) continue;
    const float safe = l[a] == 0.0f ? 1.0f : l[a];
    float* o = out + (static_cast<long long>(bh) * sq + r) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (tx + 16 * j) + c;
        if (d < dh) o[d] = acc[a][j][c] / safe;
      }
  }
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int dh, int causal,
           int has_window, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int LD = DHP + 4;
  constexpr size_t SMEM = sizeof(float) * (BQ * LD + BK * LD + BQ * PLD);
  auto kernel = flash_attention_kernel<DHP>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM)));
  if (err) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, sq,
      skv, dh, causal, has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, hq, sq, dh), k and v (b, hkv, skv, dh), out (b, hq, sq, dh), all
// f32 and contiguous on the current device; hq % hkv == 0,
// 1 <= dh <= 256, sq >= 1, skv >= 1, b * hq <= 65535.  Returns a
// cudaError_t (0 on success; 1 for a dh it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b,
                                      int hq, int hkv, int sq, int skv,
                                      int dh, int causal, int has_window,
                                      int window, int q_offset, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh < 1 || dh > 256) return 1;
  if (dh <= 64)
    return launch<64>(q, k, v, out, b, hq, hkv, sq, skv, dh, causal,
                      has_window, window, q_offset, scale, s);
  if (dh <= 128)
    return launch<128>(q, k, v, out, b, hq, hkv, sq, skv, dh, causal,
                       has_window, window, q_offset, scale, s);
  if (dh <= 192)
    return launch<192>(q, k, v, out, b, hq, hkv, sq, skv, dh, causal,
                       has_window, window, q_offset, scale, s);
  return launch<256>(q, k, v, out, b, hq, hkv, sq, skv, dh, causal,
                     has_window, window, q_offset, scale, s);
}
