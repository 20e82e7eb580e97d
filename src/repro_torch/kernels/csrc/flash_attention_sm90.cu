// bf16 GQA flash attention for Hopper tensor cores (sm_90a): wgmma for
// both products, TMA loads into a two-stage ring, one producer and two
// consumer warpgroups.  It serves every bf16 ops.attention call on the
// card; f32 goes to flash_attention.cu.  Under autograd the forward's
// second instantiation also stores each row's log-sum-exp, and the
// backward (attention_bwd_sm90_*, below the forward) recomputes P from
// it; the inference forward stores none.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (:129, body _kernel at :34).  For query row i of head
// h (q_pos = i + q_offset) and key j of kv head h / (hq / hkv):
//   s_ij = (q_i . k_j) * scale: bf16 x bf16 products, f32 sums
//   mask = j < skv, and q_pos >= j when causal, and q_pos - j < window
//          when a window is set
//   running (m, l, acc) per row in f32; p is rounded to bf16 for the
//   P V product, as the plain version's p.to(v.dtype) does; out_i =
//   acc / l (l == 0 gives 0, as the TPU kernel), written in bf16.
// The TPU kernel scores a masked pair -1e30 and sets its p back to 0;
// here a masked score is -inf and m starts at -1e30, which gives the
// same m, the same p = 0 and the same l.  The plain version is
// repro_torch/kernels/ref.py::attention.
//
// Bound: operations.  Per unmasked (query, key) pair and head the two
// products need 4 dh flops, against one read of q, k, v and one write
// of the output; at gemma3-27b's prefill (4,096 tokens, dh 128) that is
// ~300 flops a byte, at or above the H100's bf16 ridge, so the bound is
// the tensor cores' 989 TFLOP/s (dense bf16).
//
// Design:
//   * one block of 384 threads per (b * hq, 128-row query tile):
//     warpgroups 0 and 1 consume (64 query rows each: one wgmma M),
//     warpgroup 2 produces; setmaxnreg gives the consumers 240
//     registers and the producer 24.  Query tiles run longest first
//     (the causal tail is short), the heads of a tile side by side so
//     the query heads of one kv head share its tiles in L2;
//   * one producer thread issues TMA loads: the Q tile once, then the K
//     and V tiles of each key tile into a ring of two stages, each load
//     completing on its own mbarrier; the consumers release a stage on a
//     third (one arrival per consumer warp);
//   * tensor maps are 3-d (dh, rows, heads), so a box never crosses a
//     head and the hardware zero-fills rows past sq / skv and columns
//     past dh; rows are split into 64-column (128-byte) boxes stored
//     with the 128-byte swizzle that the wgmma descriptors name;
//   * S = Q K^T: m64nBKk16 with both operands in shared memory (K-major),
//     f32 accumulator in registers.  The online softmax runs on the
//     accumulator: a row lives on one quad, so its max is two shuffles,
//     and the row sum is reduced once at the end;
//   * O += P V: P converted to bf16 in registers is the A operand (the
//     accumulator's layout is the A fragment's), V is the B operand in
//     its (BK, dh) row-major layout read with the transpose bit
//     (MN-major); O (64 x dh f32) is rescaled by alpha before;
//   * a key tile that every row of the query tile masks is skipped (a
//     window of 1,024 at 4,096 tokens reads <= 9 of 32 tiles); the mask
//     arithmetic runs only on tiles that straddle the diagonal, the
//     window's edge or skv;
//   * the PV product of one tile runs while the consumer waits for the
//     next K tile and issues its S product;
//   * epilogue: O / l in bf16 through the consumer's own rows of the Q
//     tile in shared memory (same swizzle), then 16-byte stores of the
//     rows < sq;
//   * dh buckets: 64 and 128 with BK = 128 (shared memory at dh 128:
//     Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB), 256 with BK = 64, so
//     that S (64 x BK) and O (64 x dh) stay in the consumers' registers.
//     The wrapper pads dh to a multiple of 8 (TMA needs 16-byte row
//     strides); columns up to the bucket are zero-filled by TMA.
//   * lse (the LSE instantiation, for the backward): m + log(l) per
//     row in f32, +inf past sq and where no key is seen, so that the
//     backward's exp(s - lse) is 0 there without a row mask.
// Not done yet: persistent blocks, ping-pong between the two consumers
// (one's softmax under the other's wgmma), a third stage.

#include <cuda.h>  // CUtensorMap and its enums only; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 128;        // query rows of a block
constexpr int STAGES = 2;      // K / V ring
constexpr int THREADS = 384;   // two consumer warpgroups + one producer
constexpr float M_INIT = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct Tile {
  static constexpr int BK = DH <= 128 ? 128 : 64;  // keys of a tile
  static constexpr int BOXES = DH / 64;            // 64-column boxes
  static constexpr int Q_BOX = BQ * 128;           // bytes of one box
  static constexpr int KV_BOX = BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // one of K or V
  // Q, then per stage K and V; barriers after; 1 KB of slack to align
  // the tiles to the swizzle's 1,024-byte atom
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading byte offset (MN-major: the stride between 64-column
// boxes; unused K-major), stride byte offset 1,024 (eight 128-byte rows)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64) (+)= A (64 x 16) * B (64 x 16)^T, both K-major in shared
// memory; accumulate 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) (+)= A (64 x 16) * B (128 x 16)^T, both K-major in shared
// memory; accumulate 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) * B (16 x 64,
// MN-major in shared memory: the transpose bit set)
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 pairs in registers) * B (16 x 128,
// MN-major in shared memory: the transpose bit set)
__device__ __forceinline__ void mma_rs(float (&d)[64], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 256) += A (64 x 16, bf16 pairs in registers) * B (16 x 256,
// MN-major in shared memory: the transpose bit set)
__device__ __forceinline__ void mma_rs(float (&d)[128], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// LSE: also store each query row's log-sum-exp, for the backward
template <int DH, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int hq, int hkv,
                            int sq, int skv, int dh, int causal,
                            int has_window, int window, int q_offset,
                            float scale) {
  using T = Tile<DH>;
  constexpr int BK = T::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the Q tile's boxes
  unsigned char* const base_ptr = smem_raw + (base - raw);
  // stage s holds K at kv(s) and V at kv(s) + KV_BYTES
  const uint32_t kv0 = base + T::Q_BYTES;
  // barriers: Q full; K full, V full and empty of each stage
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // keys any row of this tile may see; tiles outside are wholly masked
  const long long q_lo = static_cast<long long>(q0) + q_offset;
  const long long q_hi =
      static_cast<long long>(min(q0 + BQ, sq)) - 1 + q_offset;
  long long k_lo = 0;
  long long k_hi = skv;
  if (has_window && q_lo - window + 1 > 0) k_lo = q_lo - window + 1;
  if (causal && q_hi + 1 < k_hi) k_hi = q_hi + 1;
  const int t_lo = static_cast<int>(k_lo / BK);
  const int n_tiles =
      k_hi > k_lo ? static_cast<int>((k_hi + BK - 1) / BK) - t_lo : 0;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x)
        tma_load(base + x * T::Q_BOX, &tm_q, q_full, 64 * x, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)  // both consumers are done with its last tile
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + it) * BK;
        const uint32_t ks = kv0 + 2 * s * T::KV_BYTES;
        const uint32_t vs = ks + T::KV_BYTES;
        mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(ks + x * T::KV_BOX, &tm_k, k_full + 8 * s, 64 * x, k0,
                   kvh);
        mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(vs + x * T::KV_BOX, &tm_v, v_full + 8 * s, 64 * x, k0,
                   kvh);
      }
    }
  } else {
    // consumer wg: query rows [64 wg, 64 wg + 64) of the tile; this
    // thread holds rows r0 and r0 + 8, keys / dims 8 j + 2 (lane % 4) + c
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid % 32;
    const int r0 = 64 * wg + 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const long long qw_lo = q_lo + 64 * wg;  // this warpgroup's rows
    const long long qw_hi = qw_lo + 63;
    const float sl2 = scale * LOG2E;  // scores in log2 units
    const float neg_inf = -__int_as_float(0x7f800000);
    const uint32_t q_wg = base + 64 * wg * 128;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m[2] = {M_INIT, M_INIT};
    float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int k0 = (t_lo + it) * BK;
      const uint32_t ks = kv0 + 2 * s * T::KV_BYTES;
      const uint32_t vs = ks + T::KV_BYTES;

      // S = Q K^T over dh in steps of 16 (32 bytes inside a box)
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_ss(sc,
               desc_sw128(q_wg + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16),
               desc_sw128(ks + (kk / 4) * T::KV_BOX + (kk % 4) * 32, 16),
               kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // this S and the previous tile's P V
      fence_regs(sc);
      fence_regs(o);
      if (it > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // scale; mask only where the tile straddles skv, the diagonal or
      // the window's edge for some row of this warpgroup
      const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > qw_lo) ||
                        (has_window && qw_hi - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * j + c0 + c;
              const long long qp = q_lo + r0 + 8 * i;
              const bool ok = kp < skv && (!causal || qp >= kp) &&
                              (!has_window || qp - kp < window);
              float& x = sc[4 * j + 2 * i + c];
              x = ok ? x * sl2 : neg_inf;
            }
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= sl2;
      }

      // online softmax: a row lives on the four lanes of a quad
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = ex2(m[i] - mx);
        m[i] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * i + c];
            x = ex2(x - mx);
            sum += x;
          }
        l[i] = l[i] * alpha[i] + sum;
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }

      // P in bf16: the accumulator's layout is the A fragment's
      uint32_t pa[BK / 4];
#pragma unroll
      for (int e = 0; e < BK / 4; ++e)
        pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);

      // O += P V over the tile's keys in steps of 16 (2 KB of V rows)
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc_sw128(vs + kk * 16 * 128, T::KV_BOX));
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(o);

    // epilogue: O / l in bf16 into this warpgroup's rows of the Q tile
    // (same swizzle), then 16-byte stores of rows < sq, columns < dh
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[i] = li == 0.0f ? 0.0f : 1.0f / li;
      if constexpr (LSE) {
        // natural log; +inf where no key is seen or past sq, so that the
        // backward's exp(s - lse) is 0 there.  Rows to gridDim.y * BQ.
        const int row = q0 + r0 + 8 * i;
        if (c0 == 0)
          lse[static_cast<long long>(bh) * gridDim.y * BQ + row] =
              row < sq && li > 0.0f ? (m[i] + log2f(li)) * LN2
                                    : __int_as_float(0x7f800000);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int off = (j / 8) * T::Q_BOX + r * 128 +
                        (((j % 8) ^ (r % 8)) * 16) + 2 * c0;
        *reinterpret_cast<uint32_t*>(base_ptr + off) =
            pack_bf16(o[4 * j + 2 * i] * inv[i],
                      o[4 * j + 2 * i + 1] * inv[i]);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int CH = DH / 8;  // 16-byte chunks of a row
    const int dh_ch = dh / 8;
    for (int e = tid; e < 64 * CH; e += 128) {
      const int r = 64 * wg + e / CH;
      const int ch = e % CH;
      const int row = q0 + r;
      if (row < sq && ch < dh_ch) {
        const int off = (ch / 8) * T::Q_BOX + r * 128 +
                        (((ch % 8) ^ (r % 8)) * 16);
        *reinterpret_cast<uint4*>(
            out + (static_cast<long long>(bh) * sq + row) * dh + 8 * ch) =
            *reinterpret_cast<const uint4*>(base_ptr + off);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a contiguous (heads, rows, dh) bf16 tensor, read in boxes of
// 64 columns x box_rows rows of one head, 128-byte swizzled
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows,
              int dh, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int hq, int hkv, int sq, int skv, int dh,
           int causal, int has_window, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b * hq, sq, dh, BQ) ||
      !make_map(&mk, k, b * hkv, skv, dh, T::BK) ||
      !make_map(&mv, v, b * hkv, skv, dh, T::BK))
    return static_cast<int>(cudaErrorUnknown);
  auto kernel = flash_attention_sm90_kernel<DH, false>;
  if constexpr (DH <= 128) {  // no backward kernel takes the 256 bucket
    if (lse != nullptr) kernel = flash_attention_sm90_kernel<DH, true>;
  } else if (lse != nullptr) {
    return 1;
  }
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM));
  if (err) return err;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, hq, hkv, sq, skv,
      dh, causal, has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Backward: attention_bwd_sm90_launch runs three kernels in turn.
//   delta: D_i = sum_d dO_id O_id in f32 (0 past sq), rows padded to
//          128 * ceil(sq / 128) as the forward's lse;
//   dkdv:  one block per (batch row, kv head, slice of its query heads,
//          128-key tile); each consumer warpgroup holds 64 keys and walks
//          the slice's heads and the 64-query steps that see its tile:
//            S^T  = K Q^T            (both in shared memory, f32 sums)
//            P^T  = exp(S^T scale - lse), masked as the forward masks
//            dP^T = V dO^T           (f32)
//            dS^T = P^T o (dP^T - D)
//            dV  += P^T dO           (P in bf16 registers)
//            dK  += dS^T Q           (dS in bf16 registers)
//          then writes dK * scale and dV as f32 partials of its slice,
//          which the wrapper sums in a fixed order (no atomics);
//   dq:    one block per (b * hq, 128-query tile) as the forward, each
//          consumer warpgroup 64 queries over the 64-key steps they see:
//            S = Q K^T, P = exp(S scale - lse), dP = dO V^T,
//            dS = P o (dP - D), dQ += dS K (dS in bf16 registers),
//          then dQ * scale in bf16.
// A row whose keys are all masked has output 0 and lse +inf from the
// forward, so P is 0 there: its gradient is that of 0.  No atomics: the
// slices' partials and dq's second pass keep every sum in a fixed order.
// Replaces no TPU kernel (the reference differentiates its plain
// chunked_attention through XLA); on the card it replaces the plain f32
// attention_vjp.  Bound: operations, five products of 2 dh flops per
// unmasked pair and query head (this design runs seven: dq recomputes S
// and dP) against reading q, k, v, out, dO, lse once and writing dq, dk,
// dv once: ~2,500 flops a byte at (2, 48 on 1, 4,096, 128), far above
// the bf16 ridge of ~295.
// Keys are the M side of the dkdv products and queries of the dq ones,
// so every accumulator is already the A fragment of the product that
// follows it, and every tile is read as the forward reads its tiles:
// K-major for S and dP, MN-major (the transpose bit) for the rest.
// ---------------------------------------------------------------------

constexpr int BWD_BK = 128;  // keys of a dkdv block: two wgs x 64
constexpr int BWD_BQ = 64;   // queries of a dkdv step
constexpr int DQ_BK = 64;    // keys of a dq step

template <int DH>
struct BwdTile {
  static constexpr int BOXES = DH / 64;
  static constexpr int K_BOX = BWD_BK * 128;
  static constexpr int Q_BOX = BWD_BQ * 128;
  static constexpr int K_BYTES = BOXES * K_BOX;  // one of K or V
  static constexpr int Q_BYTES = BOXES * Q_BOX;  // one of Q or dO
  static constexpr int ROW_BYTES = BWD_BQ * 4;   // lse or D of a step
  // K, V; per stage Q and dO; per stage lse and D; barriers
  static constexpr int ROW_OFF = 2 * K_BYTES + 2 * STAGES * Q_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + 2 * STAGES * ROW_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

template <int DH>
struct DqTile {
  static constexpr int BOXES = DH / 64;
  static constexpr int Q_BOX = BQ * 128;
  static constexpr int K_BOX = DQ_BK * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;  // one of Q or dO
  static constexpr int K_BYTES = BOXES * K_BOX;  // one of K or V
  // Q, dO; per stage K and V; barriers
  static constexpr int BAR_OFF = 2 * Q_BYTES + 2 * STAGES * K_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

// a contiguous run of global memory into shared memory, completing on bar
// (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one warp a row: D = rowsum(dO o O) over the true dh; rows past sq get 0
__global__ void __launch_bounds__(256)
attention_bwd_sm90_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                const __nv_bfloat16* __restrict__ dout,
                                float* __restrict__ delta, long long rows,
                                int sq, int sq_pad, int dh, int dh_pad) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / sq_pad;
  const int i = static_cast<int>(row % sq_pad);
  float acc = 0.0f;
  if (i < sq) {
    const __nv_bfloat16* o = out + (bh * sq + i) * dh;
    const __nv_bfloat16* g = dout + (bh * sq + i) * dh_pad;
    for (int d = lane; d < dh; d += 32)
      acc += __bfloat162float(o[d]) * __bfloat162float(g[d]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int hq, int hkv, int sq, int skv, int dh,
                               int causal, int has_window, int window,
                               int q_offset, float scale, int n_split) {
  using T = BwdTile<DH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the K tile's boxes
  const float* const rows_ptr =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + T::ROW_OFF);
  const uint32_t ks = base;
  const uint32_t vs = base + T::K_BYTES;
  // stage s: Q at qo(s), dO at qo(s) + Q_BYTES; lse at rows(s), D after
  const uint32_t qo0 = base + 2 * T::K_BYTES;
  const uint32_t rows0 = base + T::ROW_OFF;
  // barriers: K and V full; Q full, dO full and empty of each stage
  const uint32_t kv_full = base + T::BAR_OFF;
  const uint32_t q_full = kv_full + 8;
  const uint32_t o_full = q_full + 8 * STAGES;
  const uint32_t empty = o_full + 8 * STAGES;

  const int bkv = blockIdx.x / n_split;  // b * hkv + kv head
  const int split = blockIdx.x % n_split;
  const int k0 = blockIdx.y * BWD_BK;  // causal: most queries first
  const int group = hq / hkv;
  const int per = (group + n_split - 1) / n_split;
  const int h_lo = split * per;
  const int n_heads = max(0, min(group, h_lo + per) - h_lo);
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group + h_lo;
  const int sq_pad = (sq + BQ - 1) / BQ * BQ;

  // queries that see some key of this tile; steps outside see none
  const long long k_last =
      static_cast<long long>(min(k0 + BWD_BK, skv)) - 1;
  long long i_lo = 0;
  long long i_hi = sq;
  if (causal && k0 - static_cast<long long>(q_offset) > 0)
    i_lo = k0 - static_cast<long long>(q_offset);
  if (has_window && k_last + window - q_offset < i_hi)
    i_hi = k_last + window - q_offset;
  const int t_lo = i_hi > i_lo ? static_cast<int>(i_lo / BWD_BQ) : 0;
  const int nq =
      i_hi > i_lo
          ? static_cast<int>((i_hi + BWD_BQ - 1) / BWD_BQ) - t_lo
          : 0;
  const int n_iters = n_heads * nq;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(o_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_iters > 0) {
      mbar_expect_tx(kv_full, 2 * T::K_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x) {
        tma_load(ks + x * T::K_BOX, &tm_k, kv_full, 64 * x, k0, bkv);
        tma_load(vs + x * T::K_BOX, &tm_v, kv_full, 64 * x, k0, bkv);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)  // both consumers are done with its last step
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int bh = bh0 + it / nq;
        const int qt = (t_lo + it % nq) * BWD_BQ;
        const uint32_t qs = qo0 + 2 * s * T::Q_BYTES;
        const uint32_t os = qs + T::Q_BYTES;
        const uint32_t ls = rows0 + 2 * s * T::ROW_BYTES;
        const long long r = static_cast<long long>(bh) * sq_pad + qt;
        mbar_expect_tx(q_full + 8 * s, T::Q_BYTES + T::ROW_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(qs + x * T::Q_BOX, &tm_q, q_full + 8 * s, 64 * x, qt, bh);
        bulk_load(ls, lse + r, T::ROW_BYTES, q_full + 8 * s);
        mbar_expect_tx(o_full + 8 * s, T::Q_BYTES + T::ROW_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(os + x * T::Q_BOX, &tm_do, o_full + 8 * s, 64 * x, qt,
                   bh);
        bulk_load(ls + T::ROW_BYTES, delta + r, T::ROW_BYTES,
                  o_full + 8 * s);
      }
    }
  } else {
    // consumer wg: keys [64 wg, 64 wg + 64) of the tile; this thread
    // holds keys r0 and r0 + 8, queries 8 j + c0 + c of each step
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int kw = k0 + 64 * wg;  // this warpgroup's first key
    const float sl2 = scale * LOG2E;
    const uint32_t k_wg = ks + 64 * wg * 128;
    const uint32_t v_wg = vs + 64 * wg * 128;

    float dka[DH / 2], dva[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dka[i] = 0.0f;
      dva[i] = 0.0f;
    }

    if (n_iters > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int qt = (t_lo + it % nq) * BWD_BQ;
      const uint32_t qs = qo0 + 2 * s * T::Q_BYTES;
      const uint32_t os = qs + T::Q_BYTES;
      const float* const ls = rows_ptr + 2 * s * BWD_BQ;
      const float* const ds = ls + BWD_BQ;

      // S^T = K Q^T and dP^T = V dO^T over dh in steps of 16
      float st[BWD_BQ / 2], dpt[BWD_BQ / 2];
      mbar_wait(q_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_ss(st,
               desc_sw128(k_wg + (kk / 4) * T::K_BOX + (kk % 4) * 32, 16),
               desc_sw128(qs + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16),
               kk > 0);
      mbar_wait(o_full + 8 * s, parity);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_ss(dpt,
               desc_sw128(v_wg + (kk / 4) * T::K_BOX + (kk % 4) * 32, 16),
               desc_sw128(os + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16),
               kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // these two and the last step's dV and dK
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dka);
      fence_regs(dva);
      if (it > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // P^T and dS^T; the mask only where the step straddles skv, the
      // diagonal or the window's edge for some key of this warpgroup
      const long long qa = static_cast<long long>(qt) + q_offset;
      const bool edge = kw + 63 >= skv || (causal && qa < kw + 63) ||
                        (has_window && qa + BWD_BQ - 1 - kw >= window);
#pragma unroll
      for (int j = 0; j < BWD_BQ / 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + c0);
        const float2 dj = *reinterpret_cast<const float2*>(ds + 8 * j + c0);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            float p = ex2(fmaf(st[e], sl2, -(c ? lj.y : lj.x) * LOG2E));
            if (edge) {
              const long long kp = kw + r0 + 8 * i;
              const long long qp = qa + 8 * j + c0 + c;
              const bool ok = kp < skv && (!causal || qp >= kp) &&
                              (!has_window || qp - kp < window);
              p = ok ? p : 0.0f;
            }
            st[e] = p;
            dpt[e] = p * (dpt[e] - (c ? dj.y : dj.x));
          }
      }
      uint32_t pa[BWD_BQ / 4], sa[BWD_BQ / 4];
#pragma unroll
      for (int e = 0; e < BWD_BQ / 4; ++e) {
        pa[e] = pack_bf16(st[2 * e], st[2 * e + 1]);
        sa[e] = pack_bf16(dpt[2 * e], dpt[2 * e + 1]);
      }

      // dV += P^T dO, dK += dS^T Q over the step's queries in steps of 16
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BWD_BQ / 16; ++kk)
        mma_rs(dva, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
               pa[4 * kk + 3], desc_sw128(os + kk * 16 * 128, T::Q_BOX));
#pragma unroll
      for (int kk = 0; kk < BWD_BQ / 16; ++kk)
        mma_rs(dka, sa[4 * kk], sa[4 * kk + 1], sa[4 * kk + 2],
               sa[4 * kk + 3], desc_sw128(qs + kk * 16 * 128, T::Q_BOX));
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(dka);
    fence_regs(dva);

    // this slice's partials, f32 (n_split, b * hkv, skv, dh): keys < skv
    // (zeros where the slice saw no query)
    const long long slab =
        (static_cast<long long>(split) * (gridDim.x / n_split) + bkv) * skv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kw + r0 + 8 * i;
      if (key >= skv) continue;
      float* const dkr = dk + (slab + key) * dh;
      float* const dvr = dv + (slab + key) * dh;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int col = 8 * j + c0;
        if (col < dh) {
          *reinterpret_cast<float2*>(dkr + col) = make_float2(
              dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
          *reinterpret_cast<float2*>(dvr + col) =
              make_float2(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int hq, int hkv,
                             int sq, int skv, int dh, int causal,
                             int has_window, int window, int q_offset,
                             float scale) {
  using T = DqTile<DH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the Q tile's boxes
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t os = base + T::Q_BYTES;  // the dO tile
  // stage s holds K at kv(s) and V at kv(s) + K_BYTES
  const uint32_t kv0 = base + 2 * T::Q_BYTES;
  // barriers: Q and dO full; K full, V full and empty of each stage
  const uint32_t qo_full = base + T::BAR_OFF;
  const uint32_t k_full = qo_full + 8;
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);

  // keys any row of this tile may see, as in the forward
  const long long q_lo = static_cast<long long>(q0) + q_offset;
  const long long q_hi =
      static_cast<long long>(min(q0 + BQ, sq)) - 1 + q_offset;
  long long k_lo = 0;
  long long k_hi = skv;
  if (has_window && q_lo - window + 1 > 0) k_lo = q_lo - window + 1;
  if (causal && q_hi + 1 < k_hi) k_hi = q_hi + 1;
  const int t_lo = static_cast<int>(k_lo / DQ_BK);
  const int n_tiles =
      k_hi > k_lo ? static_cast<int>((k_hi + DQ_BK - 1) / DQ_BK) - t_lo : 0;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(qo_full, 2 * T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x) {
        tma_load(base + x * T::Q_BOX, &tm_q, qo_full, 64 * x, q0, bh);
        tma_load(os + x * T::Q_BOX, &tm_do, qo_full, 64 * x, q0, bh);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + it) * DQ_BK;
        const uint32_t ks = kv0 + 2 * s * T::K_BYTES;
        const uint32_t vs = ks + T::K_BYTES;
        mbar_expect_tx(k_full + 8 * s, T::K_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(ks + x * T::K_BOX, &tm_k, k_full + 8 * s, 64 * x, k0,
                   kvh);
        mbar_expect_tx(v_full + 8 * s, T::K_BYTES);
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x)
          tma_load(vs + x * T::K_BOX, &tm_v, v_full + 8 * s, 64 * x, k0,
                   kvh);
      }
    }
  } else {
    // consumer wg: query rows [64 wg, 64 wg + 64) of the tile; this
    // thread holds rows r0 and r0 + 8, keys / dims 8 j + c0 + c
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid % 32;
    const int r0 = 64 * wg + 16 * (tid / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const long long qw_lo = q_lo + 64 * wg;
    const long long qw_hi = qw_lo + 63;
    const float sl2 = scale * LOG2E;
    const uint32_t q_wg = base + 64 * wg * 128;
    const uint32_t o_wg = os + 64 * wg * 128;
    const long long row0 =
        static_cast<long long>(bh) * gridDim.y * BQ + q0 + r0;
    float l2[2], dd[2];  // lse in log2 units and D of this thread's rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l2[i] = lse[row0 + 8 * i] * LOG2E;
      dd[i] = delta[row0 + 8 * i];
    }

    float dqa[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dqa[i] = 0.0f;

    if (n_tiles > 0) mbar_wait(qo_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int k0 = (t_lo + it) * DQ_BK;
      const uint32_t ks = kv0 + 2 * s * T::K_BYTES;
      const uint32_t vs = ks + T::K_BYTES;

      // S = Q K^T and dP = dO V^T over dh in steps of 16
      float sc[DQ_BK / 2], dp[DQ_BK / 2];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_ss(sc,
               desc_sw128(q_wg + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16),
               desc_sw128(ks + (kk / 4) * T::K_BOX + (kk % 4) * 32, 16),
               kk > 0);
      mbar_wait(v_full + 8 * s, parity);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_ss(dp,
               desc_sw128(o_wg + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16),
               desc_sw128(vs + (kk / 4) * T::K_BOX + (kk % 4) * 32, 16),
               kk > 0);
      wgmma_commit();
      wgmma_wait_all();  // these two and the last step's dQ
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dqa);
      if (it > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      const bool edge = k0 + DQ_BK > skv ||
                        (causal && k0 + DQ_BK - 1 > qw_lo) ||
                        (has_window && qw_hi - k0 >= window);
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            float p = ex2(fmaf(sc[e], sl2, -l2[i]));
            if (edge) {
              const int kp = k0 + 8 * j + c0 + c;
              const long long qp = q_lo + r0 + 8 * i;
              const bool ok = kp < skv && (!causal || qp >= kp) &&
                              (!has_window || qp - kp < window);
              p = ok ? p : 0.0f;
            }
            dp[e] = p * (dp[e] - dd[i]);
          }
      uint32_t sa[DQ_BK / 4];
#pragma unroll
      for (int e = 0; e < DQ_BK / 4; ++e)
        sa[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);

      // dQ += dS K over the step's keys in steps of 16 (K read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        mma_rs(dqa, sa[4 * kk], sa[4 * kk + 1], sa[4 * kk + 2],
               sa[4 * kk + 3], desc_sw128(ks + kk * 16 * 128, T::K_BOX));
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(dqa);

    // epilogue as the forward's: dQ * scale in bf16 through this
    // warpgroup's rows of the Q tile, then 16-byte stores of rows < sq
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const int off = (j / 8) * T::Q_BOX + r * 128 +
                        (((j % 8) ^ (r % 8)) * 16) + 2 * c0;
        *reinterpret_cast<uint32_t*>(base_ptr + off) = pack_bf16(
            dqa[4 * j + 2 * i] * scale, dqa[4 * j + 2 * i + 1] * scale);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int CH = DH / 8;
    const int dh_ch = dh / 8;
    for (int e = tid; e < 64 * CH; e += 128) {
      const int r = 64 * wg + e / CH;
      const int ch = e % CH;
      const int row = q0 + r;
      if (row < sq && ch < dh_ch) {
        const int off = (ch / 8) * T::Q_BOX + r * 128 +
                        (((ch % 8) ^ (r % 8)) * 16);
        *reinterpret_cast<uint4*>(
            dq + (static_cast<long long>(bh) * sq + row) * dh + 8 * ch) =
            *reinterpret_cast<const uint4*>(base_ptr + off);
      }
    }
  }
}

template <int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               float* dk, float* dv, int b, int hq, int hkv, int sq, int skv,
               int dh, int dh_pad, int causal, int has_window, int window,
               int q_offset, float scale, int n_split, cudaStream_t stream) {
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!make_map(&q64, q, b * hq, sq, dh_pad, BWD_BQ) ||
      !make_map(&do64, dout, b * hq, sq, dh_pad, BWD_BQ) ||
      !make_map(&k128, k, b * hkv, skv, dh_pad, BWD_BK) ||
      !make_map(&v128, v, b * hkv, skv, dh_pad, BWD_BK) ||
      !make_map(&q128, q, b * hq, sq, dh_pad, BQ) ||
      !make_map(&do128, dout, b * hq, sq, dh_pad, BQ) ||
      !make_map(&k64, k, b * hkv, skv, dh_pad, DQ_BK) ||
      !make_map(&v64, v, b * hkv, skv, dh_pad, DQ_BK))
    return static_cast<int>(cudaErrorUnknown);
  const int sq_pad = (sq + BQ - 1) / BQ * BQ;
  const long long rows = static_cast<long long>(b) * hq * sq_pad;
  attention_bwd_sm90_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8),
                                    256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, sq, sq_pad, dh,
      dh_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dkdv = attention_bwd_sm90_dkdv_kernel<DH>;
  err = static_cast<int>(cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdTile<DH>::SMEM));
  if (err) return err;
  dkdv<<<dim3(b * hkv * n_split, (skv + BWD_BK - 1) / BWD_BK), THREADS,
         BwdTile<DH>::SMEM, stream>>>(q64, k128, v128, do64, lse, delta, dk,
                                      dv, hq, hkv, sq, skv, dh_pad, causal,
                                      has_window, window, q_offset, scale,
                                      n_split);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  auto dqk = attention_bwd_sm90_dq_kernel<DH>;
  err = static_cast<int>(cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DqTile<DH>::SMEM));
  if (err) return err;
  dqk<<<dim3(b * hq, (sq + BQ - 1) / BQ), THREADS, DqTile<DH>::SMEM,
        stream>>>(q128, k64, v64, do128, lse, delta,
                  static_cast<__nv_bfloat16*>(dq), hq, hkv, sq, skv, dh_pad,
                  causal, has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, hq, sq, dh), k and v (b, hkv, skv, dh), out (b, hq, sq, dh), all
// bf16, contiguous and 16-byte aligned on the current device; hq % hkv
// == 0, dh a multiple of 8 in [8, 256], sq >= 1, skv >= 1,
// (sq + 127) / 128 <= 65535.  lse: null (inference), or f32 (b * hq,
// 128 * ceil(sq / 128)) that receives every row's log-sum-exp (+inf past
// sq and where every key is masked) for the backward.  Returns a
// cudaError_t: 0 on success, 1 for a dh it does not take, 999 when a
// tensor map cannot be encoded.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int b, int hq,
                                           int hkv, int sq, int skv, int dh,
                                           int causal, int has_window,
                                           int window, int q_offset,
                                           float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dh < 8 || dh > 256 || dh % 8) return 1;
  if (dh <= 64)
    return launch<64>(q, k, v, out, l, b, hq, hkv, sq, skv, dh, causal,
                      has_window, window, q_offset, scale, s);
  if (dh <= 128)
    return launch<128>(q, k, v, out, l, b, hq, hkv, sq, skv, dh, causal,
                       has_window, window, q_offset, scale, s);
  return launch<256>(q, k, v, out, l, b, hq, hkv, sq, skv, dh, causal,
                     has_window, window, q_offset, scale, s);
}

// The backward of the LSE forward above.  q, k, v, dout padded to dh_pad
// (a multiple of 8 in [8, 128]) and out at the true dh, all bf16,
// contiguous and 16-byte aligned; lse as the forward wrote it and delta
// (scratch) f32 (b * hq, 128 * ceil(sq / 128)); dq bf16 (b, hq, sq,
// dh_pad); dk and dv f32 (n_split, b, hkv, skv, dh_pad), each slice the
// sum over its share of every kv head's query heads.  Returns a
// cudaError_t: 0 on success, 1 for a dh_pad it does not take, 999 when a
// tensor map cannot be encoded.
extern "C" int attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int hq, int hkv, int sq, int skv, int dh, int dh_pad,
    int causal, int has_window, int window, int q_offset, float scale,
    int n_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  if (dh_pad < 8 || dh_pad > 128 || dh_pad % 8 || n_split < 1) return 1;
  if (dh_pad <= 64)
    return launch_bwd<64>(q, k, v, out, dout, l, d, dq, gk, gv, b, hq, hkv,
                          sq, skv, dh, dh_pad, causal, has_window, window,
                          q_offset, scale, n_split, s);
  return launch_bwd<128>(q, k, v, out, dout, l, d, dq, gk, gv, b, hq, hkv,
                         sq, skv, dh, dh_pad, causal, has_window, window,
                         q_offset, scale, n_split, s);
}
