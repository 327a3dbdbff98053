// int8 x int8 matrix product with int32 accumulation and a fused dequant
// epilogue, for Hopper (sm_90a): TMA loads into a ring of shared-memory
// stages, wgmma on the int8 tensor cores, and, in its fused form, the
// activation encode in the prologue and bias and ReLU in the epilogue.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py _kernel
// (reached through quant_matmul); the fused form is what
// paddle_tpu/quant/int8.py int8_linear computes around it (the
// activation's absmax_encode, the product, the bias) plus the layer's
// ReLU.
//
// What it computes: out[m, n] = float(sum_k a[m, k] * b[n, k]) *
// (sa[0] * sb[n]), then, if given, + bias[n], then, if asked, ReLU, stored
// as float32 or as bfloat16 rounded once. b is the weight packed once
// as (N, K) int8 with K contiguous (the JAX layout (K, N) transposed):
// the operand layout wgmma requires for 8-bit types. a is (M, K) int8,
// or, in the fused form, (M, K) float32 that the prologue encodes at sa
// as quant/ops.py _encode_at does: rintf(__fdiv_rn(x, sa)) clamped to
// +-127 (round half to even, as torch.round and jnp.round). Integer sums
// are exact and the epilogue keeps the JAX order, the scales' product
// first: __fmul_rn(float(acc), __fmul_rn(sa, sb[n])), then
// __fadd_rn(.., bias[n]) — explicit _rn intrinsics, so nvcc cannot
// contract them into an FMA. The result equals the plain version and
// the JAX package bit for bit.
//
// What bounds it: bytes. At MNIST's shapes (M 8192, K <= 784, N <= 512)
// a call must read A once (M*K bytes, 4*M*K in the fused form), B, the
// scales and bias, and write 4*M*N bytes of float32 output — 16.8 MB of
// layer 1's 23.6 MB (int8 A) or 42.9 MB (fused): 7.0 and 12.8 us at
// 3.35 TB/s. The 2*M*N*K operations take 0.3 us at the 1979 TOP/s int8
// peak.
//
// Design:
// - Block tile BM x BN with BM = 64 * (consumer warpgroups, 1 or 2) and
//   BN in {16, 64, 128, 256} (the smallest that covers N, at most 256);
//   two warpgroups when that still gives ~a wave of tiles, one otherwise.
//   Output tiles on 132 SMs at MNIST batch 8192: layer 1 (N 512) 128x256
//   -> 64 x 2 = 128 tiles; layer 2 (N 256) 64x256 -> 128 tiles (128x256
//   would give 64); layer 3 (N 10) 64x16 -> 128 tiles (128x16: 64). The
//   grid walks N fastest, so the blocks sharing an A row tile run
//   together and A comes from device memory once.
// - A producer warp issues TMA (cp.async.bulk.tensor) loads of the A and
//   B tiles, 64 K-values deep, into a ring of 4 stages, each with a
//   "full" and an "empty" mbarrier; the consumers release a stage as soon
//   as their wgmma on it is done, so up to 4 tiles are in flight. TMA
//   zero-fills outside the tensor (the ragged K edge, MNIST's K = 784 =
//   12 * 64 + 16; rows past M; B rows past N). The tensor maps come from
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   the library links no -lcuda. int8 tiles land with the 64-byte swizzle
//   that the wgmma descriptors name; float32 A tiles land unswizzled.
// - Shapes TMA cannot describe (a global row stride that is not a
//   multiple of 16 bytes: int8 K % 16 != 0, float32 K % 4 != 0) are
//   padded with zero columns by the wrapper (ops/kernels/quant_matmul.py)
//   before the launch; zero columns add nothing to the sums.
// - Each consumer warpgroup runs wgmma.mma_async m64nBNk32 .s32.s8.s8
//   with A and B from shared memory, two per 64-deep tile, the int32
//   accumulators in registers (BN / 2 per thread).
// - Fused form: the consumer warpgroup reads its 64 float rows of the
//   stage with 16-byte shared loads, encodes them and writes the int8
//   tile in the swizzled layout wgmma reads (double-buffered, so one
//   named barrier per tile), then fences the async proxy.
// - Epilogue: scale (bias, ReLU) in registers, the tile staged through
//   shared memory (the drained ring), then written with coalesced 16-byte
//   stores where rows are a multiple of 16 bytes, element by element
//   otherwise (MNIST layer 3's (8192, 10) float32 output, 40-byte rows).
//   No TMA store: the 40-byte rows could not take one.
// What is still weak: one tile per block, so a block's epilogue does not
// overlap its next loads (no persistent schedule); the fused form encodes
// an A tile once per N tile (twice at layer 1); one block per SM at the
// largest tiles (about 209 KB of shared memory).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError()
// (or a negative code for an argument it refuses).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // K values per stage
constexpr int kStages = 4;
constexpr int kAlign = 1024;   // stage alignment (swizzle atoms)
constexpr int kPad = 8;        // staged output row padding, elements

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that lasts
// seconds means a broken pipeline: trap (a launch error) rather than hang
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// ----- TMA ----------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// ----- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major int8 tile with 64-byte
// rows in the 64-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_64B): start
// address, leading byte offset 1 (unused for swizzled K-major), stride
// byte offset 512 (8 rows x 64 bytes), layout type 2 (64B swizzle).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x N, s32) += A (64 x 32, s8, smem) * B (N x 32, s8, smem)^T. The
// accumulator layout: d[i] of thread t (warp w = t / 32 of the
// warpgroup, lane l) is row 16w + l/4 + 8*((i >> 1) & 1), column
// 8*(i >> 2) + 2*(l % 4) + (i & 1).
__device__ __forceinline__ void wgmma_n16(int (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 16) wgmma_n16(d, da, db);
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  if constexpr (BN == 256) wgmma_n256(d, da, db);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t encode4(float4 x, float s) {
  // _encode_at: clip(round(x / s), -127, 127) as int8. A zero (half of
  // a ReLU layer's input) skips the division, whose IEEE path takes a
  // slow branch for it; 0 / s is 0 exactly.
  const float v[4] = {x.x, x.y, x.z, x.w};
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float y = 0.f;
    if (v[e] != 0.f) y = rintf(__fdiv_rn(v[e], s));
    y = fminf(fmaxf(y, -127.f), 127.f);
    w |= (uint32_t)(uint8_t)(int8_t)(int)y << (8 * e);
  }
  return w;
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared-memory layout, in bytes from the aligned base: the ring (per
// stage an A tile of BM x 64 values, then a B tile of BN x 64 int8), the
// fused form's encoded A tiles (2 per consumer warpgroup, 64 x 64 int8),
// the barriers. The epilogue's staged tile aliases the ring.
template <typename TA, typename TO, int WG, int BN>
struct Layout {
  static constexpr int BM = 64 * WG;
  static constexpr int kAStage = BM * kBK * (int)sizeof(TA);
  static constexpr int kBStage = BN * kBK;
  static constexpr int kStage = kAStage + kBStage;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kStaged = WG * 64 * (BN + kPad) * (int)sizeof(TO);
  static constexpr int kMain = kRing > kStaged ? kRing : kStaged;
  static constexpr bool kFused = sizeof(TA) == 4;
  static constexpr int kEnc = kFused ? WG * 2 * 64 * kBK : 0;
  static constexpr int kBars = 2 * kStages * 8;
  static constexpr int kBytes = kMain + kEnc + kBars + kAlign;
};

template <typename TA, typename TO, int WG, int BN>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    quant_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const float* __restrict__ sa,
                        const float* __restrict__ sb,
                        const float* __restrict__ bias,
                        TO* __restrict__ out, int M, int N, int K,
                        int relu) {
  using L = Layout<TA, TO, WG, BN>;
  constexpr int BM = L::BM;
  constexpr int kConsumers = WG * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~(uintptr_t)(kAlign - 1));
  uint8_t* enc = smem + L::kMain;
  uint64_t* full = reinterpret_cast<uint64_t*>(enc + L::kEnc);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int kt_n = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * L::kStage;
        mbar_expect_tx(&full[s], L::kStage);
        tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
        tma_load_2d(st + L::kAStage, &map_b, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // consumers
  const int wg = tid / 128;
  const int t = tid % 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const float s_a = sa[0];

  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    uint8_t* st = smem + s * L::kStage;
    uint32_t a_addr;
    if constexpr (L::kFused) {
      // encode this warpgroup's 64 float rows into the int8 tile, in the
      // 64-byte swizzle: 16-byte chunk c of row r sits at c ^ ((r/2) % 4)
      const float* src = reinterpret_cast<const float*>(st) + wg * 64 * kBK;
      uint8_t* dst = enc + (wg * 2 + (kt & 1)) * 64 * kBK;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int idx = it * 128 + t;
        const int r = idx >> 4;
        const int c4 = idx & 15;
        const float4 x = *reinterpret_cast<const float4*>(src + r * kBK +
                                                          c4 * 4);
        const int off =
            r * kBK + ((((c4 >> 2) ^ (r >> 1)) & 3) << 4) + (c4 & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst + off) = encode4(x, s_a);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(2 + wg, 128);
      a_addr = smem_u32(dst);
    } else {
      a_addr = smem_u32(st + wg * 64 * kBK);
    }
    const uint32_t b_addr = smem_u32(st + L::kAStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32)
      wgmma_tile<BN>(acc, desc_sw64(a_addr + kk), desc_sw64(b_addr + kk));
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(&empty[s]);
  }

  // epilogue: every consumer is done with the ring before it is reused
  named_sync(1, kConsumers);
  constexpr int kLd = BN + kPad;
  TO* tile = reinterpret_cast<TO*>(smem) + wg * 64 * kLd;
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gc = n0 + c + e;
      float v = 0.f;
      if (gc < N) {
        v = __fmul_rn(__int2float_rn(acc[i + e]), __fmul_rn(s_a, sb[gc]));
        if (bias != nullptr) v = __fadd_rn(v, bias[gc]);
        if (relu && v < 0.f) v = 0.f;
      }
      put(&tile[r * kLd + c + e], v);
    }
  }
  named_sync(2 + wg, 128);

  const int row0 = m0 + wg * 64;
  const int rows = min(64, M - row0);
  if (rows <= 0) return;
  const int cols = min(BN, N - n0);
  constexpr int kVec = 16 / (int)sizeof(TO);
  if ((N * sizeof(TO)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    // 16-byte rows: each row's segment in 16-byte vectors
    const int vpr = cols / kVec;
    for (int i = t; i < rows * vpr; i += 128) {
      const int r = i / vpr, v = i - (i / vpr) * vpr;
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + n0 +
                                v * kVec) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + v * kVec);
    }
  } else {
    for (int i = t; i < rows * cols; i += 128) {
      const int r = i / cols, c = i - (i / cols) * cols;
      out[(size_t)(row0 + r) * N + n0 + c] = tile[r * kLd + c];
    }
  }
}

// ----- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major (rows, cols) tensor with rows ld elements apart, cut
// into (box_rows, 64) boxes; columns past cols read as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
              const void* ptr, int rows, int cols, int ld, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TA, typename TO, int WG, int BN>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           const void* bias, void* out, int M, int N, int K, int ldb,
           int relu, cudaStream_t stream) {
  using L = Layout<TA, TO, WG, BN>;
  CUtensorMap map_a, map_b;
  const bool fused = sizeof(TA) == 4;
  if (!make_map(&map_a,
                fused ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                (int)sizeof(TA), a, M, K, K, L::BM,
                fused ? CU_TENSOR_MAP_SWIZZLE_NONE
                      : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, N, K, ldb, BN,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return -3;
  auto kernel = quant_matmul_kernel<TA, TO, WG, BN>;
  static bool smem_set[64] = {};   // per device, set once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + L::BM - 1) / L::BM);
  if (grid.y > 65535) return -1;
  kernel<<<grid, WG * 128 + 32, L::kBytes, stream>>>(
      map_a, map_b, (const float*)sa, (const float*)sb, (const float*)bias,
      (TO*)out, M, N, K, relu);
  return (int)cudaGetLastError();
}

// BN: the smallest of 16/64/128/256 that covers N (256 above). Two
// consumer warpgroups (BM 128) when 128-row tiles still make ~a wave
// (>= 120 tiles on 132 SMs), else one (BM 64) for twice the tiles.
template <typename TA, typename TO>
int dispatch(const void* a, const void* b, const void* sa, const void* sb,
             const void* bias, void* out, int M, int N, int K, int ldb,
             int relu, cudaStream_t st) {
  const int bn = N <= 16 ? 16 : N <= 64 ? 64 : N <= 128 ? 128 : 256;
  const long tiles128 = (long)((M + 127) / 128) * ((N + bn - 1) / bn);
  const bool two = tiles128 >= 120;
#define QMM_CASE(BN_)                                                      \
  if (bn == BN_)                                                          \
    return two ? launch<TA, TO, 2, BN_>(a, b, sa, sb, bias, out, M, N, K, \
                                        ldb, relu, st)                    \
               : launch<TA, TO, 1, BN_>(a, b, sa, sb, bias, out, M, N, K, \
                                        ldb, relu, st);
  QMM_CASE(16)
  QMM_CASE(64)
  QMM_CASE(128)
  QMM_CASE(256)
#undef QMM_CASE
  return -1;
}

}  // namespace

extern "C" {

// a_kind: 0 = a is int8 (M, K); 1 = a is float32 (M, K), encoded at
// sa in the prologue (the fused form). out_dtype: 0 = float32, 1 =
// bfloat16. b: the packed weight, N rows of ldb >= K int8 (columns past
// K are not read); sa (1,), sb (N,) and bias (N,) or null, float32;
// relu: 0 or 1. All contiguous and 16-byte aligned, with rows of a
// multiple of 16 bytes (int8 K % 16 == 0, float32 K % 4 == 0, ldb %
// 16 == 0; the wrapper pads).
int pt_quant_matmul(int a_kind, int out_dtype, const void* a, const void* b,
                    const void* sa, const void* sb, const void* bias,
                    void* out, int M, int N, int K, int ldb, int relu,
                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldb < K) return -1;
  const int elem = a_kind == 1 ? 4 : 1;
  if ((K * elem) % 16 != 0 || ldb % 16 != 0) return -1;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (a_kind == 0 && out_dtype == 0)
    return dispatch<int8_t, float>(a, b, sa, sb, bias, out, M, N, K, ldb,
                                   relu, st);
  if (a_kind == 0 && out_dtype == 1)
    return dispatch<int8_t, __nv_bfloat16>(a, b, sa, sb, bias, out, M, N,
                                           K, ldb, relu, st);
  if (a_kind == 1 && out_dtype == 0)
    return dispatch<float, float>(a, b, sa, sb, bias, out, M, N, K, ldb,
                                  relu, st);
  if (a_kind == 1 && out_dtype == 1)
    return dispatch<float, __nv_bfloat16>(a, b, sa, sb, bias, out, M, N, K,
                                          ldb, relu, st);
  return -2;
}

}  // extern "C"
