// int8 x int8 matrix product with int32 accumulation and a fused dequant
// epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py _kernel
// (reached through quant_matmul).
//
// What it computes: out[m, n] = float(sum_k a[m, k] * b[k, n]) *
// (sa[0] * sb[n]), stored as float32 or as bfloat16 rounded once. a is
// (M, K) int8 row-major, b is (K, N) int8 row-major (the JAX layout,
// weights (in, out)), sa (1,) and sb (N,) float32. Integer sums are
// exact, so the result equals the JAX kernel's bit for bit: the scales'
// product first, then one float32 multiply, as its epilogue does.
//
// What bounds it: at MNIST's shapes (M 8192, K <= 784, N <= 512) bytes —
// M*K + K*N read once and 4*M*N written, over 3.35 TB/s; the 2*M*N*K
// operations take a fraction of that at the 1979 TOP/s int8 peak.
//
// Design (simple first): int8 tensor cores through
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (not __dp4a). One
// 128-thread block per 64x64 output tile; each of its four warps owns a
// 32x32 quadrant (2 x 4 mma tiles, 32 int32 accumulators per thread).
// The block walks K in tiles of 64. A's tile sits in shared memory
// row-major (K contiguous); B's is stored transposed, (n, k), because the
// .col operand wants 4 consecutive k in one 32-bit register: each word is
// packed from 4 rows of B on its way in, so the weight has no second
// copy. Shared rows are padded by 16 bytes against bank conflicts on the
// fragment reads. Tiles past M, N or K load zeros (MNIST's K = 784 and
// N = 10 are not multiples of 64). The epilogue scales in registers and
// stores straight to global memory. Known weaknesses, left to a later
// change: loads are not double-buffered (no cp.async or TMA), B and, when
// K % 4 != 0, A are read byte by byte, the transposed B stores conflict
// 4-way, and wgmma would reach a higher rate.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;
constexpr int kLd = kBK + 16;  // shared row stride in bytes

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t byte_at(const int8_t* p, int e) {
  return (uint32_t)(uint8_t)p[0] << (8 * e);
}

// D = A * B + D for one m16n8k32 tile; fragment layouts as in the PTX
// ISA (groupID = lane / 4, thread-in-group = lane % 4).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const int8_t* __restrict__ a,
                        const int8_t* __restrict__ b,
                        const float* __restrict__ sa,
                        const float* __restrict__ sb, TO* __restrict__ out,
                        int M, int N, int K, bool a_words) {
  __shared__ __align__(16) int8_t As[kBM * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // groupID
  const int tg = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: 64 rows x 16 words, 8 words per thread
#pragma unroll
    for (int it = 0; it < (kBM * kBK / 4) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx >> 4;
      const int w = idx & 15;
      const int gm = m0 + r;
      const int gk = k0 + w * 4;
      uint32_t word = 0;
      if (gm < M && gk < K) {
        const int8_t* src = a + (size_t)gm * K + gk;
        if (a_words) {
          word = *reinterpret_cast<const uint32_t*>(src);
        } else {
          for (int e = 0; e < 4 && gk + e < K; ++e)
            word |= byte_at(src + e, e);
        }
      }
      *reinterpret_cast<uint32_t*>(As + r * kLd + w * 4) = word;
    }
    // B tile, transposed to (n, k): consecutive threads take consecutive
    // n, so each of the 4 row reads is coalesced
#pragma unroll
    for (int it = 0; it < (kBN * kBK / 4) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int n = idx & (kBN - 1);
      const int w = idx / kBN;
      const int gn = n0 + n;
      const int gk = k0 + w * 4;
      uint32_t word = 0;
      if (gn < N) {
        for (int e = 0; e < 4 && gk + e < K; ++e)
          word |= byte_at(b + (size_t)(gk + e) * N + gn, e);
      }
      *reinterpret_cast<uint32_t*>(Bs + n * kLd + w * 4) = word;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* r0 = As + (wm + i * 16 + g) * kLd + kk + tg * 4;
        const int8_t* r8 = r0 + 8 * kLd;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = Bs + (wn + j * 8 + g) * kLd + kk + tg * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2*tg, 2*tg + 1); c2, c3 at row g + 8
  const float s_a = sa[0];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + j * 8 + tg * 2 + (e & 1);
        if (row < M && col < N) {
          const float scale = s_a * sb[col];
          store(&out[(size_t)row * N + col],
                __int2float_rn(acc[i][j][e]) * scale);
        }
      }
    }
  }
}

template <typename TO>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  const bool a_words = K % 4 == 0 && ((uintptr_t)a & 3) == 0;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return -1;
  quant_matmul_kernel<TO><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const float*)sa,
      (const float*)sb, (TO*)out, M, N, K, a_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16. a (M, K) int8, b (K, N) int8,
// sa (1,) and sb (N,) float32, out (M, N); all contiguous.
int pt_quant_matmul(int out_dtype, const void* a, const void* b,
                    const void* sa, const void* sb, void* out, int M, int N,
                    int K, void* stream) {
  if (out_dtype == 0)
    return launch<float>(a, b, sa, sb, out, M, N, K, stream);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(a, b, sa, sb, out, M, N, K, stream);
  return -2;
}

}  // extern "C"
