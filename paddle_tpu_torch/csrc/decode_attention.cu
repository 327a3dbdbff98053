// Single-position decode attention for Hopper (sm_90a): the contiguous
// and the paged KV-cache forms, the paged one over float or int8 pools.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_decode.py
// _decode_kernel (reached through flash_decode), _paged_kernel (reached
// through flash_decode_paged) and _paged_kernel_quant (reached through
// flash_decode_paged(k_scale=, v_scale=)); all three share the
// online-softmax body _decode_core.
//
// What it computes: for each row b and query head h, attention of the
// one query q[b, h] over the live keys [lo, min(t[b], L-1)] of kv head
// h / G (GQA is kv-major), where lo = max(t[b] - window + 1, 0) with a
// window and 0 without, and L is the cache capacity (contiguous) or
// n_log * page_size (paged). The paged form reads logical position p
// from physical page table[b, p / page_size], clamped to [0, pages), at
// offset p % page_size — parked rows (t = capacity) and garbage table
// entries past a row's live range stay inside the pool. The int8 form
// reads each K/V vector as int8 values times its float32 scale
// ks/vs[page, offset, kv head], the scale from the same clamped page, and
// dequantizes every element before the dot products, as the TPU kernel
// does (q is float32 there; here q may also be bfloat16, and all
// arithmetic is float32).
//
// What bounds it: bytes. Every live K and V vector is read once, so the
// least time is sum_b (hi_b - lo_b + 1) * Hkv * 2 * (D * sizeof(T)) over
// the card's memory rate, with sizeof(T) = 1 plus a 4-byte scale per
// vector for int8 pools (~3.8x fewer bytes than float32 at D = 64); the
// arithmetic (4 * G flops per key element) is far below the compute roof.
//
// Design (simple first): one thread block per (b, kv head). The G query
// vectors of the group sit in shared memory; the block walks only the
// live range in tiles of 64 keys, loads each K/V tile into shared memory
// once for all G queries (the TPU kernel's "read each shared K/V block
// once" property), as float32 (int8 rows arrive as 16-byte vector loads,
// 4 per 64-element vector, and are dequantized on the way in), computes
// scores in float32, updates the running max and sum per query and
// accumulates p.V. Masking values follow the TPU kernel: -1e30 for dead
// keys, p = 0 where s <= -5e29, and l == 0 is read as 1. Known weakness,
// left to a later change: B * Hkv blocks can be fewer than the 132 SMs
// (a split over the cache length with a combine pass would fill them),
// and loads are not double-buffered.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Shared memory, in floats: q (G*D), K tile (kTile*(D+1), padded against
// bank conflicts), V tile (kTile*D), scores/probabilities (G*kTile),
// accumulator (G*D), and m, l, alpha (G each).
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return (size_t)G * D * 2 + (size_t)kTile * (2 * D + 1) +
         (size_t)G * kTile + 3 * (size_t)G;
}

// Row of the K/V planes that holds logical position pos of row b (the
// value plane's row times Hkv plus the kv head gives the vector).
template <bool kPaged>
__device__ __forceinline__ size_t cache_row(const int32_t* table, int b,
                                            int pos, int rows, int n_log,
                                            int pages) {
  if (!kPaged) return (size_t)b * rows + pos;
  int page = table[(size_t)b * n_log + pos / rows];
  page = min(max(page, 0), pages - 1);
  return (size_t)page * rows + (pos - (pos / rows) * rows);
}

// TQ: q and o; TKV: the K/V planes (int8 when kQuant, with the float32
// scale planes ks/vs, one scale per (row, kv head) vector).
template <typename TQ, typename TKV, bool kPaged, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ k,
                            const TKV* __restrict__ v,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ t,
                            TQ* __restrict__ o, int rows, int n_log,
                            int pages, int H, int Hkv, int D, int window,
                            float scale) {
  // rows: cache capacity (contiguous) or page size (paged)
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int G = H / Hkv;
  const int L = kPaged ? n_log * rows : rows;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * D;
  float* acc_s = p_s + G * kTile;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kWarps = kThreads / 32;

  // q and o are (B, H, D); the group's heads hk*G .. hk*G+G-1 are
  // contiguous
  const size_t qo_base = ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[qo_base + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int tb = t[b];
  const int lo = window > 0 ? max(tb - window + 1, 0) : 0;
  const int hi = min(tb, L - 1);
  __syncthreads();

  for (int start = lo; start <= hi; start += kTile) {
    const int n = min(kTile, hi - start + 1);
    if constexpr (kQuant) {
      // 16 int8 values per load; each dequantized by its vector's scale
      const int vecs = D / 16;
      for (int i = tid; i < n * vecs; i += kThreads) {
        const int j = i / vecs;
        const int c = (i - j * vecs) * 16;
        const size_t vec =
            cache_row<kPaged>(table, b, start + j, rows, n_log, pages) *
                Hkv + hk;
        const float sk = ks[vec];
        const float sv = vs[vec];
        const int4 kw = *reinterpret_cast<const int4*>(k + vec * D + c);
        const int4 vw = *reinterpret_cast<const int4*>(v + vec * D + c);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          k_s[j * (D + 1) + c + e] = (float)kb[e] * sk;
          v_s[j * D + c + e] = (float)vb[e] * sv;
        }
      }
    } else {
      // cooperative K/V tile load: each key row is D contiguous elements
      for (int i = tid; i < n * D; i += kThreads) {
        const int j = i / D;
        const int d = i - j * D;
        const size_t off =
            (cache_row<kPaged>(table, b, start + j, rows, n_log, pages) *
                 Hkv + hk) * D + d;
        k_s[j * (D + 1) + d] = to_f32(k[off]);
        v_s[j * D + d] = to_f32(v[off]);
      }
    }
    __syncthreads();
    // scores s[g][j] = (q_g . k_j) * scale; slots past the tile are dead
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int j = i - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online-softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = p_s[g * kTile + lane];
      const float s1 = p_s[g * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = s0 <= 0.5f * kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 <= 0.5f * kNegInf ? 0.f : expf(s1 - m_new);
      p_s[g * kTile + lane] = p0;
      p_s[g * kTile + lane + 32] = p1;
      float sum = p0 + p1;
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g][d] = alpha_g * acc[g][d] + sum_j p[g][j] * v[j][d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = p_s + g * kTile;
      float pv = 0.f;
      for (int j = 0; j < n; ++j) pv = fmaf(pr[j], v_s[j * D + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    float l = l_s[i / D];
    l = (l == 0.f) ? 1.f : l;  // an empty live range outputs zeros
    store(&o[qo_base + i], acc_s[i] / l);
  }
}

template <typename TQ, typename TKV, bool kPaged, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* t, void* o,
           int B, int rows, int n_log, int pages, int H, int Hkv, int D,
           int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0) return -1;
  if (kQuant && D % 16 != 0) return -1;
  const size_t smem = smem_floats(H / Hkv, D) * sizeof(float);
  auto kernel = decode_attention_kernel<TQ, TKV, kPaged, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, kThreads, smem, (cudaStream_t)stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
      (const float*)vs, (const int32_t*)table, (const int32_t*)t, (TQ*)o,
      rows, n_log, pages, H, Hkv, D, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for group size G and head dim D.
size_t pt_decode_attention_smem_bytes(int G, int D) {
  return smem_floats(G, D) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// q, o: (B, H, D); k, v: (B, cap, Hkv, D); t: (B,) int32.
int pt_decode_attention(int dtype, const void* q, const void* k,
                        const void* v, const void* t, void* o, int B,
                        int cap, int H, int Hkv, int D, int window,
                        float scale, void* stream) {
  if (dtype == 0)
    return launch<float, float, false, false>(
        q, k, v, nullptr, nullptr, nullptr, t, o, B, cap, 1, 1, H, Hkv, D,
        window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, false>(
        q, k, v, nullptr, nullptr, nullptr, t, o, B, cap, 1, 1, H, Hkv, D,
        window, scale, stream);
  return -2;
}

// kpool, vpool: (pages, page_size, Hkv, D); table: (B, n_log) int32.
int pt_decode_attention_paged(int dtype, const void* q, const void* kpool,
                              const void* vpool, const void* table,
                              const void* t, void* o, int B, int pages,
                              int page_size, int n_log, int H, int Hkv,
                              int D, int window, float scale,
                              void* stream) {
  if (dtype == 0)
    return launch<float, float, true, false>(
        q, kpool, vpool, nullptr, nullptr, table, t, o, B, page_size, n_log,
        pages, H, Hkv, D, window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, true, false>(
        q, kpool, vpool, nullptr, nullptr, table, t, o, B, page_size, n_log,
        pages, H, Hkv, D, window, scale, stream);
  return -2;
}

// int8 pools: kq, vq (pages, page_size, Hkv, D) int8 with D % 16 == 0
// and 16-byte aligned rows; ks, vs (pages, page_size, Hkv) float32. dtype
// is q's and o's (0 = float32, 1 = bfloat16).
int pt_decode_attention_paged_quant(int dtype, const void* q,
                                    const void* kq, const void* ks,
                                    const void* vq, const void* vs,
                                    const void* table, const void* t,
                                    void* o, int B, int pages,
                                    int page_size, int n_log, int H,
                                    int Hkv, int D, int window, float scale,
                                    void* stream) {
  if (dtype == 0)
    return launch<float, int8_t, true, true>(
        q, kq, vq, ks, vs, table, t, o, B, page_size, n_log, pages, H, Hkv,
        D, window, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true, true>(
        q, kq, vq, ks, vs, table, t, o, B, page_size, n_log, pages, H, Hkv,
        D, window, scale, stream);
  return -2;
}

}  // extern "C"
