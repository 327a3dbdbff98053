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
// Design: a split over the cache length with the combine in the same
// launch.
// - Grid B * Hkv * S: block (b, kv head, s) takes the chunk of kChunk =
//   256 logical positions [256 s, 256 s + 256), S = ceil(L / 256) from the
//   static length (the cursors stay on the device: no host sync). A chunk
//   outside the live range [lo, hi] writes an empty partial (m = -1e30,
//   l = 0) and leaves; a live chunk walks its live 64-key tiles (at most
//   4), tiles aligned to multiples of 64 positions, keys below lo or above
//   hi masked. At the serving shape (B 8, Hkv 4, capacity 2048) that is
//   256 blocks on 132 SMs where the one-block-per-(b, kv head) kernel had
//   32, each walking up to 32 tiles in a row.
// - Loads: a tile's K and V rows go to shared memory as 16-byte cp.async
//   copies (float32, bfloat16 and int8 rows alike; int8 rows bring their
//   two float32 scales), double-buffered: the next tile's copies are in
//   flight while the block computes on this one. Each key row's page is
//   looked up once per tile, by one thread, into a row table in shared
//   memory. Shared rows are padded by 16 bytes, so the 16-byte reads of
//   the dot products (threads on consecutive keys) hit distinct banks.
// - Compute, per tile, for the G query heads of the kv head (the GQA
//   group; each K/V row is read once for all of them): scores in float32
//   (int8 values dequantized element by element with their vector's
//   scale, as the TPU kernel does), the online-softmax update (one warp
//   per query row), then p.V into the running accumulator.
// - Combine: each block writes its partial (m, l, unnormalized acc) to
//   scratch that the wrapper allocates, fences, and bumps the (b, kv head)
//   counter; the last block to arrive merges the S partials with the
//   log-sum-exp rule (weights exp(m_s - max m), partials with l = 0
//   skipped), writes o and sets the counter back to 0 for the next call.
//   One launch per call, no memset and no second kernel: the serving tick
//   is host-bound, so a second launch per layer would cost more than it
//   saves. The counters are a buffer the wrapper keeps per device and
//   stream.
// Masking values follow the TPU kernel: -1e30 for dead keys, p = 0 where
// s <= -5e29, and l == 0 read as 1 after the merge, so an empty live range
// outputs zeros. Rows must be 16-byte multiples (D * sizeof(T) % 16 ==
// 0) at 16-byte aligned planes; the wrapper raises otherwise.
// What is still weak: scalar shared-memory arithmetic (no tensor cores;
// G is 1-8 query rows), and 4 block-wide barriers per tile.
//
// Plain C interface for ctypes; every launch returns cudaGetLastError()
// (or a negative code for an argument it refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 256;    // positions per split (4 tiles)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory, in bytes: q (G*D floats), p (G*kTile), acc (G*D), m, l,
// alpha (G each), a flag; then per buffer the row table (kTile int64),
// the int8 scales (kTile x 2 floats), the K and V tiles (kTile rows of
// D * kv_bytes + 16 bytes).
__host__ __device__ inline size_t row_bytes(int D, int kv_bytes) {
  return (size_t)D * kv_bytes + 16;
}
__host__ __device__ inline size_t head_bytes(int G, int D) {
  const size_t b = ((size_t)G * D * 2 + (size_t)G * kTile + 3 * G + 4) * 4;
  return (b + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t buf_bytes(int D, int kv_bytes) {
  return (size_t)kTile * 8 + (size_t)kTile * 8 +
         2 * kTile * row_bytes(D, kv_bytes);
}
__host__ __device__ inline size_t smem_bytes(int G, int D, int kv_bytes,
                                             int nbuf) {
  return head_bytes(G, D) + nbuf * buf_bytes(D, kv_bytes);
}

// Row of the K/V planes that holds logical position pos of row b (the
// value plane's row times Hkv plus the kv head gives the vector).
template <bool kPaged>
__device__ __forceinline__ long long cache_row(const int32_t* table, int b,
                                               int pos, int rows, int n_log,
                                               int pages) {
  if (!kPaged) return (long long)b * rows + pos;
  const int lp = pos / rows;
  int page = table[(size_t)b * n_log + lp];
  page = min(max(page, 0), pages - 1);
  return (long long)page * rows + (pos - lp * rows);
}

// 16 bytes of a K/V row as floats (4 float32, 8 bfloat16 or 16 int8).
template <typename T>
__device__ __forceinline__ void unpack16(const void* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) f[e] = to_f32(x[e]);
}

// TQ: q and o; TKV: the K/V planes (int8 when kQuant, with the float32
// scale planes ks/vs, one scale per (row, kv head) vector). part: the
// partials (ml: (B*Hkv*S*G, 2), then acc: (B*Hkv*S*G, D)); cnt: one int
// per (b, kv head), 0 between calls.
template <typename TQ, typename TKV, bool kPaged, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q,
                            const TKV* __restrict__ k,
                            const TKV* __restrict__ v,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ t,
                            TQ* __restrict__ o, float* __restrict__ part,
                            int* __restrict__ cnt, int B, int rows,
                            int n_log, int pages, int H, int Hkv, int D,
                            int window, float scale, int S, int nbuf) {
  // rows: cache capacity (contiguous) or page size (paged)
  const int s = blockIdx.x % S;
  const int bh = blockIdx.x / S;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int G = H / Hkv;
  const int L = kPaged ? n_log * rows : rows;
  constexpr int kPer = 16 / (int)sizeof(TKV);   // elements per 16 bytes
  const int vpr = D / kPer;                     // 16-byte vectors per row
  const int rowb = (int)row_bytes(D, sizeof(TKV));

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + G * D;
  float* acc_s = p_s + G * kTile;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  int* flag = reinterpret_cast<int*>(a_s + G);
  uint8_t* bufs = smem + head_bytes(G, D);
  const size_t bufb = buf_bytes(D, sizeof(TKV));
  auto rowoff = [&](int ib) {
    return reinterpret_cast<long long*>(bufs + ib * bufb);
  };
  auto scl = [&](int ib) {
    return reinterpret_cast<float*>(bufs + ib * bufb + kTile * 8);
  };
  auto kbuf = [&](int ib) { return bufs + ib * bufb + kTile * 16; };
  auto vbuf = [&](int ib) {
    return bufs + ib * bufb + kTile * 16 + (size_t)kTile * rowb;
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  const size_t n_part = (size_t)B * Hkv * S * G;
  float* part_ml = part;
  float* part_acc = part + 2 * n_part;
  const size_t pbase = ((size_t)bh * S + s) * G;
  // q and o are (B, H, D); the group's heads hk*G .. hk*G+G-1 are
  // contiguous
  const size_t qo_base = ((size_t)b * H + (size_t)hk * G) * D;

  const int tb = t[b];
  const int lo = window > 0 ? max(tb - window + 1, 0) : 0;
  const int hi = min(tb, L - 1);
  const int c0 = s * kChunk;
  const int first = max(lo, c0);                       // live positions
  const int last = min(hi, min(c0 + kChunk, L) - 1);   // of this chunk

  if (first > last) {
    for (int g = tid; g < G; g += kThreads) {
      part_ml[(pbase + g) * 2] = kNegInf;
      part_ml[(pbase + g) * 2 + 1] = 0.f;
    }
  } else {
    for (int i = tid; i < G * D; i += kThreads) {
      q_s[i] = to_f32(q[qo_base + i]);
      acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
      m_s[g] = kNegInf;
      l_s[g] = 0.f;
    }
    const int tile0 = c0 + ((first - c0) / kTile) * kTile;
    const int ntiles = (last - tile0) / kTile + 1;

    // the row table, then the 16-byte copies of tile p0 into buffer ib
    auto issue = [&](int p0, int ib) {
      long long* ro = rowoff(ib);
      for (int j = tid; j < kTile; j += kThreads) {
        const int pos = p0 + j;
        ro[j] = (pos >= first && pos <= last)
                    ? cache_row<kPaged>(table, b, pos, rows, n_log, pages) *
                              Hkv + hk
                    : -1;
      }
      __syncthreads();
      uint8_t* kb = kbuf(ib);
      uint8_t* vb = vbuf(ib);
      for (int i = tid; i < kTile * vpr; i += kThreads) {
        const int j = i / vpr;
        const int c = i - j * vpr;
        const long long vec = ro[j];
        if (vec < 0) continue;
        cp_async16(kb + j * rowb + c * 16, k + vec * D + c * kPer);
        cp_async16(vb + j * rowb + c * 16, v + vec * D + c * kPer);
      }
      if constexpr (kQuant) {
        float* sc = scl(ib);
        for (int j = tid; j < kTile; j += kThreads) {
          const long long vec = ro[j];
          if (vec < 0) continue;
          cp_async4(sc + 2 * j, ks + vec);
          cp_async4(sc + 2 * j + 1, vs + vec);
        }
      }
      cp_async_commit();
    };

    issue(tile0, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int ib = nbuf == 2 ? (it & 1) : 0;
      const int p0 = tile0 + it * kTile;
      if (nbuf == 2 && it + 1 < ntiles) {
        issue(p0 + kTile, ib ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int jlo = max(first - p0, 0);
      const int jhi = min(last - p0, kTile - 1);
      const uint8_t* kb = kbuf(ib);
      const uint8_t* vb = vbuf(ib);
      const float* sc = scl(ib);
      // scores s[g][j] = (q_g . k_j) * scale; dead slots -1e30
      for (int i = tid; i < G * kTile; i += kThreads) {
        const int g = i / kTile;
        const int j = i - g * kTile;
        float sco = kNegInf;
        if (j >= jlo && j <= jhi) {
          const float* qr = q_s + g * D;
          const uint8_t* kr = kb + j * rowb;
          const float sk = kQuant ? sc[2 * j] : 1.f;
          float dot = 0.f;
          for (int c = 0; c < vpr; ++c) {
            float kf[kPer];
            unpack16<TKV>(kr + c * 16, kf);
#pragma unroll
            for (int e = 0; e < kPer; ++e)
              dot = fmaf(qr[c * kPer + e], kQuant ? kf[e] * sk : kf[e], dot);
          }
          sco = dot * scale;
        }
        p_s[i] = sco;
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
        const float e0 = s0 <= 0.5f * kNegInf ? 0.f : expf(s0 - m_new);
        const float e1 = s1 <= 0.5f * kNegInf ? 0.f : expf(s1 - m_new);
        p_s[g * kTile + lane] = e0;
        p_s[g * kTile + lane + 32] = e1;
        float sum = e0 + e1;
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
        for (int j = jlo; j <= jhi; ++j) {
          const float vj =
              to_f32(reinterpret_cast<const TKV*>(vb + j * rowb)[d]);
          pv = fmaf(pr[j], kQuant ? vj * sc[2 * j + 1] : vj, pv);
        }
        acc_s[i] = acc_s[i] * a_s[g] + pv;
      }
      __syncthreads();
      if (nbuf == 1 && it + 1 < ntiles) issue(p0 + kTile, 0);
    }
    for (int g = tid; g < G; g += kThreads) {
      part_ml[(pbase + g) * 2] = m_s[g];
      part_ml[(pbase + g) * 2 + 1] = l_s[g];
    }
    for (int i = tid; i < G * D; i += kThreads)
      part_acc[pbase * D + i] = acc_s[i];
  }

  // the last block of (b, kv head) to arrive merges the S partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(&cnt[bh], 1);
    *flag = done == S - 1;
    if (done == S - 1) {
      atomicExch(&cnt[bh], 0);   // ready for the next call
      __threadfence();
    }
  }
  __syncthreads();
  if (!*flag) return;
  // (L2 loads, independent across chunks; an empty partial's acc was
  // never written and is selected away, not multiplied by 0)
  const size_t gbase = (size_t)bh * S * G;
  const float2* ml2 = reinterpret_cast<const float2*>(part_ml);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll 4
    for (int s2 = 0; s2 < S; ++s2) {
      const float2 ml = __ldcg(&ml2[gbase + (size_t)s2 * G + g]);
      mx = ml.y > 0.f ? fmaxf(mx, ml.x) : mx;
    }
    float l = 0.f, acc = 0.f;
#pragma unroll 4
    for (int s2 = 0; s2 < S; ++s2) {
      const size_t r = gbase + (size_t)s2 * G + g;
      const float2 ml = __ldcg(&ml2[r]);
      const float a = __ldcg(&part_acc[r * D + d]);
      if (ml.y > 0.f) {
        const float w = expf(ml.x - mx);
        l = fmaf(ml.y, w, l);
        acc = fmaf(a, w, acc);
      }
    }
    l = (l == 0.f) ? 1.f : l;  // an empty live range outputs zeros
    store(&o[qo_base + i], acc / l);
  }
}

template <typename TQ, typename TKV, bool kPaged, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* t, void* o,
           void* part, void* cnt, int B, int rows, int n_log, int pages,
           int H, int Hkv, int D, int window, float scale, int S,
           void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0) return -1;
  if ((D * (int)sizeof(TKV)) % 16 != 0) return -1;
  const int L = kPaged ? n_log * rows : rows;
  if (L <= 0 || S <= 0 || (long long)S * kChunk < L) return -1;
  if ((long long)B * Hkv * S > 0x7fffffffLL) return -1;
  const int G = H / Hkv;
  const int nbuf =
      smem_bytes(G, D, sizeof(TKV), 2) <= kSmemLimit ? 2 : 1;
  const size_t smem = smem_bytes(G, D, sizeof(TKV), nbuf);
  auto kernel = decode_attention_kernel<TQ, TKV, kPaged, kQuant>;
  static bool smem_set[64] = {};   // per device, set once to the limit
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return -1;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  kernel<<<B * Hkv * S, kThreads, smem, (cudaStream_t)stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, (const float*)ks,
      (const float*)vs, (const int32_t*)table, (const int32_t*)t, (TQ*)o,
      (float*)part, (int*)cnt, B, rows, n_log, pages, H, Hkv, D, window,
      scale, S, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at group size G, head dim D and
// kv_bytes per K/V element, single-buffered (the least the kernel can
// run with; it double-buffers when twice the tile buffers fit).
size_t pt_decode_attention_smem_bytes(int G, int D, int kv_bytes) {
  return smem_bytes(G, D, kv_bytes, 1);
}

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// q, o: (B, H, D); k, v: (B, cap, Hkv, D); t: (B,) int32. S: the number
// of 256-position chunks, ceil(L / 256) or more; part: the partials
// scratch, B * Hkv * S * G * (D + 2) floats; cnt: B * Hkv ints, 0
// between calls on a stream.
int pt_decode_attention(int dtype, const void* q, const void* k,
                        const void* v, const void* t, void* o, void* part,
                        void* cnt, int B, int cap, int H, int Hkv, int D,
                        int window, float scale, int S, void* stream) {
  if (dtype == 0)
    return launch<float, float, false, false>(
        q, k, v, nullptr, nullptr, nullptr, t, o, part, cnt, B, cap, 1, 1,
        H, Hkv, D, window, scale, S, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, false>(
        q, k, v, nullptr, nullptr, nullptr, t, o, part, cnt, B, cap, 1, 1,
        H, Hkv, D, window, scale, S, stream);
  return -2;
}

// kpool, vpool: (pages, page_size, Hkv, D); table: (B, n_log) int32.
int pt_decode_attention_paged(int dtype, const void* q, const void* kpool,
                              const void* vpool, const void* table,
                              const void* t, void* o, void* part, void* cnt,
                              int B, int pages, int page_size, int n_log,
                              int H, int Hkv, int D, int window, float scale,
                              int S, void* stream) {
  if (dtype == 0)
    return launch<float, float, true, false>(
        q, kpool, vpool, nullptr, nullptr, table, t, o, part, cnt, B,
        page_size, n_log, pages, H, Hkv, D, window, scale, S, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, true, false>(
        q, kpool, vpool, nullptr, nullptr, table, t, o, part, cnt, B,
        page_size, n_log, pages, H, Hkv, D, window, scale, S, stream);
  return -2;
}

// int8 pools: kq, vq (pages, page_size, Hkv, D) int8 with D % 16 == 0
// and 16-byte aligned planes; ks, vs (pages, page_size, Hkv) float32.
// dtype is q's and o's (0 = float32, 1 = bfloat16).
int pt_decode_attention_paged_quant(int dtype, const void* q,
                                    const void* kq, const void* ks,
                                    const void* vq, const void* vs,
                                    const void* table, const void* t,
                                    void* o, void* part, void* cnt, int B,
                                    int pages, int page_size, int n_log,
                                    int H, int Hkv, int D, int window,
                                    float scale, int S, void* stream) {
  if (dtype == 0)
    return launch<float, int8_t, true, true>(
        q, kq, vq, ks, vs, table, t, o, part, cnt, B, page_size, n_log,
        pages, H, Hkv, D, window, scale, S, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true, true>(
        q, kq, vq, ks, vs, table, t, o, part, cnt, B, page_size, n_log,
        pages, H, Hkv, D, window, scale, S, stream);
  return -2;
}

}  // extern "C"
