// Flash attention for Hopper (sm_90a): the forward and the recompute
// backward (dq, and dk/dv) over (batch, seq, heads, head_dim) tensors.
//
// Replaces the TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel <- _fwd_kernel (reached through _fwd_call)
//   flash_dq_kernel  <- _dq_kernel  (reached through _bwd_call)
//   flash_dkv_kernel <- _dkv_kernel (reached through _bwd_call)
//
// What it computes. Query row r (position r + Tk - Tq, bottom-right
// aligned) of head h sees key c of kv head h / G (GQA is kv-major, G =
// H / Hkv) iff keep(r, c): c <= pos when causal; pos - c < window and,
// without causal, c - pos < window when a window is set; kv_mask[b, c]
// when a key-padding mask is given. Scores are (q . k) * scale in float32
// and dead ones take the finite -1e30. The forward keeps a running max m
// and sum l per row, writes o = acc / l (l == 0 read as 1, so a row with
// no live key outputs zeros) and lse = m + log(max(l, 1e-37)), which is
// -1e30 for such a row. The backward recomputes p = exp(s - lse) with
// p = 0 where s <= -5e29 (without that guard a dead row would give
// exp(0) = 1), ds = p * (dp - delta) * scale with dp = do . v and delta
// = rowsum(do * o) computed by the caller. dk and dv come back already
// summed over the G query heads of each kv head. In bfloat16, p is
// rounded to bfloat16 before p.v and p^T.do, and ds before ds.k and
// ds^T.q, as the TPU kernels cast them; every sum is float32.
//
// What bounds it: operations. At the training shape (B=8, T=1024, H=12,
// Hkv=4, D=64, causal) the live scores number B*H*T*(T+1)/2 = 50.4 M and
// each costs 4*D flops forward, 6*D for dq and 8*D for dk/dv, against
// about 67 MB of operands; the float32 CUDA-core rate, not memory, is the
// limit.
//
// Design (simple first). One thread block of 256 threads owns BR rows: BR
// query rows (forward, dq) or BR key rows (dk/dv), with BR = 64, or 32 at
// D = 256 so that the tiles fit in shared memory. It walks, in a loop that
// takes the place of the TPU's sequential grid axis, only the 64-wide
// tiles of the other side that can hold a live entry (the block-skipping
// rule of _block_should_run, so a window costs O(T * window)). Tiles sit
// in shared memory as float32, rows padded to D + 1 floats so that the 16
// lanes reading 16 different rows hit 16 banks. Each thread owns a
// (BR/16) x 4 patch of the score tile and a (BR/16) x (D/16) patch of the
// output, both in registers; a row's 16 owners are 16 lanes of one warp,
// so row max and row sum reduce with shuffles. dk/dv loop over the G query
// heads inside the block and accumulate in registers, so no atomics and no
// per-head copies are needed, and the result is deterministic. Left for a
// later change: tensor cores (mma/wgmma), cp.async or TMA double
// buffering, and vectorised shared-memory reads.
//
// Plain C interface for ctypes: each entry takes a FlashArgs by pointer
// and returns cudaGetLastError() (or a negative code for arguments the
// kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// Element strides are per (batch, seq, head); the head_dim stride is 1.
// o, dq are (B, Tq, H, D) and dk, dv (B, Tk, Hkv, D), contiguous; lse
// and delta (B, H, Tq) float32; kv_mask (B, Tk) uint8 or null.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const uint8_t* kv_mask;
  void* o;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int B, Tq, Tk, H, Hkv, D;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // width of the walked tiles
constexpr float kNegInf = -1e30f;
constexpr float kDead = -5e29f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and read back as float32 (the TPU kernels' casts)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The per-entry mask, ONE definition for all three kernels: query row r
// at position pos = r + Tk - Tq against key c.
__device__ __forceinline__ bool keep(int pos, int c, int causal, int window) {
  if (causal && c > pos) return false;
  if (window > 0) {
    if (pos - c >= window) return false;
    if (!causal && c - pos >= window) return false;
  }
  return true;
}

// Tiles of width `tile` over keys that query rows [r0, r1] can see.
__device__ __forceinline__ void key_tiles(const FlashArgs& a, int r0, int r1,
                                          int tile, int* lo, int* hi) {
  const int off = a.Tk - a.Tq;
  int c_lo = 0, c_hi = a.Tk - 1;
  if (a.causal) c_hi = r1 + off;
  if (a.window > 0) {
    c_lo = r0 + off - (a.window - 1);
    if (!a.causal) c_hi = r1 + off + (a.window - 1);
  }
  c_lo = max(c_lo, 0);
  c_hi = min(c_hi, a.Tk - 1);
  *lo = c_lo / tile;
  *hi = c_hi < c_lo ? *lo - 1 : c_hi / tile;
}

// Tiles of width `tile` over query rows that can see keys [c0, c1].
__device__ __forceinline__ void query_tiles(const FlashArgs& a, int c0, int c1,
                                            int tile, int* lo, int* hi) {
  const int off = a.Tk - a.Tq;
  int r_lo = 0, r_hi = a.Tq - 1;
  if (a.causal) r_lo = c0 - off;
  if (a.window > 0) {
    r_hi = c1 + (a.window - 1) - off;
    if (!a.causal) r_lo = c0 - (a.window - 1) - off;
  }
  r_lo = max(r_lo, 0);
  r_hi = min(r_hi, a.Tq - 1);
  *lo = r_lo / tile;
  *hi = r_hi < r_lo ? *lo - 1 : r_hi / tile;
}

// rows x D elements of a (B, T, heads, D) tensor, starting at element
// `base` with row stride `rs`, into shared memory with row stride `ld_s`.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld_s, const T* src,
                                          long long base, long long rs,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * ld_s + d] = ld(src + base + r * rs + d);
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int w = 8; w > 0; w >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int w = 8; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// Shared memory of each kernel, in floats.
template <int D, int BR>
__host__ __device__ constexpr int fwd_smem_floats() {
  return BR * (D + 1) + kTile * (D + 1) + kTile * D + BR * (kTile + 1) +
         kTile;
}
template <int D, int BR>
__host__ __device__ constexpr int dq_smem_floats() {
  return 2 * BR * (D + 1) + 2 * kTile * (D + 1) + BR * (kTile + 1) + kTile;
}
template <int D, int BR>
__host__ __device__ constexpr int dkv_smem_floats() {
  return 2 * BR * (D + 1) + 2 * kTile * (D + 1) + 2 * BR * (kTile + 1) + BR +
         2 * kTile;
}

// ----- forward ------------------------------------------------------------

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int RR = BR / 16, CC = kTile / 16, DC = D / 16, LD = D + 1,
                LP = kTile + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                // BR x LD
  float* k_s = q_s + BR * LD;       // kTile x LD
  float* v_s = k_s + kTile * LD;    // kTile x D
  float* p_s = v_s + kTile * D;     // BR x LP
  float* km_s = p_s + BR * LP;      // kTile

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_rows<T, D>(q_s, LD, q, b * a.q_sb + r0 * a.q_st + h * a.q_sh, a.q_st,
                  BR);
  float acc[RR][DC], m[RR], l[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int j_lo, j_hi;
  key_tiles(a, r0, r0 + BR - 1, kTile, &j_lo, &j_hi);

  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();  // the last tile's readers are done
    load_rows<T, D>(k_s, LD, k, b * a.k_sb + c0 * a.k_st + hk * a.k_sh,
                    a.k_st, kTile);
    load_rows<T, D>(v_s, D, v, b * a.v_sb + c0 * a.v_st + hk * a.v_sh,
                    a.v_st, kTile);
    if (threadIdx.x < kTile)
      km_s[threadIdx.x] =
          a.kv_mask ? (float)a.kv_mask[(long long)b * a.Tk + c0 + threadIdx.x]
                    : 1.f;
    __syncthreads();

    float s[RR][CC];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RR], kv[CC];
#pragma unroll
      for (int i = 0; i < RR; ++i) qv[i] = q_s[(ty * RR + i) * LD + d];
#pragma unroll
      for (int c = 0; c < CC; ++c) kv[c] = k_s[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < CC; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int pos = r0 + ty * RR + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const int cl = tx + 16 * c;
        float x = s[i][c] * a.scale;
        if (!keep(pos, c0 + cl, a.causal, a.window) || km_s[cl] == 0.f)
          x = kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const float p = s[i][c] <= kDead ? 0.f : expf(s[i][c] - m_new);
        sum += p;
        p_s[(ty * RR + i) * LP + tx + 16 * c] = rnd<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float pv[RR], vv[DC];
#pragma unroll
      for (int i = 0; i < RR; ++i) pv[i] = p_s[(ty * RR + i) * LP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[jj * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const int r = r0 + ty * RR + i;
    const float lv = l[i] == 0.f ? 1.f : l[i];
    const long long base = (((long long)b * a.Tq + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) st(o + base + tx + 16 * c, acc[i][c] / lv);
    if (tx == 0)
      a.lse_out[((long long)b * a.H + h) * a.Tq + r] =
          m[i] + logf(fmaxf(lv, 1e-37f));
  }
}

// ----- dq -----------------------------------------------------------------

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashArgs a) {
  constexpr int RR = BR / 16, CC = kTile / 16, DC = D / 16, LD = D + 1,
                LP = kTile + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                // BR x LD
  float* do_s = q_s + BR * LD;      // BR x LD
  float* k_s = do_s + BR * LD;      // kTile x LD
  float* v_s = k_s + kTile * LD;    // kTile x LD
  float* ds_s = v_s + kTile * LD;   // BR x LP
  float* km_s = ds_s + BR * LP;     // kTile

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  load_rows<T, D>(q_s, LD, q, b * a.q_sb + r0 * a.q_st + h * a.q_sh, a.q_st,
                  BR);
  load_rows<T, D>(do_s, LD, dout, b * a.do_sb + r0 * a.do_st + h * a.do_sh,
                  a.do_st, BR);
  float acc[RR][DC], lse[RR], delta[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const long long row = ((long long)b * a.H + h) * a.Tq + r0 + ty * RR + i;
    lse[i] = a.lse[row];
    delta[i] = a.delta[row];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int j_lo, j_hi;
  key_tiles(a, r0, r0 + BR - 1, kTile, &j_lo, &j_hi);

  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();
    load_rows<T, D>(k_s, LD, k, b * a.k_sb + c0 * a.k_st + hk * a.k_sh,
                    a.k_st, kTile);
    load_rows<T, D>(v_s, LD, v, b * a.v_sb + c0 * a.v_st + hk * a.v_sh,
                    a.v_st, kTile);
    if (threadIdx.x < kTile)
      km_s[threadIdx.x] =
          a.kv_mask ? (float)a.kv_mask[(long long)b * a.Tk + c0 + threadIdx.x]
                    : 1.f;
    __syncthreads();

    float s[RR][CC], dp[RR][CC];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RR], dov[RR], kv[CC], vv[CC];
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        qv[i] = q_s[(ty * RR + i) * LD + d];
        dov[i] = do_s[(ty * RR + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        kv[c] = k_s[(tx + 16 * c) * LD + d];
        vv[c] = v_s[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      const int pos = r0 + ty * RR + i + off;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const int cl = tx + 16 * c;
        float x = s[i][c] * a.scale;
        if (!keep(pos, c0 + cl, a.causal, a.window) || km_s[cl] == 0.f)
          x = kNegInf;
        const float p = x <= kDead ? 0.f : expf(x - lse[i]);
        ds_s[(ty * RR + i) * LP + cl] =
            rnd<T>(p * (dp[i][c] - delta[i]) * a.scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float dsv[RR], kv[DC];
#pragma unroll
      for (int i = 0; i < RR; ++i) dsv[i] = ds_s[(ty * RR + i) * LP + jj];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[jj * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const long long base =
        (((long long)b * a.Tq + r0 + ty * RR + i) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) st(dq + base + tx + 16 * c, acc[i][c]);
  }
}

// ----- dk, dv -------------------------------------------------------------

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashArgs a) {
  constexpr int RR = BR / 16, CC = kTile / 16, DC = D / 16, LD = D + 1,
                LP = kTile + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                // BR x LD (this block's keys)
  float* v_s = k_s + BR * LD;       // BR x LD
  float* q_s = v_s + BR * LD;       // kTile x LD (the walked query rows)
  float* do_s = q_s + kTile * LD;   // kTile x LD
  float* pt_s = do_s + kTile * LD;  // BR x LP: p^T
  float* dst_s = pt_s + BR * LP;    // BR x LP: ds^T
  float* km_s = dst_s + BR * LP;    // BR
  float* lse_s = km_s + BR;         // kTile
  float* delta_s = lse_s + kTile;   // kTile

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  load_rows<T, D>(k_s, LD, k, b * a.k_sb + c0 * a.k_st + hk * a.k_sh, a.k_st,
                  BR);
  load_rows<T, D>(v_s, LD, v, b * a.v_sb + c0 * a.v_st + hk * a.v_sh, a.v_st,
                  BR);
  if (threadIdx.x < BR)
    km_s[threadIdx.x] =
        a.kv_mask ? (float)a.kv_mask[(long long)b * a.Tk + c0 + threadIdx.x]
                  : 1.f;
  float dk[RR][DC], dv[RR][DC];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  int i_lo, i_hi;
  query_tiles(a, c0, c0 + BR - 1, kTile, &i_lo, &i_hi);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int r0 = it * kTile;
      __syncthreads();
      load_rows<T, D>(q_s, LD, q, b * a.q_sb + r0 * a.q_st + h * a.q_sh,
                      a.q_st, kTile);
      load_rows<T, D>(do_s, LD, dout,
                      b * a.do_sb + r0 * a.do_st + h * a.do_sh, a.do_st,
                      kTile);
      if (threadIdx.x < kTile) {
        const long long row = ((long long)b * a.H + h) * a.Tq + r0 +
                              threadIdx.x;
        lse_s[threadIdx.x] = a.lse[row];
        delta_s[threadIdx.x] = a.delta[row];
      }
      __syncthreads();

      // transposed tiles: s[i][c] = k_(key i) . q_(query c)
      float s[RR][CC], dp[RR][CC];
#pragma unroll
      for (int i = 0; i < RR; ++i)
#pragma unroll
        for (int c = 0; c < CC; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RR], vv[RR], qv[CC], dov[CC];
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          kv[i] = k_s[(ty * RR + i) * LD + d];
          vv[i] = v_s[(ty * RR + i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          qv[c] = q_s[(tx + 16 * c) * LD + d];
          dov[c] = do_s[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RR; ++i)
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], dov[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int kl = ty * RR + i;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int ql = tx + 16 * c;
          float x = s[i][c] * a.scale;
          if (!keep(r0 + ql + off, c0 + kl, a.causal, a.window) ||
              km_s[kl] == 0.f)
            x = kNegInf;
          const float p = x <= kDead ? 0.f : expf(x - lse_s[ql]);
          pt_s[kl * LP + ql] = rnd<T>(p);
          dst_s[kl * LP + ql] =
              rnd<T>(p * (dp[i][c] - delta_s[ql]) * a.scale);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[RR], dsv[RR], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          pv[i] = pt_s[(ty * RR + i) * LP + qq];
          dsv[i] = dst_s[(ty * RR + i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = do_s[qq * LD + tx + 16 * c];
          qv[c] = q_s[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RR; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dk_o = static_cast<T*>(a.dk);
  T* dv_o = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const long long base =
        (((long long)b * a.Tk + c0 + ty * RR + i) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      st(dk_o + base + tx + 16 * c, dk[i][c]);
      st(dv_o + base + tx + 16 * c, dv[i][c]);
    }
  }
}

// ----- launch -------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D, int BR>
constexpr size_t smem_bytes(int kind) {
  return sizeof(float) * (kind == kFwd  ? fwd_smem_floats<D, BR>()
                          : kind == kDq ? dq_smem_floats<D, BR>()
                                        : dkv_smem_floats<D, BR>());
}

template <typename T, int D>
int launch(int kind, const FlashArgs& a, cudaStream_t stream) {
  constexpr int BR = D == 256 ? 32 : 64;
  void (*kernel)(FlashArgs) = kind == kFwd  ? flash_fwd_kernel<T, D, BR>
                              : kind == kDq ? flash_dq_kernel<T, D, BR>
                                            : flash_dkv_kernel<T, D, BR>;
  const size_t smem = smem_bytes<D, BR>(kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kind == kDkv ? a.Tk / BR : a.Tq / BR,
                  kind == kDkv ? a.Hkv : a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int kind, const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 64:
      return launch<T, 64>(kind, a, stream);
    case 128:
      return launch<T, 128>(kind, a, stream);
    case 256:
      return launch<T, 256>(kind, a, stream);
  }
  return -3;
}

int dispatch(int kind, int dtype, const FlashArgs* a, void* stream) {
  if (a->B <= 0 || a->Hkv <= 0 || a->H % a->Hkv != 0 || a->Tq % kTile ||
      a->Tk % kTile || a->Tq <= 0 || a->Tk <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(kind, *a, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(kind, *a, s);
  return -2;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Return 0 on a clean launch, a CUDA
// error code, or -1 (bad shape), -2 (bad dtype), -3 (head_dim not 64,
// 128 or 256).
int pt_flash_fwd(int dtype, const FlashArgs* a, void* stream) {
  return dispatch(kFwd, dtype, a, stream);
}

int pt_flash_dq(int dtype, const FlashArgs* a, void* stream) {
  return dispatch(kDq, dtype, a, stream);
}

int pt_flash_dkv(int dtype, const FlashArgs* a, void* stream) {
  return dispatch(kDkv, dtype, a, stream);
}

// sizeof(FlashArgs), for the ctypes mirror to check its layout against
size_t pt_flash_args_size(void) { return sizeof(FlashArgs); }

}  // extern "C"
