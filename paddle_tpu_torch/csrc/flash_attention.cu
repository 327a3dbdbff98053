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
// when a key-padding mask is given; seg[b, r] == seg[b, c] when the
// segment ids of packed rows are given (Tq == Tk; segment 0, the padding
// tail, attends within itself like any other). Scores are (q . k) * scale
// in float32 and dead ones take the finite -1e30. The forward keeps a
// running max m and sum l per row, writes o = acc / l (l == 0 read as 1,
// so a row with no live key outputs zeros) and lse = m + log(max(l,
// 1e-37)), which is -1e30 for such a row. The backward recomputes p =
// exp(s - lse) with p = 0 where s <= -5e29 (without that guard a dead row
// would give exp(0) = 1), ds = p * (dp - delta) * scale with dp = do . v
// and delta = rowsum(do * o) computed by the caller. Attention dropout
// (dropout_p > 0): entry (pos, c) of head h is kept where the TPU kernels'
// counter-based hash of (seeds[b, h], pos, c) says so (dropout_keep, bit
// for bit, so the backward rebuilds the forward's mask with nothing
// stored); l sums the undropped p, acc the kept p times 1 / (1 - p); the
// backward drops dp with the same mask (and dv takes the dropped p). dk and dv come back already
// summed over the G query heads of each kv head. In bfloat16, p is
// rounded to bfloat16 before p.v and p^T.do, and ds before ds.k and
// ds^T.q, as the TPU kernels cast them; every sum is float32.
//
// What bounds it: operations. At the training shape (B=8, T=1024, H=12,
// Hkv=4, D=64, causal) the live scores number B*H*T*(T+1)/2 = 50.4 M and
// each costs 4*D flops forward, 6*D for dq and 8*D for dk/dv, against
// about 67 MB of operands. As float32-accurate tensor-core work (three
// TF32 passes at 495 TFLOP/s, 165 TFLOP/s of float32 work) that is 0.08
// / 0.12 / 0.16 ms, well above the bytes' time (0.02-0.03 ms).
//
// All three kernels run on the tensor cores. A block owns a tile of rows
// (query rows for the forward and dq, 128 at D = 64, the last block
// short when Tq is not a multiple of 128; key rows for dk/dv, 64, looping
// over the G query heads of the group) and walks, in a loop that takes
// the place of the TPU's sequential grid axis, only the tiles of the
// other side that hold a live entry (the block-skipping rule of
// _block_should_run, so a window costs O(T * window)). Each warp owns 16
// rows, and every product is a warp-wide mma.sync: s = q.k^T (and dp =
// do.v^T; dk/dv: their transposes k.q^T and v.do^T) into accumulator
// fragments; the forward's online softmax, p and ds made there on the
// CUDA cores from the same fragments (the masks through the one keep()
// rule, skipped for tiles that are wholly live); then acc += p.v (dq +=
// ds.k; dv += p^T.do, dk += ds^T.q) with p and ds read as the next
// product's A operand straight from the registers: no trip through
// shared memory. In the forward a row's entries sit on the four lanes of
// a quad: its running max reduces with two shuffles a tile, and each lane
// keeps its own part of the running sum (a compensated sum: lse feeds the
// backward), reduced once at the end.
// float32 takes three TF32 products of a hi/lo split of each operand
// ("3xTF32", see struct Mma), because one TF32 pass keeps three decimal
// digits and the training path's float32 contract (1e-4 against the
// plain version) needs float32's; each 8-deep step's passes are summed
// apart and added to the product's sum with a rounded float32 add
// (Mma::step), which keeps the kernels about as close to a float64
// reference as the plain float32 versions. The backward splits in
// registers as its fragments load; the forward splits each landed k and
// v tile once for the block into hi and lo planes (its eight warps all
// read every tile, so that is an eighth of the splits). bfloat16: one
// bf16 product. dk and dv sum over the group in registers: no atomics,
// the same bits on every run. The walked tiles (k and v for the forward
// and dq; q, do, lse and delta for dk/dv) are double-buffered: 16-byte
// cp.async copies of tile j+1 are in flight while tile j is computed
// (commit/wait groups, no mbarrier, so a wait cannot hang). Tiles keep
// their input type in shared memory with rows padded by 16 bytes, which
// makes every fragment load conflict-free. Under causal the blocks with
// the most live tiles start first: the row tile is the slowest-varying
// part of a flat block id, reversed for the forward and dq (the last
// query tiles see the most keys) and in order for dk/dv (the first key
// tiles are seen the most).
//
// Tiles and residency (D = 64, the training shape; -Xptxas -v and the
// shared-memory sizes below, H100). Forward: blocks of 128 query rows (8
// warps); float32 walks 32-key tiles, 128 registers a thread (a launch
// bound of two blocks an SM; ptxas spills 76 bytes), 87,296 bytes of
// shared memory; bfloat16 walks 64-key tiles, 128 registers, no spill,
// 55,808 bytes; 2 blocks (16 warps) an SM, 768 blocks (2.9 waves on 132
// SMs). Timed on the card (tools/torch_flash_tiles.py) against 64-row
// blocks, 64-key float32 and 32-key bfloat16 walks, three tiles in
// flight, splitting per warp and splitting q once too: float32's split
// planes gain about a tenth over the per-warp split, bfloat16's 64-key
// walks about an eighth, the rest is equal or slower. dq: blocks of 128
// query rows walk 32-key tiles; 128 registers (a launch bound of two
// blocks an SM; ptxas spills under 100 bytes), 104,704 bytes, 2 blocks
// an SM, 768 blocks. dk/dv: blocks of 64 key rows (4 warps) walk 32-query
// tiles; 255 registers, 70,144 bytes, 2 blocks (8 warps) an SM, held by
// registers, 512 blocks (1.9 waves). Capping dk/dv at 168 registers for a
// third block spilled and ran slower; without ldmatrix the 128-row dq
// needs more than 128 registers and one block fits. D = 128 and 256 (off
// the training path) take 64- and 32-row blocks (the forward's float32
// walks 16 keys at D = 256, to stay inside a block's 227 KB) and spill
// some registers; D = 256 dk/dv runs two passes. What bounds them here:
// latency, not the tensor cores' rate (a fifth to a sixth of the 3xTF32
// bound at the training shape). Few warps an SM hide the mma.sync and
// ldmatrix latencies, and each float32 step also spends CUDA-core work on
// the split (three operations an operand element) and the rounded add.
//
// Left for a later change: wgmma and TMA (wgmma takes TF32 only K-major,
// and three of the four backward products want a transposed operand), a
// fused backward with dq summed by atomics (saves one recompute, gives up
// determinism), delta folded into a kernel.
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
  const int* seg;    // (B, T) int32 segment ids of packed rows, or null
  const int* seeds;  // (B, H) int32 dropout seeds; read when dropout_p > 0
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int B, Tq, Tk, H, Hkv, D;
  int causal;
  int window;  // <= 0: no window
  float scale;
  float dropout_p;      // 0: no dropout
  float dropout_scale;  // 1 / (1 - dropout_p), rounded to float32
};

}  // extern "C"

namespace {

constexpr int kSeqStep = 64;  // Tq and Tk are multiples of this
constexpr float kNegInf = -1e30f;
constexpr float kDead = -5e29f;

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

// The dropout keep decision of the TPU kernels' counter-based hash
// (_dropout_keep) for query position `row` and key `col` under `seed`, bit
// for bit: the int32 products wrap there, so they are taken in uint32 here
// (signed overflow is undefined in C++), the shifts are arithmetic on the
// int32, and u = (x & 0x7fffffff) * 2^-31 is compared in float32.
__device__ __forceinline__ uint32_t xsr(uint32_t x, int k) {
  return x ^ (uint32_t)((int)x >> k);
}
__device__ __forceinline__ bool dropout_keep(int seed, int row, int col,
                                             float p) {
  uint32_t x = (uint32_t)row * 0x9E3779B9u + (uint32_t)seed;
  x = xsr(x, 16);
  x *= 0x85EBCA77u;
  x = xsr(x, 13);
  x += (uint32_t)col * 0xC2B2AE3Du;
  x = xsr(x, 16);
  x *= 0xBD4286FFu;
  x = xsr(x, 15);
  x *= 0x9E3779B9u;
  x = xsr(x, 16);
  const float u = (float)(int)(x & 0x7fffffffu) * (1.0f / 2147483648.0f);
  return u >= p;
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

// ----- tensor-core building blocks ----------------------------------------

// Tile shapes of the forward, by input type and head_dim: the query rows
// a block owns (16 per warp), the width of the key tiles it walks, the
// blocks an SM its launch bound asks for (two 256-thread blocks at D = 64
// hold it at 128 registers a thread) and the key tiles in shared memory
// at once (one computed while the next loads). At D = 64 it is dq's block
// (see BwdTiles); bfloat16 walks 64 keys, float32 32, since its split
// planes (see flash_fwd_kernel) at 64 would leave one block an SM, and 16
// at D = 256 keeps float32 under the 227 KB a block can have.
template <typename T, int D>
struct FwdTiles {
  static constexpr int rows = D == 256 ? 32 : D == 64 ? 128 : 64;
  static constexpr int walk = D == 256 ? 16 : sizeof(T) == 2 ? 64 : 32;
  static constexpr int blocks = D == 64 ? 2 : 1;
  static constexpr int stages = 2;
};

// Tile shapes of the backward kernels, by head_dim: the rows a block owns
// (16 per warp), the width of the tiles it walks, and the passes over
// them (D = 256 accumulates dv, then dk, in two passes: both at once would
// need 256 accumulator registers a thread). The D = 64 shapes were timed
// on the card against 64-row dq blocks and 16- and 64-wide walks.
template <int D>
struct BwdTiles {
  static constexpr int dq_rows = D == 256 ? 32 : D == 64 ? 128 : 64;
  static constexpr int dkv_rows = D == 256 ? 32 : 64;
  static constexpr int dq_walk = 32;
  // the dq launch bound's blocks an SM: two 256-thread blocks at D = 64
  // need at most 128 registers a thread
  static constexpr int dq_blocks = D == 64 ? 2 : 1;
  static constexpr int dkv_walk = 32;
  static constexpr int passes = D == 256 ? 2 : 1;
};

// Tiles in shared memory keep their input type, rows padded by 16 bytes
// (D + 4 floats, D + 8 bfloat16): every fragment load below, whether it
// walks a tile along its rows or down its columns, then hits 32 banks.
template <typename T, int D>
__host__ __device__ constexpr int padded() {
  return D + 16 / (int)sizeof(T);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each, row
// addresses from lanes 8m..8m+7 for matrix m); lane 4r+c gets row r's
// 32-bit word c of each (.trans: the transposed 8x8 of 16-bit elements)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// rows x D elements of a (B, T, heads, D) tensor, from element `base`
// with row stride `rs`, into a padded tile: 16-byte cp.async copies, the
// caller commits. The wrapper guarantees 16-byte aligned rows.
template <typename T, int D, int NT>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src,
                                                long long base, long long rs,
                                                int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int LD = padded<T, D>();
  for (int i = threadIdx.x; i < rows * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    cp_async16(dst + r * LD + c, src + base + r * rs + c);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits16(__float2bfloat16(lo)) | (bits16(__float2bfloat16(hi)) << 16);
}

// Per-lane offsets (in 16-byte units: row, column) of the ldmatrix row
// addresses: an A fragment (16 x K: rows 0-7 / 8-15 by lane bit 3, the
// K halves by lane bit 4), and a pair of B fragments stored n-major (8n x
// K: n-tiles by lane bit 4, K halves by lane bit 3).
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}

// One warp-wide product step D(16x8) += A(16xK) . B(Kx8) on the tensor
// cores, with the fragment layouts of mma.sync: lane = 4 * gr + tg holds
// accumulator entries (gr, 2tg), (gr, 2tg+1), (gr+8, 2tg), (gr+8, 2tg+1).
//
// float32: "3xTF32". Each operand x is split as hi = tf32(x), lo =
// tf32(x - hi), and lo.hi + hi.lo + hi.hi go into a float32 accumulator
// through three m16n8k8 TF32 products. hi and lo carry 22 of float32's
// 24 significand bits, so a product is exact to ~2^-22 relative where one
// TF32 pass keeps ~2^-11 (three decimal digits): the float32 result, at a
// third of the TF32 rate. The split is made at fragment load, in
// registers, so tiles stay single float32 copies in shared memory.
// bfloat16: one m16n8k16 product on bf16 operands.
//
// step() sums the step's passes in a zeroed fragment and adds that to
// the product's sum with a rounded float32 add; every product takes it.
// The tensor cores add into a float32 accumulator after aligning to its
// exponent and truncating, so mma() straight into a sum drifts by up to
// an ulp of the sum per pass: on the card that left dv past the 1e-4
// tolerance over a walk of 3072 query rows, and the scores' D/8 steps
// alone put dq, and dk at D = 256, several times further from a float64
// reference than the plain float32 version (tools/torch_flash_accuracy.py
// measures the pair against float64).
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int K = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = tf32(__uint_as_float(x));
    lo = tf32(__uint_as_float(x) - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A a(uint32_t x0, uint32_t x1,
                                        uint32_t x2, uint32_t x3) {
    A r;
    split(x0, r.hi[0], r.lo[0]);
    split(x1, r.hi[1], r.lo[1]);
    split(x2, r.hi[2], r.lo[2]);
    split(x3, r.hi[3], r.lo[3]);
    return r;
  }
  static __device__ __forceinline__ B b(uint32_t x0, uint32_t x1) {
    B r;
    split(x0, r.hi[0], r.lo[0]);
    split(x1, r.hi[1], r.lo[1]);
    return r;
  }
  static __device__ __forceinline__ void pass(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    pass(c, a.lo, b.hi);
    pass(c, a.hi, b.lo);
    pass(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ void step(float (&c)[4], const A& a,
                                              const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma(t, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
  static __device__ __forceinline__ uint32_t u32(const float* p) {
    return __float_as_uint(*p);
  }
  // A(16x8) from the tile whose row (a_row(lane), k half lane >> 4)
  // this lane's p points at (k contiguous)
  static __device__ __forceinline__ A load_a(const float* p) {
    uint32_t r[4];
    ldsm4(r, p);
    return a(r[0], r[1], r[2], r[3]);
  }
  // B(8x8) of n-tiles 0 and 1 with B(k, n) = s[n * ld + k]; this lane's p
  // points at row b_row(lane), k half (lane >> 3) & 1
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1,
                                                   const float* p) {
    uint32_t r[4];
    ldsm4(r, p);
    b0 = b(r[0], r[1]);
    b1 = b(r[2], r[3]);
  }
  // B(8x8) of n-tiles 0 and 1 with B(k, n) = s[k * ld + n], the k order
  // permuted (slot tg is row 2tg, slot tg+4 row 2tg+1) to match a_from_c;
  // 32-bit elements have no ldmatrix transpose, so plain loads from the
  // tile's corner s
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1,
                                                   const float* s,
                                                   const float* p, int ld,
                                                   int lane) {
    const float* q = s + 2 * (lane & 3) * ld + (lane >> 2);
    b0 = b(u32(q), u32(q + ld));
    b1 = b(u32(q + 8), u32(q + ld + 8));
  }
  // the accumulator tile j (16x8) of a product read as the A operand of
  // the next: the entries stay in their lanes, k permuted as above
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4],
                                               int j) {
    return a(__float_as_uint(c[j][0]), __float_as_uint(c[j][2]),
             __float_as_uint(c[j][1]), __float_as_uint(c[j][3]));
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]),
          "r"(b.x[0]), "r"(b.x[1]));
  }
  // one product per step: the drift of a long walk stays far below a
  // bfloat16 rounding
  static __device__ __forceinline__ void step(float (&c)[4], const A& a,
                                              const B& b) {
    mma(c, a, b);
  }
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* p) {
    A r;
    ldsm4(r.x, p);
    return r;
  }
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1,
                                                   const __nv_bfloat16* p) {
    uint32_t r[4];
    ldsm4(r, p);
    b0.x[0] = r[0], b0.x[1] = r[1], b1.x[0] = r[2], b1.x[1] = r[3];
  }
  // this lane's p points at row a_row(lane), n half lane >> 4: the
  // transposed ldmatrix gives the pairs down the columns
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1,
                                                   const __nv_bfloat16* s,
                                                   const __nv_bfloat16* p,
                                                   int ld, int lane) {
    uint32_t r[4];
    ldsm4_t(r, p);
    b0.x[0] = r[0], b0.x[1] = r[1], b1.x[0] = r[2], b1.x[1] = r[3];
  }
  // accumulator tiles 2j and 2j+1 as A(16x16), rounded to bfloat16 (the
  // TPU kernels' cast of p and ds)
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4],
                                               int j) {
    A r;
    r.x[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    r.x[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    r.x[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    r.x[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
    return r;
  }
};

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Whether every entry of query positions [p0, p1] x keys [c0, c1] is
// live: the live set is an intersection of half-planes, so its corners
// decide. A key-padding mask and segment ids are checked per entry (with
// either, no tile counts as full: packed rows would otherwise attend
// across documents).
__device__ __forceinline__ bool tile_full(const FlashArgs& a, int p0, int p1,
                                          int c0, int c1) {
  return !a.kv_mask && !a.seg && keep(p0, c0, a.causal, a.window) &&
         keep(p0, c1, a.causal, a.window) &&
         keep(p1, c0, a.causal, a.window) && keep(p1, c1, a.causal, a.window);
}

// S(16 x 8*NS) = X(16 x D) . Y(8*NS x D)^T for one warp's 16 rows: X's
// rows at xs, Y's at ys, both padded tiles.
template <typename T, int D, int NS>
__device__ __forceinline__ void product_nt(float (&s)[NS][4], const T* xs,
                                           const T* ys, int lane) {
  using M = Mma<T>;
  constexpr int LD = padded<T, D>(), V = 16 / sizeof(T);
  const T* xp = xs + a_row(lane) * LD + (lane >> 4) * V;
  const T* yp = ys + b_row(lane) * LD + ((lane >> 3) & 1) * V;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += M::K) {
    const typename M::A xa = M::load_a(xp + kk);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      typename M::B b0, b1;
      M::load_b_nk(b0, b1, yp + n * 8 * LD + kk);
      M::step(s[n], xa, b0);
      M::step(s[n + 1], xa, b1);
    }
  }
}

// acc(16 x D) += P(16 x 8*NS) . Y(8*NS x D), P in accumulator fragments,
// Y's rows (the walked tile) at ys.
template <typename T, int D, int NS>
__device__ __forceinline__ void product_acc(float (&acc)[D / 8][4],
                                            const float (&p)[NS][4],
                                            const T* ys, int lane) {
  using M = Mma<T>;
  constexpr int LD = padded<T, D>(), V = 16 / sizeof(T);
  const T* yp = ys + a_row(lane) * LD + (lane >> 4) * V;
#pragma unroll
  for (int j = 0; j < NS * 8 / M::K; ++j) {
    const typename M::A pa = M::template a_from_c<NS>(p, j);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      typename M::B b0, b1;
      M::load_b_kn(b0, b1, ys + j * M::K * LD + n * 8,
                   yp + j * M::K * LD + n * 8, LD, lane);
      M::step(acc[n], pa, b0);
      M::step(acc[n + 1], pa, b1);
    }
  }
}

// ----- forward ------------------------------------------------------------

// float32 only: x (rows x D, padded rows) overwritten with its TF32 hi
// parts and its lo parts written to lo, by the block's NT threads, four
// entries a thread at a time
template <int D, int NT>
__device__ __forceinline__ void split_planes(float* x, float* lo, int rows) {
  constexpr int LD = padded<float, D>(), V = D / 4;
  for (int i = threadIdx.x; i < rows * V; i += NT) {
    const int r = i / V, c = (i - r * V) * 4;
    float4* px = reinterpret_cast<float4*>(x + r * LD + c);
    float4 h = *px, l;
    uint32_t hi, lw;
    Mma<float>::split(__float_as_uint(h.x), hi, lw);
    h.x = __uint_as_float(hi), l.x = __uint_as_float(lw);
    Mma<float>::split(__float_as_uint(h.y), hi, lw);
    h.y = __uint_as_float(hi), l.y = __uint_as_float(lw);
    Mma<float>::split(__float_as_uint(h.z), hi, lw);
    h.z = __uint_as_float(hi), l.z = __uint_as_float(lw);
    Mma<float>::split(__float_as_uint(h.w), hi, lw);
    h.w = __uint_as_float(hi), l.w = __uint_as_float(lw);
    *px = h;
    *reinterpret_cast<float4*>(lo + r * LD + c) = l;
  }
}

// product_nt for float32 with Y already split into hi and lo planes (yh,
// yl; same layout): the B fragments load split
template <int D, int NS>
__device__ __forceinline__ void product_nt_planes(float (&s)[NS][4],
                                                  const float* xs,
                                                  const float* yh,
                                                  const float* yl, int lane) {
  using M = Mma<float>;
  constexpr int LD = padded<float, D>();
  const float* xp = xs + a_row(lane) * LD + (lane >> 4) * 4;
  const int yo = b_row(lane) * LD + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += M::K) {
    const M::A xa = M::load_a(xp + kk);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t h[4], l[4];
      ldsm4(h, yh + yo + n * 8 * LD + kk);
      ldsm4(l, yl + yo + n * 8 * LD + kk);
      const M::B b0 = {{h[0], h[1]}, {l[0], l[1]}};
      const M::B b1 = {{h[2], h[3]}, {l[2], l[3]}};
      M::step(s[n], xa, b0);
      M::step(s[n + 1], xa, b1);
    }
  }
}

// product_acc for float32 with Y split into hi and lo planes, B loaded
// as load_b_kn does
template <int D, int NS>
__device__ __forceinline__ void product_acc_planes(float (&acc)[D / 8][4],
                                                   const float (&p)[NS][4],
                                                   const float* yh,
                                                   const float* yl,
                                                   int lane) {
  using M = Mma<float>;
  constexpr int LD = padded<float, D>();
  const int yo = 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const M::A pa = M::template a_from_c<NS>(p, j);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      const float* qh = yh + j * 8 * LD + n * 8 + yo;
      const float* ql = yl + j * 8 * LD + n * 8 + yo;
      const M::B b0 = {{M::u32(qh), M::u32(qh + LD)},
                       {M::u32(ql), M::u32(ql + LD)}};
      const M::B b1 = {{M::u32(qh + 8), M::u32(qh + LD + 8)},
                       {M::u32(ql + 8), M::u32(ql + LD + 8)}};
      M::step(acc[n], pa, b0);
      M::step(acc[n + 1], pa, b1);
    }
  }
}

template <typename T, int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  using F = FwdTiles<T, D>;
  constexpr int LD = padded<T, D>();
  return sizeof(T) * (F::rows + 2 * F::stages * F::walk) * LD +
         2 * F::stages * F::walk * 4 +  // key mask and segment ids
         (sizeof(T) == 4 ? 2 * F::walk * LD * 4 : 0);  // lo planes
}

// One block per (b, h, BR query rows), 16 rows a warp: dq's block with an
// online softmax where dq makes ds. It walks the live key tiles (KT keys
// each), S - 1 in flight while one is computed. s = q.k^T lands in
// accumulator fragments, where each lane holds two rows' entries (rows gr
// and gr + 8 of its warp's 16) and the four lanes of a quad share a row:
// the running max m reduces over the quad with two shuffles per tile, and
// each lane keeps its own part of the running sum l (each tile's p
// summed, then added with a compensated add), reduced once at the end.
// p = exp(s - m) replaces s in the same registers, acc and l are
// rescaled by exp(m_old - m_new), and acc += p.v reads p as the A operand
// straight from those registers. float32 splits each landed k and v tile
// into TF32 hi and lo once for the block (hi in place, lo to one more k
// and v tile), where the backward's warps each split as they load: eight
// warps read every k and v tile, so this does an eighth of the splits.
template <typename T, int D, bool kOpt>
__global__ void __launch_bounds__(FwdTiles<T, D>::rows * 2,
                                  FwdTiles<T, D>::blocks)
    flash_fwd_kernel(FlashArgs a) {
  using F = FwdTiles<T, D>;
  constexpr int BR = F::rows, KT = F::walk, S = F::stages;
  constexpr int NT = BR * 2, LD = padded<T, D>(), NS = KT / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* q_s = reinterpret_cast<T*>(fwd_smem);  // BR x LD
  T* k_s = q_s + BR * LD;                   // S x KT x LD
  T* v_s = k_s + S * KT * LD;               // S x KT x LD
  float* km_s = reinterpret_cast<float*>(v_s + S * KT * LD);  // S x KT
  int* sg_s = reinterpret_cast<int*>(km_s + S * KT);           // S x KT
  // float32: lo planes, KT x LD each
  float* kl_s = reinterpret_cast<float*>(sg_s + S * KT);
  float* vl_s = kl_s + KT * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the options, compiled out of the instances that run without them
  const int* seg = kOpt ? a.seg : nullptr;
  const int gr = lane >> 2, tg = lane & 3;
  // longest blocks first, as in dq: under causal the last query tiles
  // see the most keys
  const int hb = a.H * a.B;
  int tile = blockIdx.x / hb;
  const int h = (blockIdx.x - tile * hb) % a.H;
  const int b = (blockIdx.x - tile * hb) / a.H;
  if (a.causal) tile = (a.Tq + BR - 1) / BR - 1 - tile;
  const int r0 = tile * BR;
  // Tq is a multiple of 64, not always of BR: the rows of a short last
  // tile past Tq are zeros in shared memory, computed on and not stored
  const int rows = min(BR, a.Tq - r0);
  const int hk = h / (a.H / a.Hkv);
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  copy_rows_async<T, D, NT>(q_s, q, b * a.q_sb + r0 * a.q_st + h * a.q_sh,
                            a.q_st, rows);
  for (int i = rows * LD + threadIdx.x; i < BR * LD; i += NT) st(q_s + i, 0.f);
  int j_lo, j_hi;
  key_tiles(a, r0, r0 + rows - 1, KT, &j_lo, &j_hi);
  auto fetch = [&](int j, int buf) {
    const int c0 = j * KT;
    copy_rows_async<T, D, NT>(k_s + buf * KT * LD, k,
                              b * a.k_sb + c0 * a.k_st + hk * a.k_sh, a.k_st,
                              KT);
    copy_rows_async<T, D, NT>(v_s + buf * KT * LD, v,
                              b * a.v_sb + c0 * a.v_st + hk * a.v_sh, a.v_st,
                              KT);
    if (a.kv_mask)
      for (int i = threadIdx.x; i < KT; i += NT)
        km_s[buf * KT + i] = (float)a.kv_mask[(long long)b * a.Tk + c0 + i];
    if (seg)
      for (int i = threadIdx.x; i < KT; i += NT)
        sg_s[buf * KT + i] = seg[(long long)b * a.Tk + c0 + i];
  };
  // S - 1 tiles in flight ahead of the one computed (q lands with the
  // first group)
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (j_lo + i <= j_hi) fetch(j_lo + i, i);
    cp_async_commit();
  }

  // this lane's two rows: warp * 16 + gr and + 8, their segments, and the
  // dropout seed of (b, h)
  const int rl = warp * 16 + gr;
  int qseg[2] = {0, 0};
  if (seg)
    for (int i = 0; i < 2; ++i)
      qseg[i] = seg[(long long)b * a.Tq + min(r0 + rl + 8 * i, a.Tq - 1)];
  const bool drop = kOpt && a.dropout_p > 0.f;
  const int seed = drop ? a.seeds[b * a.H + h] : 0;
  // A row with no live key
  // so far keeps m = -1e30: its p are 0 and its rescale exp(0) = 1, so
  // acc and l stay 0 until a live key arrives (then the rescale is 0).
  // Each tile's p add into l as one sum, compensated (lc holds the
  // rounding error, Kahan's way): lse feeds the backward's p, and a long
  // row adds thousands of p into l.
  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f},
                       lc[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    cp_async_wait<S - 2>();  // tile j (and q) have landed
    // ... for every thread, and every warp is done with tile j - 1,
    // whose buffer (and lo planes) are rewritten next
    __syncthreads();
    if (j + S - 1 <= j_hi) fetch(j + S - 1, (j + S - 1 - j_lo) % S);
    cp_async_commit();
    const int buf = (j - j_lo) % S, c0 = j * KT;
    T* ks = k_s + buf * KT * LD;
    T* vs = v_s + buf * KT * LD;

    float s[NS][4];
    if constexpr (kSplit) {
      split_planes<D, NT>(ks, kl_s, KT);
      split_planes<D, NT>(vs, vl_s, KT);
      __syncthreads();
      product_nt_planes<D, NS>(s, q_s + warp * 16 * LD, ks, kl_s, lane);
    } else {
      product_nt<T, D, NS>(s, q_s + warp * 16 * LD, ks, lane);
    }
    const int p0 = r0 + warp * 16 + off;
    const bool full = tile_full(a, p0, p0 + 15, c0, c0 + KT - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = n * 8 + 2 * tg + (e & 1);
        float x = s[n][e] * a.scale;
        if (!full && (!keep(p0 + gr + 8 * i, c0 + cl, a.causal, a.window) ||
                      (a.kv_mask && km_s[buf * KT + cl] == 0.f) ||
                      (seg && sg_s[buf * KT + cl] != qseg[i])))
          x = kNegInf;
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float ts[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = s[n][e] <= kDead ? 0.f : expf(s[n][e] - m[i]);
        // l sums the undropped p; p.v takes the dropped ones, scaled (and,
        // in bfloat16, rounded after the scaling, as a_from_c reads them)
        ts[i] += p;
        s[n][e] = !drop ? p
                  : dropout_keep(seed, p0 + gr + 8 * i,
                                 c0 + n * 8 + 2 * tg + (e & 1), a.dropout_p)
                      ? p * a.dropout_scale
                      : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] *= alpha[i];
      lc[i] *= alpha[i];
      const float y = ts[i] - lc[i];
      const float t = l[i] + y;
      lc[i] = (t - l[i]) - y;
      l[i] = t;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    if constexpr (kSplit)
      product_acc_planes<D, NS>(acc, s, vs, vl_s, lane);
    else
      product_acc<T, D, NS>(acc, s, vs, lane);
  }
  cp_async_wait<0>();  // a block with no live tile leaves nothing in flight

  if (warp * 16 >= rows) return;
  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] -= lc[i];
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lv = l[i] == 0.f ? 1.f : l[i];
    const int r = r0 + rl + 8 * i;
    T* orow = o + (((long long)b * a.Tq + r) * a.H + h) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      st2(orow + n * 8, acc[n][2 * i] / lv, acc[n][2 * i + 1] / lv);
    if (tg == 0)
      a.lse_out[((long long)b * a.H + h) * a.Tq + r] =
          m[i] + logf(fmaxf(lv, 1e-37f));
  }
}

// ----- dq -----------------------------------------------------------------

template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  constexpr int BR = BwdTiles<D>::dq_rows, KT = BwdTiles<D>::dq_walk;
  return sizeof(T) * (2 * BR + 4 * KT) * padded<T, D>() + 4 * KT * 4;
}

// One block per (b, h, BR query rows), 16 rows a warp. It walks the live
// key tiles (KT keys each) double-buffered: while tile j is computed,
// tile j+1 is in flight. s = q.k^T and dp = do.v^T land in accumulator
// fragments; p and ds are made there on the CUDA cores; dq += ds.k reads
// ds straight from those registers.
template <typename T, int D, bool kOpt>
__global__ void __launch_bounds__(BwdTiles<D>::dq_rows * 2,
                                  BwdTiles<D>::dq_blocks)
    flash_dq_kernel(FlashArgs a) {
  constexpr int BR = BwdTiles<D>::dq_rows, KT = BwdTiles<D>::dq_walk;
  constexpr int NT = BR * 2, LD = padded<T, D>(), NS = KT / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* q_s = reinterpret_cast<T*>(bwd_smem);  // BR x LD
  T* do_s = q_s + BR * LD;              // BR x LD
  T* k_s = do_s + BR * LD;              // 2 x KT x LD
  T* v_s = k_s + 2 * KT * LD;           // 2 x KT x LD
  float* km_s = reinterpret_cast<float*>(v_s + 2 * KT * LD);  // 2 x KT
  int* sg_s = reinterpret_cast<int*>(km_s + 2 * KT);           // 2 x KT

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the options, compiled out of the instances that run without them
  const int* seg = kOpt ? a.seg : nullptr;
  const int gr = lane >> 2, tg = lane & 3;
  // longest blocks first: the tile index is the slowest-varying part of
  // the block id, and under causal the last query tiles see the most keys
  const int hb = a.H * a.B;
  int tile = blockIdx.x / hb;
  const int h = (blockIdx.x - tile * hb) % a.H;
  const int b = (blockIdx.x - tile * hb) / a.H;
  if (a.causal) tile = (a.Tq + BR - 1) / BR - 1 - tile;
  const int r0 = tile * BR;
  // Tq is a multiple of 64, not always of BR: the last tile may hold
  // fewer rows (a multiple of 16). The rows past Tq are zeros in shared
  // memory; their warps compute on them like the others and store nothing.
  const int rows = min(BR, a.Tq - r0);
  const int hk = h / (a.H / a.Hkv);
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  copy_rows_async<T, D, NT>(q_s, q, b * a.q_sb + r0 * a.q_st + h * a.q_sh,
                            a.q_st, rows);
  copy_rows_async<T, D, NT>(do_s, dout,
                            b * a.do_sb + r0 * a.do_st + h * a.do_sh,
                            a.do_st, rows);
  for (int i = rows * LD + threadIdx.x; i < BR * LD; i += NT) {
    st(q_s + i, 0.f);
    st(do_s + i, 0.f);
  }
  int j_lo, j_hi;
  key_tiles(a, r0, r0 + rows - 1, KT, &j_lo, &j_hi);
  auto fetch = [&](int j, int buf) {
    const int c0 = j * KT;
    copy_rows_async<T, D, NT>(k_s + buf * KT * LD, k,
                              b * a.k_sb + c0 * a.k_st + hk * a.k_sh, a.k_st,
                              KT);
    copy_rows_async<T, D, NT>(v_s + buf * KT * LD, v,
                              b * a.v_sb + c0 * a.v_st + hk * a.v_sh, a.v_st,
                              KT);
    if (a.kv_mask)
      for (int i = threadIdx.x; i < KT; i += NT)
        km_s[buf * KT + i] = (float)a.kv_mask[(long long)b * a.Tk + c0 + i];
    if (seg)
      for (int i = threadIdx.x; i < KT; i += NT)
        sg_s[buf * KT + i] = seg[(long long)b * a.Tk + c0 + i];
  };
  if (j_lo <= j_hi) fetch(j_lo, 0);
  cp_async_commit();

  // this lane's two rows: warp * 16 + gr and + 8, their segments, and the
  // dropout seed of (b, h)
  const int rl = warp * 16 + gr;
  float lse[2], delta[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = min(r0 + rl + 8 * i, a.Tq - 1);
    const long long row = ((long long)b * a.H + h) * a.Tq + r;
    lse[i] = a.lse[row];
    delta[i] = a.delta[row];
    if (seg) qseg[i] = seg[(long long)b * a.Tq + r];
  }
  const bool drop = kOpt && a.dropout_p > 0.f;
  const int seed = drop ? a.seeds[b * a.H + h] : 0;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j < j_hi) fetch(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q, do) have landed
    __syncthreads();
    const T* ks = k_s + buf * KT * LD;
    const int c0 = j * KT;

    float s[NS][4], dp[NS][4];
    product_nt<T, D, NS>(s, q_s + warp * 16 * LD, ks, lane);
    product_nt<T, D, NS>(dp, do_s + warp * 16 * LD, v_s + buf * KT * LD,
                         lane);
    const int p0 = r0 + warp * 16 + off;
    const bool full = tile_full(a, p0, p0 + 15, c0, c0 + KT - 1);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, cl = n * 8 + 2 * tg + (e & 1);
        float x = s[n][e] * a.scale;
        if (!full && (!keep(p0 + gr + 8 * i, c0 + cl, a.causal, a.window) ||
                      (a.kv_mask && km_s[buf * KT + cl] == 0.f) ||
                      (seg && sg_s[buf * KT + cl] != qseg[i])))
          x = kNegInf;
        const float p = x <= kDead ? 0.f : expf(x - lse[i]);
        // dp dropped as the forward dropped p: o = (keep * p / (1 - p)).v
        float d = dp[n][e];
        if (drop)
          d = dropout_keep(seed, p0 + gr + 8 * i, c0 + cl, a.dropout_p)
                  ? d * a.dropout_scale
                  : 0.f;
        s[n][e] = rnd<T>(p * (d - delta[i]) * a.scale);  // ds
      }
    product_acc<T, D, NS>(acc, s, ks, lane);
    __syncthreads();  // buf is refilled by the next iteration but one
  }
  cp_async_wait<0>();  // a block with no live tile leaves nothing in flight

  if (warp * 16 >= rows) return;
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* o = dq + (((long long)b * a.Tq + r0 + rl + 8 * i) * a.H + h) * D +
           2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      st2(o + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ----- dk, dv -------------------------------------------------------------

template <typename T, int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  constexpr int BC = BwdTiles<D>::dkv_rows, QT = BwdTiles<D>::dkv_walk;
  return sizeof(T) * (2 * BC + 4 * QT) * padded<T, D>() + 6 * QT * 4;
}

// One block per (b, kv head, BC key rows), 16 key rows a warp. It walks
// the G query heads of the group and, for each, the live query tiles (QT
// rows each), double-buffered with their lse and delta. s^T = k.q^T and
// dp^T = v.do^T land in accumulator fragments, p^T and ds^T are made
// there, and dv += p^T.do and dk += ds^T.q read them from the registers.
// dk and dv are summed over the group in registers: no atomics, and the
// same order on every run.
template <typename T, int D, bool kOpt>
__global__ void __launch_bounds__(BwdTiles<D>::dkv_rows * 2, 1)
    flash_dkv_kernel(FlashArgs a) {
  constexpr int BC = BwdTiles<D>::dkv_rows, QT = BwdTiles<D>::dkv_walk;
  constexpr int NT = BC * 2, LD = padded<T, D>(), NS = QT / 8;
  constexpr int NPASS = BwdTiles<D>::passes;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* k_s = reinterpret_cast<T*>(bwd_smem);  // BC x LD (this block's keys)
  T* v_s = k_s + BC * LD;               // BC x LD
  T* q_s = v_s + BC * LD;               // 2 x QT x LD (walked query rows)
  T* do_s = q_s + 2 * QT * LD;          // 2 x QT x LD
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * QT * LD);  // 2 x QT
  float* delta_s = lse_s + 2 * QT;                              // 2 x QT
  int* qsg_s = reinterpret_cast<int*>(delta_s + 2 * QT);         // 2 x QT

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the options, compiled out of the instances that run without them
  const int* seg = kOpt ? a.seg : nullptr;
  const int gr = lane >> 2, tg = lane & 3;
  // longest blocks first: under causal the first key tiles are seen by
  // the most query rows, and the tile is the slowest part of the block id
  const int hb = a.Hkv * a.B;
  const int tile = blockIdx.x / hb;
  const int hk = (blockIdx.x - tile * hb) % a.Hkv;
  const int b = (blockIdx.x - tile * hb) / a.Hkv;
  const int c0 = tile * BC;
  const int G = a.H / a.Hkv;
  const int off = a.Tk - a.Tq;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  copy_rows_async<T, D, NT>(k_s, k, b * a.k_sb + c0 * a.k_st + hk * a.k_sh,
                            a.k_st, BC);
  copy_rows_async<T, D, NT>(v_s, v, b * a.v_sb + c0 * a.v_st + hk * a.v_sh,
                            a.v_st, BC);
  // this lane's two key rows: warp * 16 + gr and + 8
  const int kl = warp * 16 + gr;
  bool kmask[2];
  int kseg[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kmask[i] = !a.kv_mask ||
               a.kv_mask[(long long)b * a.Tk + c0 + kl + 8 * i] != 0;
    if (seg) kseg[i] = seg[(long long)b * a.Tk + c0 + kl + 8 * i];
  }
  const bool drop = kOpt && a.dropout_p > 0.f;
  int i_lo, i_hi;
  query_tiles(a, c0, c0 + BC - 1, QT, &i_lo, &i_hi);
  const int nq = i_hi - i_lo + 1;
  const int steps = nq > 0 ? G * nq : 0;
  // step -> (query head h, first query row r0)
  auto fetch = [&](int step, int buf) {
    const int gg = step / nq;
    const int h = hk * G + gg;
    const int r0 = (i_lo + step - gg * nq) * QT;
    copy_rows_async<T, D, NT>(q_s + buf * QT * LD, q,
                              b * a.q_sb + r0 * a.q_st + h * a.q_sh, a.q_st,
                              QT);
    copy_rows_async<T, D, NT>(do_s + buf * QT * LD, dout,
                              b * a.do_sb + r0 * a.do_st + h * a.do_sh,
                              a.do_st, QT);
    const long long row = ((long long)b * a.H + h) * a.Tq + r0;
    for (int i = threadIdx.x; i < QT; i += NT) {
      cp_async4(lse_s + buf * QT + i, a.lse + row + i);
      cp_async4(delta_s + buf * QT + i, a.delta + row + i);
      if (seg)
        cp_async4(qsg_s + buf * QT + i, seg + (long long)b * a.Tq + r0 + i);
    }
  };

  // acc[0] is dv; acc[NACC - 1] is dk (the same array with two passes)
  constexpr int NACC = NPASS == 1 ? 2 : 1;
  float acc[NACC][D / 8][4];
  T* dk_o = static_cast<T*>(a.dk);
  T* dv_o = static_cast<T*>(a.dv);
#pragma unroll
  for (int pass = 0; pass < NPASS; ++pass) {
    const bool want_dv = NPASS == 1 || pass == 0;
    const bool want_dk = NPASS == 1 || pass == 1;
#pragma unroll
    for (int x = 0; x < NACC; ++x)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        acc[x][n][0] = acc[x][n][1] = acc[x][n][2] = acc[x][n][3] = 0.f;
    if (steps > 0) fetch(0, 0);
    cp_async_commit();

    for (int step = 0; step < steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < steps) fetch(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this step's tiles (and k, v) have landed
      __syncthreads();
      const T* qs = q_s + buf * QT * LD;
      const T* dos = do_s + buf * QT * LD;
      const float* lses = lse_s + buf * QT;
      const float* deltas = delta_s + buf * QT;
      const int* qsegs = qsg_s + buf * QT;
      const int gg = step / nq;
      const int r0 = (i_lo + step - gg * nq) * QT;
      // each query head of the group has its own dropout seed
      const int seed = drop ? a.seeds[b * a.H + hk * G + gg] : 0;

      float s[NS][4], dp[NS][4];
      product_nt<T, D, NS>(s, k_s + warp * 16 * LD, qs, lane);
      if (want_dk)
        product_nt<T, D, NS>(dp, v_s + warp * 16 * LD, dos, lane);
      const int ck = c0 + warp * 16;
      const bool full =
          tile_full(a, r0 + off, r0 + QT - 1 + off, ck, ck + 15);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, ql = n * 8 + 2 * tg + (e & 1);
          float x = s[n][e] * a.scale;
          if (!full && (!keep(r0 + ql + off, ck + gr + 8 * i, a.causal,
                              a.window) ||
                        !kmask[i] || (seg && qsegs[ql] != kseg[i])))
            x = kNegInf;
          const float p = x <= kDead ? 0.f : expf(x - lses[ql]);
          const bool kept =
              !drop || dropout_keep(seed, r0 + ql + off, ck + gr + 8 * i,
                                    a.dropout_p);
          // p^T, dropped for dv += p^T.do
          s[n][e] = !drop ? p : kept ? p * a.dropout_scale : 0.f;
          if (want_dk) {  // ds^T from the undropped p and the dropped dp
            float d = dp[n][e];
            if (drop) d = kept ? d * a.dropout_scale : 0.f;
            dp[n][e] = rnd<T>(p * (d - deltas[ql]) * a.scale);
          }
        }
      if (want_dv) product_acc<T, D, NS>(acc[0], s, dos, lane);
      if (want_dk) product_acc<T, D, NS>(acc[NACC - 1], dp, qs, lane);
      __syncthreads();  // buf is refilled by the next step but one
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long base =
          (((long long)b * a.Tk + c0 + kl + 8 * i) * a.Hkv + hk) * D + 2 * tg;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (want_dv)
          st2(dv_o + base + n * 8, acc[0][n][2 * i], acc[0][n][2 * i + 1]);
        if (want_dk)
          st2(dk_o + base + n * 8, acc[NACC - 1][n][2 * i],
              acc[NACC - 1][n][2 * i + 1]);
      }
    }
  }
}

// ----- launch -------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D, bool kOpt>
int launch(int kind, const FlashArgs& a, cudaStream_t stream) {
  // one flat grid, the row tile slowest (see the kernels); the forward's
  // and dq's last row tile may be short, and Tk is a multiple of every
  // dk/dv tile
  void (*kernel)(FlashArgs);
  size_t smem;
  int rows, tiles;
  if (kind == kFwd) {
    kernel = flash_fwd_kernel<T, D, kOpt>;
    smem = fwd_smem_bytes<T, D>();
    rows = FwdTiles<T, D>::rows;
    tiles = (a.Tq + rows - 1) / rows * a.H;
  } else if (kind == kDq) {
    kernel = flash_dq_kernel<T, D, kOpt>;
    smem = dq_smem_bytes<T, D>();
    rows = BwdTiles<D>::dq_rows;
    tiles = (a.Tq + rows - 1) / rows * a.H;
  } else {
    kernel = flash_dkv_kernel<T, D, kOpt>;
    smem = dkv_smem_bytes<T, D>();
    rows = BwdTiles<D>::dkv_rows;
    tiles = a.Tk / rows * a.Hkv;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles * a.B), dim3(2 * rows), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Segment ids and dropout run in their own instances (kOpt): in the
// others their per-entry work compiles out. As runtime branches in one
// instance they made the option-free bfloat16 kernels 7-25% slower
// (tools/torch_kernel_ab.py --sections flash, H100 SXM at 700 W).
template <typename T, bool kOpt>
int launch_d(int kind, const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 64:
      return launch<T, 64, kOpt>(kind, a, stream);
    case 128:
      return launch<T, 128, kOpt>(kind, a, stream);
    case 256:
      return launch<T, 256, kOpt>(kind, a, stream);
  }
  return -3;
}

template <typename T>
int launch_o(int kind, const FlashArgs& a, cudaStream_t stream) {
  return a.seg || a.dropout_p > 0.f ? launch_d<T, true>(kind, a, stream)
                                    : launch_d<T, false>(kind, a, stream);
}

int dispatch(int kind, int dtype, const FlashArgs* a, void* stream) {
  if (a->B <= 0 || a->Hkv <= 0 || a->H % a->Hkv != 0 || a->Tq % kSeqStep ||
      a->Tk % kSeqStep || a->Tq <= 0 || a->Tk <= 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_o<float>(kind, *a, s);
  if (dtype == 1) return launch_o<__nv_bfloat16>(kind, *a, s);
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
