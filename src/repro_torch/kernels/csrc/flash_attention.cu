// Forward flash attention for Hopper (sm_90a), hand-written in CUDA C++.
//
// Replaces kernels/flash_attention.py flash_attention / _kernel (Pallas) of
// the JAX package.  Built by kernels/_build.py with nvcc into the same shared
// library as dsa_kernels.cu (plain C interface, loaded with ctypes).  Each
// entry point launches on the stream it is given, allocates nothing (the
// wrapper allocates the output with torch.empty) and returns a cudaError_t.
//
// What it computes, for q [B, Sq, H, hd] and k, v [B, Skv, KV, hd] (bf16 or
// f32, contiguous), query head h reading KV head h / (H / KV):
//   s = (q . k) * scale in f32; masked scores are -1e30 (finite, as in the
//   reference: exp(s - m) is never NaN); causal keeps k_pos <= q_pos; with
//   window > 0 a key is kept where q_pos - k_pos < window or k_pos < n_meta;
//   online softmax with a running max and sum in f32; p is rounded to v's
//   type before P.V and the accumulator is f32; out = acc / max(l, 1e-30),
//   rounded to q's type.  A row that sees no visible key at all (only
//   Sq > Skv with a window makes one) sums p = 1 over every key and comes out
//   as the mean of V, as in the reference.
//
// Bound: operations.  At the 2048-token prefill of tinyllama-1.1b (q [1, 2048,
// 32, 64], k/v [1, 2048, 4, 64], causal) the two matmuls over the visible
// (query, key) pairs are 17.19 GFLOP: 0.0174 ms at the dense bf16 tensor-core
// rate of 989 TFLOP/s, against 0.0056 ms for the 18.87 MB of q, k, v and o at
// 3.35 TB/s.  Only the tensor cores can approach that bound, and only through
// wgmma, so the bf16 kernel is built around it:
//
// bf16 (flash_attention_wgmma_kernel): one CTA of one warpgroup (128 threads)
// per (batch * head, 64-row query tile); 64 rows are wgmma's M. TMA loads the
// Q tile once and streams 64-key K and V tiles (32 keys at hd 256, where the
// f32 output takes 128 registers a thread) through a ring of two stages in
// shared memory, each completed on an mbarrier; the next tile's load is issued
// before the current tile's math. The tensor maps view k and v as [B, Skv, KV
// * hd], so a box of [64 keys, 64 columns] at column kvh * hd reads one KV
// head straight from the [B, S, KV, hd] layout (GQA, no transpose); the batch
// is its own dimension, so the ragged tail arrives as zeros and never as the
// next batch's rows. Boxes are 64 columns wide with the 128-byte swizzle (32
// columns and the 64-byte swizzle at hd 32): wgmma's canonical K-major layout.
// S = Q K^T is wgmma m64nBKk16 with both operands in shared memory over hd /
// 16 k-steps; the scale multiplies the f32 product, as in the reference (q is
// not pre-scaled in bf16), together with log2(e), so each exponential is one
// exp2 instead of expf's longer sequence (tools/flash_variants.py times the
// two). The softmax runs on the accumulator fragment: a thread holds two rows,
// a row lives in a quad of four threads, so a row's max is two shuffles. Masks
// are built only on tiles the diagonal, the window or the tail cuts. p,
// rounded to bf16, is already in the layout of wgmma's A-from-registers
// operand, so O += P V is wgmma with A = P from registers and B = V in shared
// memory (MN-major, the transpose bit set), in 64-column pieces of hd; l sums
// the unrounded p. O stays in f32 registers and leaves through shared memory
// as 16-byte stores of the rows < Sq. Several CTAs share an SM (40 KB of
// shared memory at hd 64), so one CTA's softmax overlaps another's wgmma.
//
// f32 (flash_attention_f32_kernel): the port's first kernel, on the CUDA
// cores, kept on purpose. Its tolerance against the plain version is 1e-5,
// which TF32 (10 mantissa bits) or bf16 tensor cores cannot meet. One CTA of 4
// warps per (batch * head, 32 query rows); 32-key tiles staged in shared
// memory; lane j computes key j's scores with f32 FMAs; P.V through shared
// memory.
//
// Both kernels walk the same schedule (tile_walk): fixed tiles with the
// ragged tail masked (tail keys get no weight at all, not the finite -1e30)
// replace the reference's halving of the block until it divides the length;
// tiles masked for every row of the CTA (above the causal diagonal, below
// the window and past the meta prefix) are skipped, the meta-prefix tiles
// walked first; a CTA that holds a row with no visible key walks every tile,
// which its mean of V needs; the heaviest causal tiles are launched first.
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr float kNoKey = -3.0e38f;  // below any score: a tail key, p = exp(kNoKey - m) = 0

// The key tiles a CTA of query rows [q0, q1] walks, in order: the meta-prefix
// tiles [0, t_meta), then [t_lo, t_hi).
struct TileWalk {
  int t_meta, t_lo, t_hi;
  __device__ int count() const { return t_meta + (t_hi - t_lo); }
  __device__ int tile(int it) const { return it < t_meta ? it : t_lo + (it - t_meta); }
};

__device__ __forceinline__ TileWalk tile_walk(int q0, int q1, int Skv, int bk, int causal,
                                              int window, int n_meta) {
  // the key range some row of the CTA can see
  int k_lo = 0;
  int k_hi = causal ? min(q1 + 1, Skv) : Skv;
  if (window > 0) {
    k_lo = max(0, q0 - window + 1);
    // a row with no visible key sums every key (mean of V): walk them all
    if (n_meta <= 0 && static_cast<long long>(q1) >= static_cast<long long>(Skv) - 1 + window) {
      k_lo = 0;
      k_hi = Skv;
    }
  }
  TileWalk w;
  w.t_hi = (k_hi + bk - 1) / bk;
  w.t_lo = min(k_lo / bk, w.t_hi);  // past the last key (Sq > Skv): only the meta tiles
  w.t_meta = (window > 0 && n_meta > 0) ? min((min(n_meta, k_hi) + bk - 1) / bk, w.t_lo) : 0;
  return w;
}

// ============================================================================ bf16: tensor cores
namespace tc {

constexpr int kRows = 64;       // query rows per CTA: wgmma's M
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;      // K/V ring

template <int HD>
struct Cfg {
  static constexpr int kBK = HD == 256 ? 32 : 64;     // keys per tile
  static constexpr int kSW = HD < 64 ? HD : 64;       // columns of one TMA box / swizzle row
  static constexpr int kRowBytes = 2 * kSW;           // 128 (or 64 at hd 32)
  static constexpr int kSlabs = HD / kSW;             // boxes across hd
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSBO = 8 * kRowBytes;     // 8-row core-matrix group
  static constexpr int kQSlab = kRows * kRowBytes;
  static constexpr int kKVSlab = kBK * kRowBytes;
  static constexpr int kQBytes = kRows * 2 * HD;
  static constexpr int kKVBytes = kBK * 2 * HD;       // one K or V tile
  // Q | K0 V0 | K1 V1 | mbarriers; the ring doubles as the output's staging
  static constexpr int kBarOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kBytes = kBarOff + 8 * (1 + kStages) + 1024;  // + alignment slack
  static constexpr int kOStride = HD + 8;             // staged output row (bf16): no bank conflicts
  static_assert(kRows * kOStride * 2 <= kStages * 2 * kKVBytes, "output staging exceeds the ring");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with the given parity.  A completion that never
// comes (a transaction count that does not match the boxes) traps after
// seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D map into shared memory, completed on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes in place: the
// compiler may not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define DSA_R8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T; A, B in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : DSA_R8(0), DSA_R8(8)
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T; A, B in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DSA_R8(0), DSA_R8(8), DSA_R8(16), DSA_R8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]; A in registers, B in shared memory
// MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : DSA_R8(0), DSA_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B in shared memory
// MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DSA_R8(0), DSA_R8(8), DSA_R8(16), DSA_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef DSA_R8

// Two floats as a bf16 pair, the first in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragment of wgmma m64nN (f32): thread t of the warpgroup holds,
// for each 8-column group j, d[4j + e] at row 16 * (t / 32) + (t % 32) / 4 +
// 8 * (e / 2) and column 8j + 2 * (t % 4) + e % 2.  Element e of a group is
// in the thread's second row when (e & 2).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int KV,
                             float scale, int causal, int window, int n_meta) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  constexpr int kSW = C::kSW;
  constexpr int kSlabs = C::kSlabs;

  extern __shared__ uint8_t smem_raw[];
  // the swizzled boxes need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK0 = base + C::kQBytes;
  const uint32_t bar_q = base + C::kBarOff;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int q1 = min(q0 + kRows, Sq) - 1;  // last query row of the tile
  const TileWalk walk = tile_walk(q0, q1, Skv, BK, causal, window, n_meta);
  const int n_tiles = walk.count();

  auto k_stage = [&](int s) { return sK0 + s * 2 * C::kKVBytes; };
  auto v_stage = [&](int s) { return k_stage(s) + C::kKVBytes; };
  auto bar_kv = [&](int s) { return bar_q + 8 * (1 + s); };
  auto load_kv = [&](int it) {  // one thread
    const int s = it % kStages;
    const int k0 = walk.tile(it) * BK;
    mbar_expect_tx(bar_kv(s), 2 * C::kKVBytes);
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) {
      tma_load(k_stage(s) + j * C::kKVSlab, &kmap, bar_kv(s), kvh * HD + j * kSW, k0, b);
      tma_load(v_stage(s) + j * C::kKVSlab, &vmap, bar_kv(s), kvh * HD + j * kSW, k0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int j = 0; j < kSlabs; ++j)
      tma_load(sQ + j * C::kQSlab, &qmap, bar_q, h * HD + j * kSW, q0, b);
    for (int it = 0; it < kStages - 1 && it < n_tiles; ++it) load_kv(it);
  }

  float acc[kSlabs][kSW / 2];  // O, f32
  float sc[BK / 2];            // S of the current tile
#pragma unroll
  for (int j = 0; j < kSlabs; ++j)
#pragma unroll
    for (int i = 0; i < kSW / 2; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  // Scores are kept in base-2 units, s * scale * log2(e), so that every
  // exponential is one exp2 (MUFU.EX2) of a difference: exp(x - m) ==
  // exp2((x - m) * log2(e)).  The scale still multiplies the f32 product.
  const float scale2 = scale * 1.4426950408889634f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of the thread's two rows
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the rows' sums
  const int r0 = q0 + 16 * warp + lane / 4;  // the thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);  // the thread's first column in each 8-column group

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = walk.tile(it) * BK;
    // the stage the next load fills was last read by tile it - 1, which every
    // warp has finished
    __syncthreads();
    if (tid == 0 && it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    mbar_wait(bar_kv(s), (it / kStages) & 1);

    // S = Q K^T over hd / 16 k-steps; a k-step is 32 bytes along a swizzled row
    pin(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int slab = kk * 16 / kSW;
      const int col_bytes = (kk * 16 % kSW) * 2;
      const uint64_t da =
          make_desc(sQ + slab * C::kQSlab + col_bytes, 16, C::kSBO, C::kLayout);
      const uint64_t db =
          make_desc(k_stage(s) + slab * C::kKVSlab + col_bytes, 16, C::kSBO, C::kLayout);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(sc);

    // scale in f32; masks only where the diagonal, the window or the tail cut the tile
    const bool whole = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q0) &&
                       (window <= 0 || q1 - k0 < window || k0 + BK <= n_meta);
    if (whole) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale2;
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qpos = (i & 2) ? r1 : r0;
        bool vis = true;
        if (causal) vis = kpos <= qpos;
        if (window > 0) vis = vis && (qpos - kpos < window || kpos < n_meta);
        const float x = vis ? sc[i] * scale2 : kNegInf;
        sc[i] = kpos < Skv ? x : kNoKey;  // tail keys: no weight at all
      }
    }
    float mx0 = kNoKey, mx1 = kNoKey;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0);
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p, and P rounded to bf16 in the A-operand layout: k-step kk of P.V takes
    // the score groups 2kk and 2kk + 1
    uint32_t pa[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = exp2f(sc[8 * kk + e] - ((e & 2) ? mn1 : mn0));
      ps0 += (p[0] + p[1]) + (p[4] + p[5]);
      ps1 += (p[2] + p[3]) + (p[6] + p[7]);
      pa[kk][0] = pack_bf16(p[0], p[1]);  // row r0, k 0-7
      pa[kk][1] = pack_bf16(p[2], p[3]);  // row r1, k 0-7
      pa[kk][2] = pack_bf16(p[4], p[5]);  // row r0, k 8-15
      pa[kk][3] = pack_bf16(p[6], p[7]);  // row r1, k 8-15
    }
    l0 = l0 * a0 + ps0;  // the unrounded p
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < kSlabs; ++j)
#pragma unroll
      for (int i = 0; i < kSW / 2; ++i) acc[j][i] *= (i & 2) ? a1 : a0;

    // O += P V: V's tile is [BK keys, hd], MN-major; a k-step is 16 key rows.
    // One swizzle atom spans the instruction's N, so only the stride between
    // 8-key groups is read: both offsets carry it.
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) pin(acc[j]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pin(pa[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kSlabs; ++j)
        wgmma_rs(acc[j], pa[kk],
                 make_desc(v_stage(s) + j * C::kKVSlab + kk * 16 * C::kRowBytes, C::kSBO,
                           C::kSBO, C::kLayout));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) pin(acc[j]);
  }

  // out = acc / max(l, 1e-30), staged in the (now idle) ring, stored as 16-byte rows
  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  __syncthreads();
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(base_ptr + C::kQBytes);
  const int lr0 = r0 - q0;
#pragma unroll
  for (int j = 0; j < kSlabs; ++j)
#pragma unroll
    for (int g = 0; g < kSW / 8; ++g) {
      const int col = j * kSW + 8 * g + cq;
      const float* x = &acc[j][4 * g];
      *reinterpret_cast<__nv_bfloat162*>(so + lr0 * C::kOStride + col) =
          __floats2bfloat162_rn(x[0] / d0, x[1] / d0);
      *reinterpret_cast<__nv_bfloat162*>(so + (lr0 + 8) * C::kOStride + col) =
          __floats2bfloat162_rn(x[2] / d1, x[3] / d1);
    }
  __syncthreads();
  constexpr int kPieces = HD / 8;  // 16-byte pieces of a row
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = i % kPieces;
    if (q0 + r < Sq) {
      const long long row = (static_cast<long long>(b) * Sq + q0 + r) * H + h;
      *reinterpret_cast<uint4*>(o + row * HD + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * C::kOStride + c * 8);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// library links no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [batch, rows, heads * hd] bf16 tensor as a 3-D map with boxes of
// [box_rows, box_cols]; rows past the end of a batch read as zeros.
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int box_rows) {
  using C = Cfg<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t width = static_cast<cuuint64_t>(heads) * HD;
  const cuuint64_t dims[3] = {width, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {width * 2, width * 2 * rows};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kSW), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, int KV, float scale, int causal, int window, int n_meta,
                      cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qmap, kmap, vmap;
  if (!encode<HD>(&qmap, q, B, Sq, H, kRows) || !encode<HD>(&kmap, k, B, Skv, KV, C::kBK) ||
      !encode<HD>(&vmap, v, B, Skv, KV, C::kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_attention_wgmma_kernel<HD><<<grid, kThreads, C::kBytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV, scale, causal, window,
      n_meta);
  return cudaGetLastError();
}

}  // namespace tc

// ============================================================================ f32: CUDA cores
namespace cc {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per CTA
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
struct Smem {
  static constexpr int kQ = kBQ * HD;          // Q tile
  static constexpr int kKStride = HD + 1;      // K rows padded: lane j reads row j
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * HD;
  static constexpr int kP = kWarps * kRows * kBK;
  // Q, V and P stay 16-byte aligned (float4 reads): K's size is padded.
  static constexpr int kKAligned = (kK + 3) / 4 * 4;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKAligned + kV + kP);
};

// Stage rows [row0, row0 + n) of one head of a [.., S, heads, HD] tensor as
// rows of stride `stride`; rows at or past `limit` are zero.
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* head0,
                                           long long pos_stride, int row0, int n, int limit) {
  constexpr int kQuads = HD / 4;
  for (int i = threadIdx.x; i < n * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int d = (i % kQuads) * 4;
    const int pos = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < limit) x = *reinterpret_cast<const float4*>(head0 + pos * pos_stride + d);
    float* out = dst + r * stride + d;
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                           int H, int KV, float scale, int causal, int window, int n_meta) {
  constexpr int kCols = HD / 32;  // output columns per lane
  using S = Smem<HD>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;
  float* Vs = Ks + S::kKAligned;
  float* Ps = Vs + S::kV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int q1 = min(q0 + kBQ, Sq) - 1;  // last query row of the tile

  const long long q_pos_stride = static_cast<long long>(H) * HD;
  const long long kv_pos_stride = static_cast<long long>(KV) * HD;
  const float* qh = q + (static_cast<long long>(b) * Sq * H + h) * HD;
  const float* kh = k + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  const float* vh = v + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  float* oh = o + (static_cast<long long>(b) * Sq * H + h) * HD;

  stage_rows<HD>(Qs, HD, qh, q_pos_stride, q0, kBQ, Sq);
  const TileWalk walk = tile_walk(q0, q1, Skv, kBK, causal, window, n_meta);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRows;
  float* Pw = Ps + warp * kRows * kBK;

  const int n_tiles = walk.count();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = walk.tile(it) * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_rows<HD>(Ks, S::kKStride, kh, kv_pos_stride, k0, kBK, Skv);
    stage_rows<HD>(Vs, HD, vh, kv_pos_stride, k0, kBK, Skv);
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * S::kKStride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = kr[d], k_1 = kr[d + 1], k_2 = kr[d + 2], k_3 = kr[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * HD + d);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }

    const int kpos = k0 + lane;
    const bool key = kpos < Skv;  // false for the ragged tail: no weight at all
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row0 + r;
      bool vis = true;
      if (causal) vis = kpos <= qpos;
      if (window > 0) vis = vis && (qpos - kpos < window || kpos < n_meta);
      const float sv = vis ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(key ? sv : kNoKey));
      const float p = key ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + p;  // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      Pw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc += p . V: lane owns columns lane, lane + 32, ...
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[jj][c] = Vs[(j + jj) * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(Pw + r * kBK + j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = acc[r][c];
          a = fmaf(pv.x, vv[0][c], a);
          a = fmaf(pv.y, vv[1][c], a);
          a = fmaf(pv.z, vv[2][c], a);
          a = fmaf(pv.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qpos = q0 + row0 + r;
    if (qpos < Sq) {
      float* out = oh + qpos * q_pos_stride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[lane + 32 * c] = acc[r][c] / denom;
    }
  }
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, int KV, float scale, int causal, int window, int n_meta,
                      cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  // above 48 KB a CTA's shared memory must be asked for (per device: set on
  // every launch, a call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, H, KV, scale, causal, window, n_meta);
  return cudaGetLastError();
}

}  // namespace cc

// The head-dim switch of both entries (the wrapper raises first on another).
#define DSA_FLASH_ARGS q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, n_meta, s

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int H, int KV, int hd, float scale, int causal, int window,
                        int n_meta, cudaStream_t s) {
  switch (hd) {
    case 32: return tc::launch_hd<32>(DSA_FLASH_ARGS);
    case 64: return tc::launch_hd<64>(DSA_FLASH_ARGS);
    case 128: return tc::launch_hd<128>(DSA_FLASH_ARGS);
    case 256: return tc::launch_hd<256>(DSA_FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int H, int KV, int hd, float scale, int causal, int window,
                       int n_meta, cudaStream_t s) {
  switch (hd) {
    case 32: return cc::launch_hd<32>(DSA_FLASH_ARGS);
    case 64: return cc::launch_hd<64>(DSA_FLASH_ARGS);
    case 128: return cc::launch_hd<128>(DSA_FLASH_ARGS);
    case 256: return cc::launch_hd<256>(DSA_FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef DSA_FLASH_ARGS

}  // namespace

extern "C" {

int dsa_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                             int B, int Sq, int Skv, int H, int KV, int hd, float scale,
                             int causal, int window, int n_meta, void* stream) {
  return static_cast<int>(launch_bf16(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window,
                                      n_meta, static_cast<cudaStream_t>(stream)));
}

int dsa_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                            int B, int Sq, int Skv, int H, int KV, int hd, float scale,
                            int causal, int window, int n_meta, void* stream) {
  return static_cast<int>(launch_f32(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window,
                                     n_meta, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
