// Latent-attention decode for Hopper (sm_90a), hand-written in CUDA C++:
// DeepSeek-V2's absorbed form, one new token's 16 query heads against a
// latent cache.
//
// Replaces no Pallas kernel: the JAX package has no latent attention.  The
// port's decode attention (decode_attention.cu) takes one KV head per up to
// 8 query heads and head dims up to 256; the absorbed latent decode is one
// "KV head" of keys 576 wide (the 512-wide latent c_kv and the 64-wide
// shared roped key k_pe) and values 512 wide (c_kv again), read by all 16
// query heads.  Built by kernels/_build.py with nvcc into the same shared
// library as the other sources (plain C interface, loaded with ctypes); the
// entry point launches on the stream it is given, allocates nothing (the
// wrapper allocates the output and the partials with torch.empty) and
// returns a cudaError_t.
//
// What it computes, for q [B, 16, 576] against c_kv [B, S, 512] and k_pe
// [B, S, 64] (bf16 or f32, rows of any stride of 16 bytes) under n_live [B]
// (int32): a slot s of row b is live where s < n_live[b]; its score is
// (q[:512] . c_kv[s] + q[512:] . k_pe[s]) * scale in f32 from the stored
// values; softmax in f32 over the live slots; out = sum_s p_s c_kv[s] / l
// with f32 sums, rounded once to q's type.  A row with no live slot comes
// out as the mean of c_kv over all S slots (the uniform softmax over S
// scores of the reference's NEG_INF, as decode_attention.cu gives).
//
// Bound: bytes.  Each live slot is 1152 bytes of bf16 latent and key, and
// the 16 heads do 2 x 16 x 576 (scores) + 2 x 16 x 512 (P.C) = 34816 FLOPs
// on it: about 30 FLOPs a byte, far under the card's 295 for bf16 tensor
// cores, but above the CUDA cores' 20 (67 TFLOP/s f32 over 3.35 TB/s): a
// kernel that did the products on CUDA cores would be bound by them.  The
// design reads each live byte once and does the products on tensor cores:
//   * one CTA holds the 16 query heads of a row, so each latent slot is
//     loaded once for all of them; mma.sync m16n8k16 takes the 16 heads as
//     its M, slots or latent dims as N;
//   * the cache is read in its own type and in place (strides are
//     arguments), with cp.async 16 bytes a thread into a two-stage ring of
//     64-slot tiles in shared memory (zero-filled past the split's end);
//     rows padded to 1168 bytes, so ldmatrix's eight rows land on eight
//     bank groups;
//   * each of the 4 warps takes 16 slots of a tile for the scores (all 576
//     dims), the tile's row maximum and sums meet in shared memory, and each
//     warp then takes 128 of the 512 latent dims for P.C over all 64 slots;
//     p enters the tensor cores as two bf16 terms, hi = bf16(p) and lo =
//     bf16(p - hi), so P.C carries p to about 2^-17 of itself: scores, p and
//     sums are f32 to within that;
//   * flash-decoding: the grid is (splits of `chunk` slots, B), sized from
//     shapes alone; a CTA whose split starts at or past n_live[b] exits at
//     once, so the work is proportional to the live slots;
//   * a second small kernel combines each (b, head)'s splits' (m, l, acc)
//     partials, since CTAs run in no order.
// f32 caches (tests; tensor cores cannot hold f32) take a plain CUDA-core
// split kernel of the same function: 8 threads a head, one slot at a time.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH = 16;             // query heads of a row: the mma's M
constexpr int kR = 512;            // the latent's width
constexpr int kDr = 64;            // the shared roped key's width
constexpr int kDk = kR + kDr;      // 576: a key's width
constexpr int kTile = 64;          // slots a stage holds
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kDk / 8;             // 16-byte pieces of a bf16 key row: 72
constexpr int kRowB = (kDk + 8) * 2;         // a slot's (and a head's q) row: 1168 bytes
constexpr int kPRowB = (kTile + 8) * 2;      // a head's row of p: 144 bytes
constexpr int kStageB = kTile * kRowB;       // 74752
constexpr int kQB = kH * kRowB;              // 18688
constexpr int kPB = kH * kPRowB;             // 2304, one plane (hi or lo)
constexpr int kSmemB = 2 * kStageB + kQB + 2 * kPB + 2 * kWarps * kH * 4;  // 173312
constexpr int kSimtThreads = 128;            // 16 heads x 8 threads
constexpr int kSimtQ = kDk / 8;              // q dims a thread holds: 72
constexpr int kSimtO = kR / 8;               // output dims a thread owns: 64
static_assert(kRowB % 128 == 16 && kPRowB % 128 == 16, "rows must step across bank groups");
static_assert(kSmemB <= 232448, "shared memory of one block");

struct Args {
  const void* q;      // [B, 16, 576], dense
  const void* ckv;    // [B, S, 512]
  const void* kpe;    // [B, S, 64]
  const int* n_live;  // [B]
  void* o;            // [B, 16, 512]
  float* part_m;      // [B, n_splits, 16]
  float* part_l;      // [B, n_splits, 16]
  float* part_acc;    // [B, n_splits, 16, 512]
  int B, S, chunk, n_splits;
  long long csb, css, psb, pss;  // in elements
  float scale;
};

__device__ inline int live_slots(const Args& a, int b) {
  const int n = a.n_live[b];
  return n < 0 ? 0 : (n > a.S ? a.S : n);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros where !full (no read)
__device__ inline void cp_async16(uint32_t dst, const void* src, bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ inline void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ inline void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 sums
__device__ inline void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two bf16 terms each: hi = bf16(v), lo = bf16(v - hi), packed
// with x in the low half (the lower column)
__device__ inline void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// tile t of the split (slots base .. base + 63) into a stage; slots at or
// past s1 are zero-filled from a valid address
__device__ inline void load_tile(const Args& a, const __nv_bfloat16* ckv,
                                 const __nv_bfloat16* kpe, int base, int s0, int s1,
                                 unsigned char* dst) {
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = base + r;
    const bool full = s < s1;
    const long long ss = full ? s : s0;
    const void* src = c < kR / 8 ? static_cast<const void*>(ckv + ss * a.css + c * 8)
                                 : static_cast<const void*>(kpe + ss * a.pss + (c - kR / 8) * 8);
    cp_async16(smem_u32(dst + r * kRowB + c * 16), src, full);
  }
}

__global__ void __launch_bounds__(kThreads) mla_decode_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, b = blockIdx.y;
  const int nl = live_slots(a, b);
  const int s0 = split * a.chunk;
  if (s0 >= nl) return;  // past the row's live slots: nothing to read
  const int s1 = min(s0 + a.chunk, nl);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragments' row group and column pair

  unsigned char* sK = smem;  // two stages of kTile slot rows
  unsigned char* sQ = smem + 2 * kStageB;
  unsigned char* sP = sQ + kQB;  // p's hi plane, then its lo plane: [16 heads][64 slots]
  float* sRedM = reinterpret_cast<float*>(sP + 2 * kPB);  // [warp][head]
  float* sRedL = sRedM + kWarps * kH;

  const __nv_bfloat16* ckv = static_cast<const __nv_bfloat16*>(a.ckv) + b * a.csb;
  const __nv_bfloat16* kpe = static_cast<const __nv_bfloat16*>(a.kpe) + b * a.psb;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            static_cast<long long>(b) * kH * kDk;
  for (int i = tid; i < kH * kChunks; i += kThreads) {
    const int h = i / kChunks, c = i % kChunks;
    cp_async16(smem_u32(sQ + h * kRowB + c * 16), qb + h * kDk + c * 8, true);
  }
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  load_tile(a, ckv, kpe, s0, s0, s1, sK);
  cp_commit();  // the first group: q and tile 0

  float m_run[2] = {-INFINITY, -INFINITY};  // heads g and g + 8
  float l_run[2] = {0.f, 0.f};
  float oacc[16][4];  // this warp's 128 latent dims as 16 tiles of 8
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  const uint32_t sQa = smem_u32(sQ), sPa = smem_u32(sP);
  const int q8 = lane >> 3, r8 = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  for (int t = 0; t < n_tiles; ++t) {
    const int base = s0 + t * kTile;
    if (t + 1 < n_tiles)
      load_tile(a, ckv, kpe, base + kTile, s0, s1, sK + ((t + 1) & 1) * kStageB);
    cp_commit();  // possibly empty: one group an iteration
    cp_wait_1();  // all but the newest group landed: tile t (and q)
    __syncthreads();
    const uint32_t sKa = smem_u32(sK + (t & 1) * kStageB);

    // scores of the warp's 16 slots: two n-tiles of 8 slots, 36 k-steps of 16 dims
    float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint32_t qrow = sQa + (lane & 15) * kRowB + (lane >> 4) * 16;
    const uint32_t krow = sKa + (warp * 16 + (q8 >> 1) * 8 + r8) * kRowB + (q8 & 1) * 16;
#pragma unroll 4
    for (int kk = 0; kk < kDk / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qrow + kk * 32, qa);
      ldsm_x4(krow + kk * 32, kb);
      mma_bf16(sacc[0], qa, kb[0], kb[1]);
      mma_bf16(sacc[1], qa, kb[2], kb[3]);
    }
    // sacc[j][0..1]: head g, slots warp * 16 + j * 8 + 2 tg + {0, 1}; [2..3]: head g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = base + warp * 16 + j * 8 + 2 * tg + (e & 1);
        const float v = s < s1 ? sacc[j][e] * a.scale : -INFINITY;
        sacc[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
    if (tg == 0) {
      sRedM[warp * kH + g] = mx[0];
      sRedM[warp * kH + g + 8] = mx[1];
    }
    __syncthreads();
    // the tile's maximum (the tile holds a live slot: finite), p, its sums
    float mnew[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tm = fmaxf(tm, sRedM[w * kH + g + 8 * hh]);
      mnew[hh] = fmaxf(m_run[hh], tm);
      alpha[hh] = expf(m_run[hh] - mnew[hh]);  // 0 while m_run is -inf
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = expf(sacc[j][0] - mnew[0]), p1 = expf(sacc[j][1] - mnew[0]);
      const float p2 = expf(sacc[j][2] - mnew[1]), p3 = expf(sacc[j][3] - mnew[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      const int col = (warp * 16 + j * 8 + 2 * tg) * 2;
      uint32_t hi, lo;
      split_pair(p0, p1, hi, lo);
      *reinterpret_cast<uint32_t*>(sP + g * kPRowB + col) = hi;
      *reinterpret_cast<uint32_t*>(sP + kPB + g * kPRowB + col) = lo;
      split_pair(p2, p3, hi, lo);
      *reinterpret_cast<uint32_t*>(sP + (g + 8) * kPRowB + col) = hi;
      *reinterpret_cast<uint32_t*>(sP + kPB + (g + 8) * kPRowB + col) = lo;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 1);
      ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], 2);
    }
    if (tg == 0) {
      sRedL[warp * kH + g] = ps[0];
      sRedL[warp * kH + g + 8] = ps[1];
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ls += sRedL[w * kH + g + 8 * hh];
      l_run[hh] = l_run[hh] * alpha[hh] + ls;
      m_run[hh] = mnew[hh];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    // P.C over the tile's 64 slots for the warp's 128 latent dims
    const uint32_t prow = sPa + (lane & 15) * kPRowB + (lane >> 4) * 16;
    const uint32_t vrow = sKa + ((q8 & 1) * 8 + r8) * kRowB + (warp * 128 + (q8 >> 1) * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t ph[4], pl[4];
      ldsm_x4(prow + ks * 32, ph);
      ldsm_x4(prow + kPB + ks * 32, pl);
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vrow + ks * 16 * kRowB + np * 32, vb);
        mma_bf16(oacc[2 * np], ph, vb[0], vb[1]);
        mma_bf16(oacc[2 * np], pl, vb[0], vb[1]);
        mma_bf16(oacc[2 * np + 1], ph, vb[2], vb[3]);
        mma_bf16(oacc[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }

  const long long row = static_cast<long long>(b) * a.n_splits + split;
  if (warp == 0 && tg == 0) {
    a.part_m[row * kH + g] = m_run[0];
    a.part_m[row * kH + g + 8] = m_run[1];
    a.part_l[row * kH + g] = l_run[0];
    a.part_l[row * kH + g + 8] = l_run[1];
  }
  float* acc = a.part_acc + row * kH * kR;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int d = warp * 128 + n * 8 + 2 * tg;
    *reinterpret_cast<float2*>(acc + g * kR + d) = make_float2(oacc[n][0], oacc[n][1]);
    *reinterpret_cast<float2*>(acc + (g + 8) * kR + d) = make_float2(oacc[n][2], oacc[n][3]);
  }
}

template <typename T>
__device__ inline float to_f(T x);
template <>
__device__ inline float to_f<float>(float x) { return x; }
template <>
__device__ inline float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }  // RNE
__device__ inline void store(float* p, float x) { *p = x; }

// The same split on CUDA cores, for f32 caches: thread j of head h's 8 holds
// q's dims 72 j .. 72 j + 71 and owns the output's 64 j .. 64 j + 63; one
// slot at a time, the head's 8 threads summing the score by shuffles.
template <typename T>
__global__ void __launch_bounds__(kSimtThreads) mla_decode_split_simt_kernel(const Args a) {
  const int split = blockIdx.x, b = blockIdx.y;
  const int nl = live_slots(a, b);
  const int s0 = split * a.chunk;
  if (s0 >= nl) return;
  const int s1 = min(s0 + a.chunk, nl);
  const int h = threadIdx.x / 8, j = threadIdx.x % 8;
  const T* ckv = static_cast<const T*>(a.ckv) + b * a.csb;
  const T* kpe = static_cast<const T*>(a.kpe) + b * a.psb;
  const T* qrow = static_cast<const T*>(a.q) + (static_cast<long long>(b) * kH + h) * kDk;
  float qf[kSimtQ], acc[kSimtO];
#pragma unroll
  for (int e = 0; e < kSimtQ; ++e) qf[e] = to_f(qrow[kSimtQ * j + e]);
#pragma unroll
  for (int e = 0; e < kSimtO; ++e) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int s = s0; s < s1; ++s) {
    const T* crow = ckv + s * a.css;
    const T* prow = kpe + s * a.pss;
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < kSimtQ; ++e) {
      const int dim = kSimtQ * j + e;
      d = fmaf(qf[e], to_f(dim < kR ? crow[dim] : prow[dim - kR]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    const float sc = d * a.scale;
    const float mn = fmaxf(m, sc);
    const float al = expf(m - mn), p = expf(sc - mn);
    l = l * al + p;
#pragma unroll
    for (int e = 0; e < kSimtO; ++e) acc[e] = fmaf(p, to_f(crow[kSimtO * j + e]), acc[e] * al);
    m = mn;
  }
  const long long row = static_cast<long long>(b) * a.n_splits + split;
  if (j == 0) {
    a.part_m[row * kH + h] = m;
    a.part_l[row * kH + h] = l;
  }
  float* out = a.part_acc + (row * kH + h) * kR + kSimtO * j;
#pragma unroll
  for (int e = 0; e < kSimtO; ++e) out[e] = acc[e];
}

// One CTA a (b, head), a thread a latent dim: the splits' partials combined.
template <typename T>
__global__ void __launch_bounds__(kR) mla_decode_combine_kernel(const Args a) {
  const int bh = blockIdx.x;
  const int b = bh / kH, h = bh % kH;
  const int nl = live_slots(a, b);
  const int ns = (nl + a.chunk - 1) / a.chunk;
  const long long row0 = static_cast<long long>(b) * a.n_splits;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, a.part_m[(row0 + s) * kH + h]);
  const int d = threadIdx.x;
  float acc = 0.f;
  if (ns > 0) {
    float Ls = 0.f;
    for (int s = 0; s < ns; ++s) {
      const long long at = (row0 + s) * kH + h;
      const float w = expf(a.part_m[at] - M);
      Ls += a.part_l[at] * w;
      acc = fmaf(a.part_acc[at * kR + d], w, acc);
    }
    acc /= fmaxf(Ls, 1e-30f);
  } else {
    // no live slot: the reference's softmax over S scores of NEG_INF is
    // uniform, so the output is the mean of c_kv over all S slots
    const T* cb = static_cast<const T*>(a.ckv) + b * a.csb + d;
    for (int s = 0; s < a.S; ++s) acc += to_f(cb[s * a.css]);
    acc /= static_cast<float>(a.S);
  }
  store(static_cast<T*>(a.o) + static_cast<long long>(bh) * kR + d, acc);
}

}  // namespace

extern "C" {

// dtype: 0 bf16 (tensor cores; chunk a multiple of 64), 1 f32 (CUDA cores).
int dsa_mla_decode(const void* q, const void* ckv, const void* kpe, const void* n_live, void* o,
                   void* part_m, void* part_l, void* part_acc, int B, int S, int chunk,
                   int n_splits, long long csb, long long css, long long psb, long long pss,
                   float scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || chunk <= 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits) * chunk < S || (dtype == 0 && chunk % kTile != 0) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, ckv, kpe, static_cast<const int*>(n_live), o, static_cast<float*>(part_m),
         static_cast<float*>(part_l), static_cast<float*>(part_acc), B, S, chunk, n_splits,
         csb, css, psb, pss, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_splits, B);
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemB);
    if (err != cudaSuccess) return static_cast<int>(err);
    mla_decode_split_kernel<<<grid, kThreads, kSmemB, st>>>(a);
  } else {
    mla_decode_split_simt_kernel<float><<<grid, kSimtThreads, 0, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    mla_decode_combine_kernel<__nv_bfloat16><<<B * kH, kR, 0, st>>>(a);
  else
    mla_decode_combine_kernel<float><<<B * kH, kR, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
