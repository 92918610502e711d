// Forward flash attention for Hopper (sm_90a), hand-written in CUDA C++.
//
// Replaces kernels/flash_attention.py flash_attention / _kernel (Pallas) of
// the JAX package.  Built by kernels/_build.py with nvcc into the same shared
// library as dsa_kernels.cu (plain C interface, loaded with ctypes).  Each
// entry point launches on the stream it is given, allocates nothing (the
// wrapper allocates the output with torch.empty) and returns
// cudaGetLastError().
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
// Bound: operations.  At the 2048-token prefill of tinyllama-1.1b (32 heads,
// hd 64, causal) the work is 17.2 GFLOP against 18.9 MB of q, k, v and o:
// about 900 FLOP a byte, above the card's ~295 for bf16 tensor cores.
//
// Design (a simple first kernel; tensor cores, TMA and pipelining are later
// work): one CTA of 4 warps per (batch * head, tile of 32 query rows), each
// warp owning 8 rows.  The CTA stages its Q tile once and then walks 32-key
// K/V tiles through shared memory, converted to f32.  Scores: lane j owns key
// j of the tile and accumulates all 8 of its warp's rows with f32 FMAs (Q
// read as broadcast float4, K row-padded so the 32 lanes hit 32 banks).
// Softmax: a warp max per row; each lane keeps its own partial sum, reduced
// once at the end.  P.V: the rounded p go through shared memory; lane d owns
// output columns d, d + 32, ... of each row.  Fixed tiles with the ragged
// tail masked replace the reference's halving of the block size until it
// divides the length (a 33-token prompt there gets 1-row tiles).  Tiles that
// are masked for every row of the CTA (above the causal diagonal, below the
// window and past the meta prefix) are skipped; a CTA that holds a row with
// no visible key visits every tile, which its mean-of-V needs.  The heaviest
// causal tiles are launched first.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per CTA
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kNoKey = -3.0e38f;       // below any score: a tail lane in the max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p as the reference's p.astype(v.dtype) leaves it, back in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

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
  static constexpr int kQ = kBQ * HD;          // Q tile, f32
  static constexpr int kKStride = HD + 1;      // K rows padded: lane j reads row j
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * HD;
  static constexpr int kP = kWarps * kRows * kBK;
  // Q, V and P stay 16-byte aligned (float4 reads): K's size is padded.
  static constexpr int kKAligned = (kK + 3) / 4 * 4;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKAligned + kV + kP);
};

// Stage rows [row0, row0 + n) of one head of a [.., S, heads, HD] tensor as f32
// rows of stride `stride`; rows at or past `limit` are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* head0,
                                           long long pos_stride, int row0, int n,
                                           int limit) {
  constexpr int kQuads = HD / 4;
  for (int i = threadIdx.x; i < n * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int d = (i % kQuads) * 4;
    const int pos = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < limit) x = load4(head0 + pos * pos_stride + d);
    float* out = dst + r * stride + d;
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int KV, float scale, int causal, int window,
                       int n_meta) {
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
  const T* qh = q + (static_cast<long long>(b) * Sq * H + h) * HD;
  const T* kh = k + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  const T* vh = v + (static_cast<long long>(b) * Skv * KV + kvh) * HD;
  T* oh = o + (static_cast<long long>(b) * Sq * H + h) * HD;

  stage_rows<T, HD>(Qs, HD, qh, q_pos_stride, q0, kBQ, Sq);

  // The key range some row of this tile can see.
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
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;
  const int t_meta = (window > 0 && n_meta > 0)
                         ? min((min(n_meta, k_hi) + kBK - 1) / kBK, t_lo)
                         : 0;

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

  const int n_tiles = t_meta + (t_hi - t_lo);
  for (int it = 0; it < n_tiles; ++it) {
    const int t = it < t_meta ? it : t_lo + (it - t_meta);
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage_rows<T, HD>(Ks, S::kKStride, kh, kv_pos_stride, k0, kBK, Skv);
    stage_rows<T, HD>(Vs, HD, vh, kv_pos_stride, k0, kBK, Skv);
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
      Pw[r * kBK + lane] = round_to<T>(p);
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
      T* out = oh + qpos * q_pos_stride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[lane + 32 * c] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Skv, int H, int KV, float scale, int causal,
                      int window, int n_meta, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD>::kBytes;
  // above 48 KB a CTA's shared memory must be asked for (per device: set on
  // every launch, a call of about a microsecond)
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, KV, scale, causal, window, n_meta);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int hd, float scale, int causal, int window,
           int n_meta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch_hd<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, n_meta, s); break;
    case 64: err = launch_hd<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, n_meta, s); break;
    case 128: err = launch_hd<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, n_meta, s); break;
    case 256: err = launch_hd<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, n_meta, s); break;
    default: err = cudaErrorInvalidValue; break;  // the wrapper raises first
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int dsa_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                             int B, int Sq, int Skv, int H, int KV, int hd, float scale,
                             int causal, int window, int n_meta, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window,
                               n_meta, stream);
}

int dsa_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                            int B, int Sq, int Skv, int H, int KV, int hd, float scale,
                            int causal, int window, int n_meta, void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window, n_meta,
                       stream);
}

}  // extern "C"
