// Decode attention for Hopper (sm_90a), hand-written in CUDA C++: one new
// token's query against a KV cache.
//
// Replaces no Pallas kernel: the JAX package computes decode attention with
// two einsums (repro/models/layers.py:286 decode_attention), which the port
// copied.  On the card those einsums cast the whole cache to f32 in device
// memory (2 x B x S x KV x hd x 4 bytes written and read again in every layer
// of every step) and attend over every slot of the cache, whatever each row's
// length.  Built by kernels/_build.py with nvcc into the same shared library
// as the other sources (plain C interface, loaded with ctypes); the entry
// point launches on the stream it is given, allocates nothing (the wrapper
// allocates the output and the partials with torch.empty) and returns a
// cudaError_t.
//
// What it computes, for q [B, H, hd] against k, v [B, S, KV, hd] (bf16 or
// f32, any strides of 16 bytes over the last dim) under valid_mask [B, S]
// (bool) and n_live [B] (int32, or none: S), query head h reading KV head
// h / G (G = H / KV):
//   a slot s of row b is valid where s < n_live[b] and valid_mask[b, s];
//   s = (q . k) * scale in f32 from the stored values; an invalid slot's
//   score is -1e30 (the reference's finite NEG_INF, so a slot the mask takes
//   away inside [0, n_live) weighs exp(-1e30 - m), exactly as there);
//   softmax in f32; p stays in f32 into P.V (the decode reference does not
//   round p to v's type, unlike flash); the sum is f32; out = acc / l,
//   rounded once to the cache's type (or kept in f32 with the row's max m
//   and sum l, for the sequence-split combine of models/layers.py).  A row
//   with no valid slot comes out as the mean of V over all S slots, as the
//   reference's uniform softmax over S scores of -1e30 gives.
//
// Bound: bytes.  Per layer of a chat decode step (deepseek-moe-16b, 24 rows,
// 16 heads of 128, about 1400 live slots a row) the live K and V are 275 MB:
// 82 us at 3.35 TB/s, against 2 FLOPs a byte.  The design moves only those
// bytes, once:
//   * the cache is read in its own type and in place (strides are arguments;
//     no cast, no contiguous copy, no f32 intermediate in device memory), 16
//     bytes a thread, neighbouring threads on neighbouring addresses: a slot's
//     row of hd values is TPS threads (hd 128 bf16: 16 threads of 8 values);
//   * one CTA reads each K/V tile once for all G query heads of its KV head;
//   * flash-decoding: the grid is (splits of `chunk` slots, B * KV), sized
//     from shapes alone (no host read of the lengths); a CTA whose split
//     starts at or past n_live[b] exits at once, so the work is proportional
//     to the live slots, sum_b n_live[b], and not to B x S;
//   * inside a CTA, TPS-thread groups each walk U slots at a time (all loads
//     of the U slots issued before the math), keep their own running max, sum
//     and f32 accumulator, and meet in shared memory at the end;
//   * a second small kernel combines each (b, head)'s splits' (m, l, acc)
//     partials, since CTAs run in no order.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // threads of a split CTA
constexpr int kMaxGroup = 8;       // query heads a KV head serves, at most

// 16 bytes of the cache's type, unpacked to f32.
template <typename T>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;  // values in 16 bytes
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float one(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float one(float x) { return x; }
};

__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }  // RNE
__device__ inline void store(float* p, float x) { *p = x; }

// The split CTA's layout for a type, head dim and group bound.
template <typename T, int HD, int GM>
struct Layout {
  static constexpr int kVec = Elt<T>::kVec;
  static constexpr int kTps = (HD / kVec) < 32 ? HD / kVec : 32;  // threads a slot
  static constexpr int kEpt = HD / kTps;                           // values a thread
  static constexpr int kNv = kEpt / kVec;                          // 16-byte loads a row
  static constexpr int kGroups = kThreads / kTps;                  // slot groups a CTA
  static constexpr int kU = GM >= 4 ? 2 : 4;                       // slots a group a step
  static_assert(kNv * kVec * kTps == HD, "head dim must be a multiple of 16 bytes x TPS");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const int* n_live;  // nullptr: every row S
  void* o;
  float* part_m;    // [B * KV, n_splits, G]
  float* part_l;    // [B * KV, n_splits, G]
  float* part_acc;  // [B * KV, n_splits, G, hd]
  float* m_out;     // [B, H] or nullptr
  float* l_out;
  int B, S, H, KV, G, chunk, n_splits;
  long long ksb, kss, ksh, vsb, vss, vsh, mask_stride;  // in elements
  float scale;
};

__device__ inline int live_slots(const Args& a, int b) {
  const int n = a.n_live ? a.n_live[b] : a.S;
  return n < 0 ? 0 : (n > a.S ? a.S : n);
}

__device__ inline uint4 load_stream(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));  // read once: evict first
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(const Args a) {
  using L = Layout<T, HD, GM>;
  constexpr int TPS = L::kTps, EPT = L::kEpt, NV = L::kNv, NG = L::kGroups, U = L::kU,
                VEC = L::kVec;
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / a.KV, kvh = bk % a.KV;
  const int nl = live_slots(a, b);
  const int s0 = split * a.chunk;
  if (s0 >= nl) return;  // past the row's live slots: nothing to read
  const int s1 = min(s0 + a.chunk, nl);
  const int tid = threadIdx.x, grp = tid / TPS, lane = tid % TPS;
  const int G = a.G;

  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  const uint8_t* mrow = a.mask + b * a.mask_stride;

  // this thread's values of the G queries: dims (j * TPS + lane) * VEC + e
  float qf[GM][EPT];
  {
    const T* qb = static_cast<const T*>(a.q) + (static_cast<long long>(b) * a.H + kvh * G) * HD;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (g < G) {
          Elt<T>::unpack(*reinterpret_cast<const uint4*>(qb + g * HD + (j * TPS + lane) * VEC),
                         &qf[g][j * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) qf[g][j * VEC + e] = 0.f;
        }
      }
    }
  }

  float m[GM], l[GM], acc[GM][EPT];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;  // below every score, NEG_INF included: the first slot sets it
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  }

  // the CTA steps over its split NG * U slots at a time (the same trip
  // count in every thread: the shuffles need whole warps); group grp takes
  // slots first .. first + U - 1 of each step
  for (int step = s0; step < s1; step += NG * U) {
    const int first = step + grp * U;
    float kf[U][EPT], vf[U][EPT];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = first + u;
      ok[u] = s < s1;
      uint4 kw[NV], vw[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (ok[u]) {
          const int d = (j * TPS + lane) * VEC;
          kw[j] = load_stream(kb + s * a.kss + d);
          vw[j] = load_stream(vb + s * a.vss + d);
        } else {
          kw[j] = make_uint4(0u, 0u, 0u, 0u);
          vw[j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Elt<T>::unpack(kw[j], &kf[u][j * VEC]);
        Elt<T>::unpack(vw[j], &vf[u][j * VEC]);
      }
    }
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) valid[u] = ok[u] && mrow[first + u] != 0;

    float sc[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        sc[u][g] = kNegInf;
        if (g < G) {  // G is the CTA's own: whole warps take the branch
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) d = fmaf(qf[g][e], kf[u][e], d);
#pragma unroll
          for (int off = TPS / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
          if (valid[u]) sc[u][g] = d * a.scale;
        }
      }
    }
    if (ok[0]) {  // the group holds at least one slot of this step
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) mx = fmaxf(mx, sc[u][g]);
        const float alpha = expf(m[g] - mx);  // 0 while m[g] is -inf
        float p[U], ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = ok[u] ? expf(sc[u][g] - mx) : 0.f;
          ps += p[u];
        }
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          float x = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) x = fmaf(p[u], vf[u][e], x);
          acc[g][e] = x;
        }
        m[g] = mx;
      }
    }
  }

  // the groups meet: each head's max over the groups, their sums and
  // accumulators rescaled to it and added; the split's partials written
  __shared__ float sm_m[NG][GM], sm_l[NG][GM];
  __shared__ float sm_acc[NG][HD];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
  }
  __syncthreads();
  const long long row = static_cast<long long>(bk) * a.n_splits + split;
  for (int g = 0; g < G; ++g) {
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < NG; ++i) M = fmaxf(M, sm_m[i][g]);
    float f = 0.f;  // a group that held no slot adds nothing
#pragma unroll
    for (int gg = 0; gg < GM; ++gg)
      if (gg == g) f = m[gg] == -INFINITY ? 0.f : expf(m[gg] - M);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = 0.f;
#pragma unroll
        for (int gg = 0; gg < GM; ++gg)
          if (gg == g) x = acc[gg][j * VEC + e];
        sm_acc[grp][(j * TPS + lane) * VEC + e] = x * f;
      }
    }
    __syncthreads();
    const long long at = row * G + g;
    for (int d = tid; d < HD; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NG; ++i) s += sm_acc[i][d];
      a.part_acc[at * HD + d] = s;
    }
    if (tid == 0) {
      float Ls = 0.f;
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (sm_m[i][g] != -INFINITY) Ls += sm_l[i][g] * expf(sm_m[i][g] - M);
      a.part_m[at] = M;
      a.part_l[at] = Ls;
    }
    __syncthreads();
  }
}

// One CTA of hd threads a (b, query head): the splits' partials combined.
template <typename T, typename O, int HD>
__global__ void __launch_bounds__(HD) decode_attn_combine_kernel(const Args a) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G, g = h % a.G;
  const int nl = live_slots(a, b);
  const int ns = (nl + a.chunk - 1) / a.chunk;
  const long long row = static_cast<long long>(b * a.KV + kvh) * a.n_splits;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, a.part_m[(row + s) * a.G + g]);
  float acc = 0.f, Ls = 0.f;
  if (M > kNegInf) {
    for (int s = 0; s < ns; ++s) {
      const long long at = (row + s) * a.G + g;
      const float w = expf(a.part_m[at] - M);
      Ls += a.part_l[at] * w;
      acc = fmaf(a.part_acc[at * HD + d], w, acc);
    }
    acc /= fmaxf(Ls, 1e-30f);
  } else {
    // no valid slot in the row: the reference's softmax over S scores of
    // NEG_INF is uniform, so the output is the mean of V over all S slots
    const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh + d;
    for (int s = 0; s < a.S; ++s) acc += Elt<T>::one(vb[s * a.vss]);
    acc /= static_cast<float>(a.S);
    Ls = static_cast<float>(a.S);
    M = kNegInf;
  }
  store(static_cast<O*>(a.o) + static_cast<long long>(bh) * HD + d, acc);
  if (a.m_out != nullptr && d == 0) {
    a.m_out[bh] = M;
    a.l_out[bh] = Ls;
  }
}

template <typename T, int HD, int GM>
cudaError_t launch_t(const Args& a, int out_f32, cudaStream_t st) {
  decode_attn_split_kernel<T, HD, GM><<<dim3(a.n_splits, a.B * a.KV), kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (out_f32)
    decode_attn_combine_kernel<T, float, HD><<<a.B * a.H, HD, 0, st>>>(a);
  else
    decode_attn_combine_kernel<T, T, HD><<<a.B * a.H, HD, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const Args& a, int out_f32, cudaStream_t st) {
  if (a.G <= 1) return launch_t<T, HD, 1>(a, out_f32, st);
  if (a.G <= 2) return launch_t<T, HD, 2>(a, out_f32, st);
  if (a.G <= 4) return launch_t<T, HD, 4>(a, out_f32, st);
  return launch_t<T, HD, kMaxGroup>(a, out_f32, st);
}

template <typename T>
cudaError_t launch_hd(const Args& a, int hd, int out_f32, cudaStream_t st) {
  switch (hd) {
    case 32: return launch_g<T, 32>(a, out_f32, st);
    case 64: return launch_g<T, 64>(a, out_f32, st);
    case 128: return launch_g<T, 128>(a, out_f32, st);
    case 256: return launch_g<T, 256>(a, out_f32, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 f32; out_f32: the output in f32 and the row's m and l in
// m_out / l_out (the sequence-split combine), else the output in the cache's
// type and m_out / l_out unused (nullptr).
int dsa_decode_attention(const void* q, const void* k, const void* v, const void* mask,
                         const void* n_live, void* o, void* part_m, void* part_l,
                         void* part_acc, void* m_out, void* l_out, int B, int S, int H,
                         int KV, int hd, int chunk, int n_splits, long long ksb,
                         long long kss, long long ksh, long long vsb, long long vss,
                         long long vsh, long long mask_stride, float scale, int dtype,
                         int out_f32, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || chunk <= 0 || n_splits <= 0 ||
      B * KV > 65535 || (out_f32 && (m_out == nullptr || l_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const uint8_t*>(mask), static_cast<const int*>(n_live), o,
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), static_cast<float*>(m_out), static_cast<float*>(l_out),
         B, S, H, KV, H / KV, chunk, n_splits, ksb, kss, ksh, vsb, vss, vsh, mask_stride,
         scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_hd<__nv_bfloat16>(a, hd, out_f32, st)
                               : launch_hd<float>(a, hd, out_f32, st);
  return static_cast<int>(err);
}

}  // extern "C"
