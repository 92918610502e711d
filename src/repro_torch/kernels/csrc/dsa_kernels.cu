// Hand-written Hopper kernels (sm_90a) for the repro_torch offload engine.
//
// Built by kernels/_build.py with nvcc into a shared library with a plain C
// interface and loaded with ctypes.  Every entry point launches on the stream
// it is given, allocates nothing (the Python wrapper allocates outputs with
// torch.empty), and returns cudaGetLastError() so the wrapper can raise on a
// launch that CUDA refused.  Words are uint32; buffers are contiguous.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
// Enough 256-thread CTAs to keep every SM of an H100 (132 SMs) full; a
// grid-stride loop covers anything larger.
constexpr int kMaxCopyBlocks = 132 * 8;
// CRC chains (sub-chunks) per CTA.
constexpr int kCrcThreads = 256;
// Words of every sub-chunk but a chunk's first (kernels/crc32.py SUB_WORDS).
constexpr int kSubWords = 128;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// ------------------------------------------------------------------ memcpy_words
// Replaces kernels/memcpy.py memcpy_words / _memcpy_kernel (Pallas).
// Bound: bytes.  A copy reads and writes each word once, so device-memory
// bandwidth (3.35 TB/s on an H100 SXM) is the limit.
// Design: the buffer splits into n_pe contiguous spans (blockIdx.y), the DSA
// PE lanes of the reference grid; the span bounds are explicit, so the
// 128-lane padding of the Pallas word grid is not needed.  Two kernels, by
// span size (launch_memcpy):
// - spans of at least one full ring per SM (kCopyStages x kCopyChunk bytes
//   times the SM count: 16.5 MiB on an H100 SXM), 16-byte aligned
//   (memcpy_bulk_kernel): a persistent grid of one CTA per SM, each running
//   a ring of kCopyStages TMA bulk copies of kCopyChunk bytes
//   (cp.async.bulk global -> shared on an mbarrier, then shared -> global);
//   one thread issues them and spends no registers on the data, and each SM
//   keeps up to three 32 KiB loads in flight while one chunk stores.  Of the
//   designs tools/memcpy_variants.py times at 1 GiB (loops of 1-8 16-byte
//   loads a thread with default, streaming and no-allocate hints; rings of
//   other depths, chunk sizes, CTAs per SM, chunk orders and L2 policies)
//   it was among the fastest: 88.4-88.7 % of the bound against 86.3 % for
//   the loop below, still about 2 % slower than Tensor.copy_.
// - smaller or unaligned spans (memcpy_words_kernel): a grid-stride loop
//   moves 16-byte uint4 words, so a warp issues 512 contiguous bytes per
//   load and store; a scalar loop copies the ragged tail (all of an
//   unaligned span).  Below ~16 MiB a ring per SM leaves SMs idle, and this
//   loop is as fast as any variant tried (4 KiB and 1 MiB).
constexpr int kCopyChunk = 32 * 1024;  // bytes of one bulk copy
constexpr int kCopyStages = 4;         // bulk copies in flight per SM (one storing)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One warp per CTA; lane 0 runs the ring over chunks blockIdx.x, blockIdx.x +
// gridDim.x, ... of its span.  The span's last 1-3 words (when its length is
// not a multiple of 16 bytes) go word by word through lanes 1-3 of CTA 0.
__global__ void __launch_bounds__(32)
memcpy_bulk_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                   long long n, long long span) {
  extern __shared__ __align__(128) uint8_t ring[];  // kCopyStages chunks, then the mbarriers
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kCopyStages * kCopyChunk);
  const long long begin = static_cast<long long>(blockIdx.y) * span;
  const long long end = min(begin + span, n);
  if (begin >= end) return;
  const long long bytes = (end - begin) * 4 / 16 * 16;
  const int lane = threadIdx.x;
  if (blockIdx.x == 0 && lane >= 1 && begin + bytes / 4 + lane - 1 < end) {
    const long long i = begin + bytes / 4 + lane - 1;
    dst[i] = src[i];
  }
  if (lane != 0) return;
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src + begin);
  uint8_t* d = reinterpret_cast<uint8_t*>(dst + begin);
  for (int st = 0; st < kCopyStages; ++st)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[st]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long n_chunks = (bytes + kCopyChunk - 1) / kCopyChunk;
  const long long mine =
      n_chunks > blockIdx.x ? (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto offset = [&](long long j) { return (blockIdx.x + j * gridDim.x) * kCopyChunk; };
  auto size = [&](long long j) {
    return static_cast<uint32_t>(min(static_cast<long long>(kCopyChunk), bytes - offset(j)));
  };
  auto load = [&](long long j) {
    const int st = static_cast<int>(j % kCopyStages);
    const uint32_t bar = smem_addr(&full[st]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(size(j))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(ring + st * kCopyChunk)),
        "l"(s + offset(j)), "r"(size(j)), "r"(bar)
        : "memory");
  };
  for (long long j = 0; j < mine && j < kCopyStages; ++j) load(j);
  for (long long j = 0; j < mine; ++j) {
    const int st = static_cast<int>(j % kCopyStages);
    const uint32_t parity = static_cast<uint32_t>((j / kCopyStages) & 1);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&full[st])), "r"(parity)
          : "memory");
    }
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     d + offset(j)),
                 "r"(smem_addr(ring + st * kCopyChunk)), "r"(size(j))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage of chunk j - 1 once its store has read it
    if (j >= 1 && j - 1 + kCopyStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(j - 1 + kCopyStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void memcpy_words_kernel(const uint32_t* __restrict__ src,
                                    uint32_t* __restrict__ dst, long long n,
                                    long long span, bool vec) {
  const long long begin = static_cast<long long>(blockIdx.y) * span;
  const long long end = min(begin + span, n);
  if (begin >= end) return;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = (end - begin) / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + begin);
    uint4* d4 = reinterpret_cast<uint4*>(dst + begin);
    for (long long i = tid; i < nv; i += stride) d4[i] = s4[i];
    done = nv * 4;
  }
  for (long long i = begin + done + tid; i < end; i += stride) dst[i] = src[i];
}

// ------------------------------------------------------------------ batch_copy_pages
// Replaces kernels/batch_copy.py batch_copy_pages / _batch_copy_kernel.
// Bound: bytes.  Each copied page is read once and written once.
// Design: one CTA per descriptor loads its own src_idx[i] and dst_idx[i]
// (Hopper has no scalar prefetch) and copies one page with 16-byte loads.
// The Pallas grid ran descriptors in order, so a later descriptor with the same
// destination overwrote an earlier one.  CTAs run in no order here, so CTA i
// first scans dst_idx[i+1..n) and skips its copy when a later descriptor
// writes the same page: last writer wins without serialising the batch.
// Pages named outside the pools are skipped (the wrapper validates first).
__global__ void batch_copy_pages_kernel(const uint32_t* __restrict__ src_pool,
                                        uint32_t* __restrict__ dst_pool,
                                        const int32_t* __restrict__ src_idx,
                                        const int32_t* __restrict__ dst_idx,
                                        int n, long long n_src, long long n_dst,
                                        long long page_words, bool vec) {
  const int i = blockIdx.x;
  const int s = src_idx[i];
  const int d = dst_idx[i];
  int later = 0;
  for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x)
    later |= (dst_idx[j] == d);
  if (__syncthreads_or(later)) return;
  if (s < 0 || s >= n_src || d < 0 || d >= n_dst) return;
  const uint32_t* sp = src_pool + static_cast<long long>(s) * page_words;
  uint32_t* dp = dst_pool + static_cast<long long>(d) * page_words;
  long long done = 0;
  if (vec) {
    const long long nv = page_words / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(sp);
    uint4* d4 = reinterpret_cast<uint4*>(dp);
    for (long long k = threadIdx.x; k < nv; k += blockDim.x) d4[k] = s4[k];
    done = nv * 4;
  }
  for (long long k = done + threadIdx.x; k < page_words; k += blockDim.x)
    dp[k] = sp[k];
}

// ------------------------------------------------------------------ crc32_chunk_states / copy_crc_words
// Replaces kernels/crc32.py crc32_chunk_states / _crc_kernel / _crc_step
// (kCopy = false) and kernels/fused.py copy_crc_words / _copy_crc_kernel
// (kCopy = true).
// Bound: bytes (each word is read once; about 15 integer operations per word
// are far below the card's rate).  A CRC is a chain of dependent steps, and
// the JAX package's chunk choice gives at most 256 chunks, so one chain per
// chunk leaves the card nearly idle (0.3 % of the bound at 1 GiB, PERF.md).
// Design: each chunk of W words splits into S sub-chunks (crc32.py
// subchunk_plan): words [0, h), then S - 1 of kSubWords words, so only the
// first is short.  One thread per (chunk, sub-chunk) runs the slice-by-4 step
// over its words (four shared-memory lookups and four xors a word, the
// [4,256] tables in shared memory, 4 KiB per CTA) and writes the sub-chunk's
// finished zlib CRC to crcs[c * S + k]; crc_fold_kernel folds them into the
// chunk states.  Where S = 1 the CRCs are the states and nothing else runs.
// At 1 GiB (C = 256, W = 1 Mi words) that is 2 Mi chains of 512 bytes, about
// eight waves of the card's resident threads; of 128 and 256 words,
// 128 was as fast at 1 GiB and faster for the copy and at 1 MiB (PERF.md).  With `vec` (every whole
// sub-chunk starts 16-byte aligned) a thread issues four 16-byte loads, its
// two 32-byte sectors whole, before the 16 dependent steps on them; the copy
// variant stores what it loaded, also 16 bytes at a time.  The first
// sub-chunk, and every word without `vec`, goes one 4-byte word at a time.
__device__ __forceinline__ uint32_t crc_step(const uint32_t (*t)[256], uint32_t st,
                                             uint32_t word) {
  const uint32_t x = st ^ word;
  return t[3][x & 0xFFu] ^ t[2][(x >> 8) & 0xFFu] ^ t[1][(x >> 16) & 0xFFu] ^
         t[0][x >> 24];
}

template <bool kCopy>
__global__ void __launch_bounds__(kCrcThreads)
crc_chunks_kernel(const uint32_t* __restrict__ data, const uint32_t* __restrict__ tables,
                  uint32_t* __restrict__ crcs, uint32_t* __restrict__ dst, int C,
                  long long W, int S, long long h, bool vec) {
  __shared__ uint32_t t[4][256];
  for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x)
    t[k >> 8][k & 255] = tables[k];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(C) * S) return;
  const long long c = i / S;
  const int k = static_cast<int>(i - c * S);
  const long long begin =
      c * W + (k == 0 ? 0 : h + static_cast<long long>(k - 1) * kSubWords);
  const long long n = k == 0 ? h : kSubWords;
  const uint32_t* p = data + begin;
  uint32_t* q = kCopy ? dst + begin : nullptr;
  uint32_t st = 0xFFFFFFFFu;
  long long w = 0;
  if (vec && k > 0) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    uint4* q4 = reinterpret_cast<uint4*>(q);
    for (; w < n; w += 16) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = p4[w / 4 + j];
      if (kCopy) {
#pragma unroll
        for (int j = 0; j < 4; ++j) q4[w / 4 + j] = v[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st = crc_step(t, st, v[j].x);
        st = crc_step(t, st, v[j].y);
        st = crc_step(t, st, v[j].z);
        st = crc_step(t, st, v[j].w);
      }
    }
  }
  for (; w < n; ++w) {
    const uint32_t word = p[w];
    if (kCopy) q[w] = word;
    st = crc_step(t, st, word);
  }
  crcs[i] = st ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------------ crc_fold (gf2_fold)
// Replaces kernels/crc32.py combine_chunk_crcs / gf2_apply, which the JAX
// package runs as jnp outside the Pallas kernel, and folds the CRC pair's
// sub-chunk CRCs into chunk states.
// Bound: latency.  The bytes are a few MiB at most; the time is chains of
// dependent 32-term GF(2) matrix-vector products (zlib's crc32_combine).
// Design: crcs holds G groups of S finished CRCs, every one but a group's
// first of the length base_mat advances over; out[g] is group g's CRC.  One
// warp a group (crc32.py fold_crcs_plain is the same schedule in PyTorch):
//   1. lane b builds column b of base^(2^i), i < bit length of S, by
//      squaring in shared memory;
//   2. the S CRCs split into 32 contiguous ranges, left to right, lane 0's
//      holding CRC 0 (lanes right of the last CRC get none when S < 32);
//   3. each lane folds its range serially, acc = base acc ^ crc, from 0;
//   4. five shuffle levels join lane pairs left to right, each carrying
//      (acc, count): acc_left = base^count_right acc_left ^ acc_right, one
//      product per set bit of count_right, then the counts add.  An empty
//      range (count 0, acc 0: the CRC of no bytes) leaves its partner as it
//      was.
// The serial part is S / 32 products a lane and at most 5 x (bit length of
// S) in the tree, against S - 1 on one thread before.
constexpr int kFoldLanes = 32;

// GF(2): the matrix of columns m[0..31] times v.
__device__ __forceinline__ uint32_t gf2_times(const uint32_t* m, uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) s ^= m[b] & (0u - ((v >> b) & 1u));
  return s;
}

__global__ void __launch_bounds__(kFoldLanes)
crc_fold_kernel(const uint32_t* __restrict__ crcs, const uint32_t* __restrict__ base_mat,
                uint32_t* __restrict__ out, int G, int S) {
  __shared__ uint32_t pw[32][kFoldLanes];  // pw[i] = base^(2^i), i < bit length of S
  const int lane = threadIdx.x;
  const int g = blockIdx.x;
  const int n_pow = 32 - __clz(S);
  pw[0][lane] = base_mat[lane];
  __syncwarp();
  for (int i = 1; i < n_pow; ++i) {
    const uint32_t col = gf2_times(pw[i - 1], pw[i - 1][lane]);
    pw[i][lane] = col;
    __syncwarp();
  }
  uint32_t m[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) m[b] = pw[0][b];
  const int q = S / kFoldLanes, r = S % kFoldLanes;
  int count = q + (lane < r ? 1 : 0);
  const uint32_t* x = crcs + static_cast<long long>(g) * S + lane * q + min(lane, r);
  uint32_t acc = 0;
  for (int k = 0; k < count; ++k) acc = gf2_times(m, acc) ^ x[k];
  for (int d = 1; d < kFoldLanes; d <<= 1) {
    const uint32_t acc_right = __shfl_down_sync(0xFFFFFFFFu, acc, d);
    const int count_right = __shfl_down_sync(0xFFFFFFFFu, count, d);
    if ((lane & (2 * d - 1)) == 0) {
      for (int i = 0; i < n_pow; ++i)
        if ((count_right >> i) & 1) acc = gf2_times(pw[i], acc);
      acc ^= acc_right;
      count += count_right;
    }
  }
  if (lane == 0) out[g] = acc;
}

// ------------------------------------------------------------------ fill_words
// Replaces kernels/fill.py fill_words / _fill_kernel.
// Bound: bytes.  A fill reads nothing and writes each word once.
// Design: the <= 4 pattern words arrive by value as one uint4 kernel argument
// (a pattern of 1 or 2 words is repeated to 4), so a fill needs no
// host-to-device copy.  p divides 4 and every span starts on a multiple of 4
// words, so the uint4 is position-independent on a 16-byte-aligned output:
// each thread stores it whole, a warp writes 512 contiguous bytes per store.
// The ragged tail takes word i % 4 of the pattern.  n_pe spans as in memcpy.
__global__ void fill_words_kernel(uint32_t* __restrict__ dst, long long n,
                                  long long span, uint4 pat, bool vec) {
  const long long begin = static_cast<long long>(blockIdx.y) * span;
  const long long end = min(begin + span, n);
  if (begin >= end) return;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = (end - begin) / 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst + begin);
    for (long long i = tid; i < nv; i += stride) d4[i] = pat;
    done = nv * 4;
  }
  const uint32_t w[4] = {pat.x, pat.y, pat.z, pat.w};
  for (long long i = begin + done + tid; i < end; i += stride) dst[i] = w[i & 3];
}

// ------------------------------------------------------------------ compare_words
// Replaces kernels/compare.py compare_words / _compare_kernel together with
// the jnp reduction of its per-block records in ops.compare.
// Bound: bytes, the two buffers read once each.
// Design: a grid-stride loop of 16-byte loads; each thread stops at its first
// mismatch (its later words have larger indices).  finish_first_diff turns
// the threads' first mismatches into the pair (equal?, first | -1) on the
// card, so the result needs no host sync and no reduction launch.
constexpr unsigned kNoDiff = 0xFFFFFFFFu;

// Bit k set where word k of the two 4-word groups differs.
__device__ inline unsigned diff_mask4(const uint4 x, const uint4 y) {
  return (x.x != y.x) | (x.y != y.y) << 1 | (x.z != y.z) << 2 |
         (x.w != y.w) << 3;
}

// The reduction shared by compare_words, compare_pattern_words and
// fill_verify_words.  Every thread of the CTA calls it with its own first
// mismatching word index (kNoDiff for none).  The warp's least index goes to
// state[0] by one __reduce_min_sync and one atomicMin per warp; the last CTA
// to finish (a ticket in state[1]) writes (equal?, first | -1).  state is
// set to {kNoDiff, 0} by reset_first_diff on the stream before the launch.
__device__ inline void finish_first_diff(unsigned mine,
                                         unsigned* __restrict__ state,
                                         bool* __restrict__ equal,
                                         int32_t* __restrict__ first) {
  mine = __reduce_min_sync(0xFFFFFFFFu, mine);
  if ((threadIdx.x & 31) == 0 && mine != kNoDiff) atomicMin(&state[0], mine);
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&state[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned f = atomicAdd(&state[0], 0u);
    *equal = f == kNoDiff;
    *first = f == kNoDiff ? -1 : static_cast<int32_t>(f);
  }
}

__global__ void compare_words_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     long long n, bool vec,
                                     unsigned* __restrict__ state,
                                     bool* __restrict__ equal,
                                     int32_t* __restrict__ first) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned mine = kNoDiff;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    for (long long i = tid; i < nv; i += stride) {
      const unsigned m = diff_mask4(a4[i], b4[i]);
      if (m) {
        mine = static_cast<unsigned>(4 * i) + (__ffs(m) - 1);
        break;
      }
    }
    done = nv * 4;
  }
  if (mine == kNoDiff) {
    for (long long i = done + tid; i < n; i += stride) {
      if (a[i] != b[i]) {
        mine = static_cast<unsigned>(i);
        break;
      }
    }
  }
  finish_first_diff(mine, state, equal, first);
}

// ------------------------------------------------------------------ compare_pattern_words
// Replaces kernels/compare.py compare_pattern_words / _compare_pattern_kernel
// together with the jnp reduction of its per-block records (and the mask of
// the padding words) in ops.compare_pattern.
// Bound: bytes, the buffer read once; the pattern is a kernel argument.
// Design: word i is expected to equal pattern[i % p].  The <= 4 pattern words
// arrive by value as one uint4 (a pattern of 1 or 2 words repeated to 4, as
// in fill_words), and p divides 4, so 16-byte group g expects that uint4
// whole and the ragged tail word i expects its word i % 4.  Each thread stops
// at its first mismatch and finish_first_diff reduces on the card.  The
// buffer has no padding here, so only real words are ever compared.
__global__ void compare_pattern_kernel(const uint32_t* __restrict__ a,
                                       long long n, uint4 pat, bool vec,
                                       unsigned* __restrict__ state,
                                       bool* __restrict__ equal,
                                       int32_t* __restrict__ first) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned mine = kNoDiff;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    for (long long i = tid; i < nv; i += stride) {
      const unsigned m = diff_mask4(a4[i], pat);
      if (m) {
        mine = static_cast<unsigned>(4 * i) + (__ffs(m) - 1);
        break;
      }
    }
    done = nv * 4;
  }
  if (mine == kNoDiff) {
    const uint32_t w[4] = {pat.x, pat.y, pat.z, pat.w};
    for (long long i = done + tid; i < n; i += stride) {
      if (a[i] != w[i & 3]) {
        mine = static_cast<unsigned>(i);
        break;
      }
    }
  }
  finish_first_diff(mine, state, equal, first);
}

// ------------------------------------------------------------------ fill_verify_words
// Replaces kernels/fused.py fill_verify_words / _fill_verify_kernel together
// with the jnp reduction of its per-block records in ops.fill_verify.
// Bound: bytes, each word written once (the readback is the verify's own
// cost, and the words it reads were just written, so they come from the L2).
// Design: fill_words's uint4 stores, then each thread reads back what it
// stored and compares it with the pattern; finish_first_diff reduces the
// mismatches on the card, as compare_pattern_words does.  A plain load of an
// address the thread has just stored to may be served from the register the
// compiler still holds, which would turn the verify into a constant.  The
// readback is therefore an ld.volatile.global in inline PTX with a "memory"
// clobber: the compiler must issue it after the store and may neither drop it
// nor forward the stored value, so the word comes from the memory system.
// (A readback of another thread's words after __syncthreads would need a
// second pass over a CTA-sized tile; the volatile load keeps one loop.)
// Each thread stores kVerifyUnroll groups before it reads them back, so four
// loads are in flight at once instead of one round trip per store.  A thread
// that has found a mismatch goes on filling and stops checking.
constexpr int kVerifyUnroll = 4;

__device__ inline uint4 load_volatile(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ inline uint32_t load_volatile(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.volatile.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__global__ void fill_verify_kernel(uint32_t* __restrict__ dst, long long n,
                                   uint4 pat, bool vec,
                                   unsigned* __restrict__ state,
                                   bool* __restrict__ equal,
                                   int32_t* __restrict__ first) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned mine = kNoDiff;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i0 = tid; i0 < nv; i0 += kVerifyUnroll * stride) {
#pragma unroll
      for (int k = 0; k < kVerifyUnroll; ++k) {
        const long long i = i0 + k * stride;
        if (i < nv) d4[i] = pat;
      }
#pragma unroll
      for (int k = 0; k < kVerifyUnroll; ++k) {
        const long long i = i0 + k * stride;
        if (i < nv && mine == kNoDiff) {
          const unsigned m = diff_mask4(load_volatile(d4 + i), pat);
          if (m) mine = static_cast<unsigned>(4 * i) + (__ffs(m) - 1);
        }
      }
    }
    done = nv * 4;
  }
  const uint32_t w[4] = {pat.x, pat.y, pat.z, pat.w};
  for (long long i = done + tid; i < n; i += stride) {
    dst[i] = w[i & 3];
    if (mine == kNoDiff && load_volatile(dst + i) != w[i & 3])
      mine = static_cast<unsigned>(i);
  }
  finish_first_diff(mine, state, equal, first);
}

// ------------------------------------------------------------------ dualcast_words
// Replaces kernels/dualcast.py dualcast_words / _dualcast_kernel.
// Bound: bytes, the source read once and two destinations written once each
// (3 x the buffer).
// Design: one grid-stride pass; each 16-byte group is loaded once into
// registers and stored to both destinations; a scalar loop takes the ragged
// tail (and the whole buffer when a pointer is not 16-byte aligned).  The
// JAX kernel has no PE spans, so neither has this one.
__global__ void dualcast_words_kernel(const uint32_t* __restrict__ src,
                                      uint32_t* __restrict__ d1,
                                      uint32_t* __restrict__ d2, long long n,
                                      bool vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* a4 = reinterpret_cast<uint4*>(d1);
    uint4* b4 = reinterpret_cast<uint4*>(d2);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 v = s4[i];
      a4[i] = v;
      b4[i] = v;
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const uint32_t v = src[i];
    d1[i] = v;
    d2[i] = v;
  }
}

// ------------------------------------------------------------------ delta_record_words
// Replaces kernels/delta_create.py delta_mask_words / _delta_mask_kernel
// together with the jnp compaction of ops.delta_create (jnp.nonzero with
// size=cap): the fixed-capacity record (offsets ascending, -1 pads; data,
// 0 pads; the true count; overflow = count > cap) is built on the card.
// Bound: bytes, src and ref read once plus cap * 8 bytes of record written.
// Design: two passes over tiles of kDeltaTileGroups groups of 4 words.
//   1. delta_count_kernel reads src and ref once (16-byte loads), stores one
//      byte per group holding its 4-bit diff mask (n / 4 bytes, 1/16 of one
//      input) and the tile's mismatch count.
//   2. The wrapper's torch.cumsum of the per-tile counts (glue, as jnp glue
//      is on the JAX side) gives each tile its first record slot.
//   3. delta_write_kernel re-reads only the byte masks: a warp shuffle scan
//      and a scan of the warp totals give each thread its slot in ascending
//      word order, and each differing word's value is gathered from src.  A
//      tile whose first slot is at or past cap returns at once, so the cap
//      also caps the work.  All CTAs write the pads and CTA 0 the count.
// Nothing is read back to the host.
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kDeltaRounds = 4;
constexpr long long kDeltaTileGroups =
    static_cast<long long>(kScanThreads) * kDeltaRounds;  // 4096 words a tile

__device__ inline unsigned diff_nibble(const uint32_t* __restrict__ s,
                                       const uint32_t* __restrict__ r,
                                       long long g, long long n, bool vec) {
  const long long w = 4 * g;
  if (vec && w + 4 <= n)
    return diff_mask4(reinterpret_cast<const uint4*>(s)[g],
                      reinterpret_cast<const uint4*>(r)[g]);
  unsigned m = 0;
  for (int k = 0; k < 4; ++k)
    if (w + k < n && s[w + k] != r[w + k]) m |= 1u << k;
  return m;
}

__global__ void delta_count_kernel(const uint32_t* __restrict__ src,
                                   const uint32_t* __restrict__ ref,
                                   long long n, bool vec,
                                   uint8_t* __restrict__ mask,
                                   int32_t* __restrict__ counts) {
  const long long n_groups = (n + 3) / 4;
  const long long g0 = static_cast<long long>(blockIdx.x) * kDeltaTileGroups;
  int c = 0;
  for (int r = 0; r < kDeltaRounds; ++r) {
    const long long g = g0 + r * kScanThreads + threadIdx.x;
    if (g < n_groups) {
      const unsigned m = diff_nibble(src, ref, g, n, vec);
      mask[g] = static_cast<uint8_t>(m);
      c += __popc(m);
    }
  }
  __shared__ int warp_sum[kScanWarps];
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kScanWarps; ++w) t += warp_sum[w];
    counts[blockIdx.x] = t;
  }
}

__device__ inline int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void delta_write_kernel(const uint32_t* __restrict__ src,
                                   long long n,
                                   const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ incl,
                                   int n_tiles, long long cap,
                                   int32_t* __restrict__ offsets,
                                   uint32_t* __restrict__ data,
                                   int32_t* __restrict__ count_out,
                                   bool* __restrict__ overflow_out) {
  const long long total = n_tiles ? incl[n_tiles - 1] : 0;
  const long long gstride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = min(total, cap) +
                     static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < cap; p += gstride) {
    offsets[p] = -1;
    data[p] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count_out = static_cast<int32_t>(total);
    *overflow_out = total > cap;
  }
  if (static_cast<int>(blockIdx.x) >= n_tiles) return;
  const int tile_count = counts[blockIdx.x];
  long long base = static_cast<long long>(incl[blockIdx.x]) - tile_count;
  if (tile_count == 0 || base >= cap) return;  // uniform in the CTA

  __shared__ int warp_tot[kScanWarps];
  __shared__ int warp_pre[kScanWarps];
  __shared__ int round_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_groups = (n + 3) / 4;
  const long long g0 = static_cast<long long>(blockIdx.x) * kDeltaTileGroups;
  for (int r = 0; r < kDeltaRounds; ++r) {
    const long long g = g0 + r * kScanThreads + threadIdx.x;
    const unsigned m = g < n_groups ? mask[g] : 0u;
    const int c = __popc(m);
    const int incl_w = warp_inclusive_scan(c, lane);
    if (lane == 31) warp_tot[warp] = incl_w;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kScanWarps ? warp_tot[lane] : 0;
      const int iv = warp_inclusive_scan(v, lane);
      if (lane < kScanWarps) warp_pre[lane] = iv - v;
      if (lane == kScanWarps - 1) round_total = iv;
    }
    __syncthreads();
    long long pos = base + warp_pre[warp] + incl_w - c;
    for (unsigned mm = m; mm; mm &= mm - 1) {
      if (pos < cap) {
        const long long w = 4 * g + (__ffs(mm) - 1);
        offsets[pos] = static_cast<int32_t>(w);
        data[pos] = src[w];
      }
      ++pos;
    }
    base += round_total;
    if (base >= cap) break;  // uniform: every thread read the same total
  }
}

// ------------------------------------------------------------------ delta_apply_words
// Replaces kernels/delta_apply.py delta_apply_words / _delta_apply_kernel.
// Bound: bytes, ref read and out written once plus the record read.
// Semantics: out = ref, then the entries in record order, skipping
// off < 0 (pads) and off >= n; of entries naming one word the last wins.
// The Pallas kernel walked the record serially on one core.  CTAs run in no
// order, so duplicates take an explicit rule that stays O(cap) for a
// checkpoint-sized record (millions of entries), where batch_copy's scan of
// later entries would be O(cap^2).  The rule uses the output word itself as
// the claim slot, so it needs no scratch of the buffer's size:
//   1. out = ref (the copy kernel);
//   2. every valid entry zeroes out[off];
//   3. every valid entry i does atomicMax(out[off], i + 1): the word now
//      names its last writer;
//   4. entry i is the winner iff out[off] == i + 1 (a byte in win[], since
//      a winner's store must not race a loser's read);
//   5. winners store data[i].
// Each of 2-5 is one grid-stride pass over the record; offsets on the card
// are never read back to the host.
__global__ void delta_zero_kernel(uint32_t* __restrict__ out, long long n,
                                  const int32_t* __restrict__ offsets,
                                  long long cap) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t off = offsets[i];
    if (off >= 0 && off < n) out[off] = 0;
  }
}

__global__ void delta_claim_kernel(uint32_t* __restrict__ out, long long n,
                                   const int32_t* __restrict__ offsets,
                                   long long cap) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t off = offsets[i];
    if (off >= 0 && off < n)
      atomicMax(reinterpret_cast<unsigned*>(out) + off,
                static_cast<unsigned>(i + 1));
  }
}

__global__ void delta_mark_kernel(const uint32_t* __restrict__ out,
                                  long long n,
                                  const int32_t* __restrict__ offsets,
                                  long long cap, uint8_t* __restrict__ win) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t off = offsets[i];
    win[i] = off >= 0 && off < n && out[off] == static_cast<uint32_t>(i + 1);
  }
}

__global__ void delta_store_kernel(uint32_t* __restrict__ out,
                                   const int32_t* __restrict__ offsets,
                                   const uint32_t* __restrict__ data,
                                   long long cap,
                                   const uint8_t* __restrict__ win) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (win[i]) out[offsets[i]] = data[i];
  }
}

inline unsigned grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  if (blocks > kMaxCopyBlocks) blocks = kMaxCopyBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// The memcpy launch shared by dsa_memcpy_words and dsa_delta_apply_words.
void launch_memcpy(const void* src, void* dst, long long n_words, int n_pe,
                   cudaStream_t stream) {
  long long span = (n_words + n_pe - 1) / n_pe;
  span = (span + 3) / 4 * 4;  // keeps every span 16-byte aligned
  const bool vec = aligned16(src) && aligned16(dst);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (vec && span * 4 >= static_cast<long long>(sms) * kCopyStages * kCopyChunk) {
    // one CTA per SM, shared among the spans; the ring is above the 48 KB a
    // CTA gets unasked (a failure here shows in the launch's error)
    constexpr int bytes = kCopyStages * (kCopyChunk + 8);
    cudaFuncSetAttribute(memcpy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    const unsigned bx = static_cast<unsigned>(n_pe < sms ? sms / n_pe : 1);
    memcpy_bulk_kernel<<<dim3(bx, n_pe), 32, bytes, stream>>>(
        static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), n_words, span);
    return;
  }
  const long long per_span_blocks =
      ((span + 3) / 4 + kCopyThreads - 1) / kCopyThreads;
  long long cap = kMaxCopyBlocks / n_pe;
  if (cap < 1) cap = 1;
  const unsigned bx =
      static_cast<unsigned>(per_span_blocks < cap ? per_span_blocks : cap);
  memcpy_words_kernel<<<dim3(bx, n_pe), kCopyThreads, 0, stream>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), n_words,
      span, vec);
}

// Sets the scratch of finish_first_diff to {kNoDiff, 0} on the stream.
cudaError_t reset_first_diff(unsigned* state, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(state, 0xFF, sizeof(unsigned), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(state + 1, 0, sizeof(unsigned), s);
  return err;
}

// The CRC pair writes C x S sub-chunk CRCs to crcs (S = ceil(W / kSubWords),
// at least 1): the chunk states themselves where S = 1, else the scratch that
// dsa_crc_fold folds.
cudaError_t launch_crc_chunks(const void* data, const void* tables, void* crcs, void* dst,
                              int C, long long W, void* stream) {
  const int S = static_cast<int>(W > kSubWords ? (W + kSubWords - 1) / kSubWords : 1);
  const long long h = W - static_cast<long long>(S - 1) * kSubWords;
  const uint32_t* d = static_cast<const uint32_t*>(data);
  const bool vec = S > 1 && (C == 1 || W % 4 == 0) && aligned16(d + h) &&
                   (dst == nullptr || aligned16(static_cast<uint32_t*>(dst) + h));
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(C) * S + kCrcThreads - 1) / kCrcThreads);
  if (dst == nullptr)
    crc_chunks_kernel<false><<<blocks, kCrcThreads, 0, as_stream(stream)>>>(
        d, static_cast<const uint32_t*>(tables), static_cast<uint32_t*>(crcs), nullptr, C, W,
        S, h, vec);
  else
    crc_chunks_kernel<true><<<blocks, kCrcThreads, 0, as_stream(stream)>>>(
        d, static_cast<const uint32_t*>(tables), static_cast<uint32_t*>(crcs),
        static_cast<uint32_t*>(dst), C, W, S, h, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int dsa_memcpy_words(const void* src, void* dst, long long n_words, int n_pe,
                     void* stream) {
  launch_memcpy(src, dst, n_words, n_pe, as_stream(stream));
  return static_cast<int>(cudaGetLastError());
}

int dsa_batch_copy_pages(const void* src_pool, void* dst_pool,
                         const void* src_idx, const void* dst_idx, int n,
                         long long n_src, long long n_dst,
                         long long page_words, void* stream) {
  const bool vec =
      page_words % 4 == 0 && aligned16(src_pool) && aligned16(dst_pool);
  batch_copy_pages_kernel<<<n, kCopyThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(src_pool), static_cast<uint32_t*>(dst_pool),
      static_cast<const int32_t*>(src_idx), static_cast<const int32_t*>(dst_idx),
      n, n_src, n_dst, page_words, vec);
  return static_cast<int>(cudaGetLastError());
}

int dsa_crc32_chunk_states(const void* data, const void* tables, void* crcs, int C,
                           long long W, void* stream) {
  return static_cast<int>(launch_crc_chunks(data, tables, crcs, nullptr, C, W, stream));
}

int dsa_copy_crc_words(const void* data, const void* tables, void* crcs, void* dst, int C,
                       long long W, void* stream) {
  return static_cast<int>(launch_crc_chunks(data, tables, crcs, dst, C, W, stream));
}

int dsa_crc_fold(const void* crcs, const void* base_mat, void* out, int G, int S,
                 void* stream) {
  crc_fold_kernel<<<G, kFoldLanes, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(crcs), static_cast<const uint32_t*>(base_mat),
      static_cast<uint32_t*>(out), G, S);
  return static_cast<int>(cudaGetLastError());
}

int dsa_fill_words(void* dst, long long n_words, int n_pe, unsigned p0,
                   unsigned p1, unsigned p2, unsigned p3, void* stream) {
  long long span = (n_words + n_pe - 1) / n_pe;
  span = (span + 3) / 4 * 4;  // every span starts on a multiple of 4 words
  const long long per_span_blocks =
      ((span + 3) / 4 + kCopyThreads - 1) / kCopyThreads;
  long long cap = kMaxCopyBlocks / n_pe;
  if (cap < 1) cap = 1;
  const unsigned bx =
      static_cast<unsigned>(per_span_blocks < cap ? per_span_blocks : cap);
  fill_words_kernel<<<dim3(bx, n_pe), kCopyThreads, 0, as_stream(stream)>>>(
      static_cast<uint32_t*>(dst), n_words, span, make_uint4(p0, p1, p2, p3),
      aligned16(dst));
  return static_cast<int>(cudaGetLastError());
}

// state: 2 uint32 of scratch; equal: 1 bool; first: 1 int32 (all on the card)
int dsa_compare_words(const void* a, const void* b, long long n_words,
                      void* state, void* equal, void* first, void* stream) {
  cudaStream_t s = as_stream(stream);
  unsigned* st = static_cast<unsigned*>(state);
  const cudaError_t err = reset_first_diff(st, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(a) && aligned16(b);
  compare_words_kernel<<<grid_for((n_words + 3) / 4, kCopyThreads),
                         kCopyThreads, 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      n_words, vec, st, static_cast<bool*>(equal),
      static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

// state: 2 uint32 of scratch; equal: 1 bool; first: 1 int32 (all on the card)
int dsa_compare_pattern_words(const void* a, long long n_words, unsigned p0,
                              unsigned p1, unsigned p2, unsigned p3,
                              void* state, void* equal, void* first,
                              void* stream) {
  cudaStream_t s = as_stream(stream);
  unsigned* st = static_cast<unsigned*>(state);
  const cudaError_t err = reset_first_diff(st, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  compare_pattern_kernel<<<grid_for((n_words + 3) / 4, kCopyThreads),
                           kCopyThreads, 0, s>>>(
      static_cast<const uint32_t*>(a), n_words, make_uint4(p0, p1, p2, p3),
      aligned16(a), st, static_cast<bool*>(equal),
      static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

// dst: n_words (written whole); state, equal, first as for compare
int dsa_fill_verify_words(void* dst, long long n_words, unsigned p0,
                          unsigned p1, unsigned p2, unsigned p3, void* state,
                          void* equal, void* first, void* stream) {
  cudaStream_t s = as_stream(stream);
  unsigned* st = static_cast<unsigned*>(state);
  const cudaError_t err = reset_first_diff(st, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_verify_kernel<<<grid_for((n_words + 3) / 4, kCopyThreads),
                       kCopyThreads, 0, s>>>(
      static_cast<uint32_t*>(dst), n_words, make_uint4(p0, p1, p2, p3),
      aligned16(dst), st, static_cast<bool*>(equal),
      static_cast<int32_t*>(first));
  return static_cast<int>(cudaGetLastError());
}

int dsa_dualcast_words(const void* src, void* d1, void* d2, long long n_words,
                       void* stream) {
  const bool vec = aligned16(src) && aligned16(d1) && aligned16(d2);
  dualcast_words_kernel<<<grid_for((n_words + 3) / 4, kCopyThreads),
                          kCopyThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(d1),
      static_cast<uint32_t*>(d2), n_words, vec);
  return static_cast<int>(cudaGetLastError());
}

// mask: (n_words + 3) / 4 bytes; counts: n_tiles int32
int dsa_delta_count(const void* src, const void* ref, long long n_words,
                    void* mask, void* counts, int n_tiles, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = aligned16(src) && aligned16(ref);
  delta_count_kernel<<<n_tiles, kScanThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(ref),
      n_words, vec, static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// incl: the inclusive scan of counts; offsets/data: cap entries each;
// count: 1 int32; overflow: 1 bool.  n_tiles may be 0 (an empty buffer).
int dsa_delta_write(const void* src, long long n_words, const void* mask,
                    const void* counts, const void* incl, int n_tiles,
                    long long cap, void* offsets, void* data, void* count,
                    void* overflow, void* stream) {
  delta_write_kernel<<<n_tiles > 0 ? n_tiles : 1, kScanThreads, 0,
                       as_stream(stream)>>>(
      static_cast<const uint32_t*>(src), n_words,
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(incl), n_tiles, cap,
      static_cast<int32_t*>(offsets), static_cast<uint32_t*>(data),
      static_cast<int32_t*>(count), static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

// out: n_words (written whole); win: cap bytes of scratch
int dsa_delta_apply_words(const void* ref, void* out, long long n_words,
                          const void* offsets, const void* data, long long cap,
                          void* win, void* stream) {
  cudaStream_t s = as_stream(stream);
  if (n_words > 0) launch_memcpy(ref, out, n_words, 1, s);
  if (cap > 0) {
    uint32_t* o = static_cast<uint32_t*>(out);
    const int32_t* off = static_cast<const int32_t*>(offsets);
    uint8_t* w = static_cast<uint8_t*>(win);
    const unsigned blocks = grid_for(cap, kCopyThreads);
    delta_zero_kernel<<<blocks, kCopyThreads, 0, s>>>(o, n_words, off, cap);
    delta_claim_kernel<<<blocks, kCopyThreads, 0, s>>>(o, n_words, off, cap);
    delta_mark_kernel<<<blocks, kCopyThreads, 0, s>>>(o, n_words, off, cap, w);
    delta_store_kernel<<<blocks, kCopyThreads, 0, s>>>(
        o, off, static_cast<const uint32_t*>(data), cap, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
