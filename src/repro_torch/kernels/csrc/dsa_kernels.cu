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
// words, so the uint4 is position-independent on a 16-byte-aligned output.
// A one-shot grid with no stride loop: CTA b of a span writes its uint4s
// [b kFillPerCta, (b + 1) kFillPerCta), each thread kFillPerThread of them
// spaced by blockDim, so a warp writes 512 contiguous bytes a store.  Of the
// designs tools/fill_variants.py times (the grid-stride loop of 132 x 8 CTAs
// this replaces, bulk stores of a pattern tile from shared memory, one-shot
// grids of 1-8 stores a thread, 128 or 256 threads) this one was the
// fastest at 1 GiB, level with Tensor.fill_ (97.7 % of the bound; the loop
// 94.3 %, the bulk stores 95.4-96.2 %), and no slower than the loop at
// 4 KiB, 1 MiB and 64 MiB.  A fill is a stream of stores: what counts is
// that every SM keeps enough of them in flight, which a one-shot grid of
// short-lived CTAs does without a loop's bookkeeping.  The ragged tail (1-3 words)
// takes word i % 4 of the pattern from the first threads of CTA 0 of its
// span; an unaligned output takes the same grid over words.  n_pe spans
// (blockIdx.y) as in memcpy.
constexpr int kFillThreads = 128;
constexpr int kFillPerThread = 2;
constexpr long long kFillPerCta = kFillThreads * kFillPerThread;

__global__ void __launch_bounds__(kFillThreads)
fill_words_kernel(uint32_t* __restrict__ dst, long long n, long long span, uint4 pat,
                  bool vec) {
  const long long begin = static_cast<long long>(blockIdx.y) * span;
  const long long end = min(begin + span, n);
  if (begin >= end) return;
  const long long base = static_cast<long long>(blockIdx.x) * kFillPerCta + threadIdx.x;
  const uint32_t w[4] = {pat.x, pat.y, pat.z, pat.w};
  if (vec) {
    const long long nv = (end - begin) / 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst + begin);
#pragma unroll
    for (int u = 0; u < kFillPerThread; ++u) {
      const long long i = base + u * kFillThreads;
      if (i < nv) d4[i] = pat;
    }
    const long long i = begin + nv * 4 + threadIdx.x;
    if (blockIdx.x == 0 && i < end) dst[i] = w[i & 3];
    return;
  }
#pragma unroll
  for (int u = 0; u < kFillPerThread; ++u) {
    const long long i = begin + base + u * kFillThreads;
    if (i < end) dst[i] = w[i & 3];
  }
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
// Bound: bytes, ref read and out written once, the offsets read once and
// the data word of each valid entry read once.
// Semantics: out = ref, then the entries in record order, skipping
// off < 0 (pads) and off >= n; of entries naming one word the last wins.
// The Pallas kernel walked the record serially on one core.  CTAs run in no
// order here, so the order matters only where two valid entries name one
// word.  A record from delta_record_words never has such a pair: its valid
// entries are an ascending prefix of the record, the -1 pads after them.
// One scan of the record (16-byte loads of the offsets) finds hi, one past
// the last valid entry (atomicMax), and whether some adjacent pair breaks
// the ascending-prefix rule: valid(i+1) and not (valid(i) and off[i] <
// off[i+1]) (atomicOr).  When none does, no two valid entries name one word
// and their stores may land in any order: the fast path.  Otherwise the
// general path runs over [0, hi) only, the output word itself as the claim
// slot (no scratch of the buffer's size), a grid barrier between steps:
// every valid entry zeroes out[off]; every valid entry i does
// atomicMax(out[off], i + 1), so the word names its last writer; entry i is
// the winner iff out[off] == i + 1 (a byte in win[], since a winner's store
// must not race a loser's read); winners store data[i].  It overwrites
// whatever the fast path's stores left in the words it names.
// Two routes, by the copy they ride on (dsa_delta_apply_words):
// - the ring (spans of memcpy_bulk_kernel's size, 16-byte aligned, n a
//   multiple of 4): the scan (delta_scan_kernel) also writes first[c], the
//   first entry of each 32 KiB chunk c of the buffer; then
//   delta_copy_patch_kernel copies through a ring of TMA bulk copies as
//   memcpy_bulk_kernel does, and patches each chunk's entries into the
//   chunk in shared memory before the bulk store writes it.  Scattered
//   4-byte stores into device memory would each cost a read-modify-write of
//   a 32-byte sector (27 us for a checkpoint leaf's 335 k entries on an H100,
//   tools/delta_apply_variants.py); patched in shared memory they cost
//   nothing in device memory.  On the general path it copies unpatched,
//   then runs the claim rule after a grid barrier.
// - otherwise: launch_memcpy, then delta_apply_kernel, whose scan stores the
//   valid entries as it finds them, then a grid barrier and, on the general
//   path, the claim rule.
// Both kernels with a barrier are cooperative launches of co-resident CTAs.
// Scratch: state[0] = hi, state[1] = the broken-pair flag, state[2] = the
// barriers' arrivals, state[4..5] = the chunk bounds claimed (64-bit; at
// most one per chunk on an ascending prefix, more marks the record
// broken), all zeroed by one memset; then first[] (one word a chunk).  Offsets and the flag
// stay on the card: nothing is read back to the host.
constexpr int kDeltaThreads = 256;
constexpr long long kChunkWords = kCopyChunk / 4;

__device__ __forceinline__ bool delta_valid(int32_t off, long long n) {
  return off >= 0 && off < n;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the (co-resident) grid arrives; the k-th barrier of a launch
// passes when the count reaches k * gridDim.x.
__device__ void grid_barrier(unsigned* arrived, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    while (load_acquire(arrived) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The scan, over the whole grid, four entries a thread a step (a warp's
// lanes on 32 neighbouring groups); o[4] is the next group's first entry,
// for the pair that straddles two groups.  STORE: store every valid entry.
// BOUNDS: for each ascending valid pair, write first[c] = i + 1 for the
// chunks c whose first word lies in (off[i], off[i+1]].  On an ascending
// prefix that is one write per chunk at most, counted (one 64-bit atomicAdd
// a warp a step) so that a record with more bounds is marked broken before
// it writes them.
template <bool STORE, bool BOUNDS>
__device__ void delta_scan(uint32_t* out, long long n, const int32_t* offsets,
                           const uint32_t* data, long long cap, bool vec,
                           unsigned* first, unsigned* state) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x % 32;
  const unsigned long long n_chunks = (n + kChunkWords - 1) / kChunkWords;
  unsigned long long* bounds_used = reinterpret_cast<unsigned long long*>(state + 4);
  unsigned hi = 0;
  bool broken = false;
  const long long groups = (cap + 3) / 4;
  for (long long g = tid; g - lane < groups; g += stride) {
    const long long i0 = g * 4;
    int32_t o[5] = {-1, -1, -1, -1, -1};
    unsigned bounds = 0;
    if (g < groups) {
      if (vec && i0 + 4 <= cap) {
        const int4 v = reinterpret_cast<const int4*>(offsets)[g];
        o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = i0 + k < cap ? offsets[i0 + k] : -1;
      }
      o[4] = i0 + 4 < cap ? offsets[i0 + 4] : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool v = delta_valid(o[k], n);
        if (v) {
          if (STORE) out[o[k]] = data[i0 + k];
          hi = static_cast<unsigned>(i0 + k + 1);
        }
        if (!delta_valid(o[k + 1], n)) continue;
        if (!(v && o[k] < o[k + 1]))
          broken = true;
        else if (BOUNDS)
          bounds += static_cast<unsigned>(o[k + 1] / kChunkWords - o[k] / kChunkWords);
      }
    }
    if (BOUNDS) {
      const unsigned total = __reduce_add_sync(0xFFFFFFFFu, bounds);
      if (total) {
        unsigned long long used = 0;
        if (lane == 0) used = atomicAdd(bounds_used, static_cast<unsigned long long>(total));
        used = __shfl_sync(0xFFFFFFFFu, used, 0);
        if (used + total > n_chunks) {
          broken = true;  // more bounds than chunks: not an ascending prefix
        } else if (bounds) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!delta_valid(o[k], n) || !delta_valid(o[k + 1], n) || o[k] >= o[k + 1]) continue;
            for (long long c = o[k] / kChunkWords + 1; c <= o[k + 1] / kChunkWords; ++c)
              first[c] = static_cast<unsigned>(i0 + k + 1);
          }
        }
      }
    }
  }
  hi = __reduce_max_sync(0xFFFFFFFFu, hi);
  broken = __any_sync(0xFFFFFFFFu, broken);
  if (lane == 0) {
    if (hi) atomicMax(&state[0], hi);
    if (broken) atomicOr(&state[1], 1u);
  }
}

// The general path over [0, hi): every thread of a co-resident grid calls it
// after the launch's first barrier; it returns at once on the fast path.
__device__ void delta_claim_rule(uint32_t* out, long long n, const int32_t* offsets,
                                 const uint32_t* data, uint8_t* win, unsigned* state) {
  if (load_acquire(&state[1]) == 0) return;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long end = load_acquire(&state[0]);
  for (long long i = tid; i < end; i += stride) {
    const int32_t off = offsets[i];
    if (delta_valid(off, n)) out[off] = 0;
  }
  grid_barrier(&state[2], 2 * gridDim.x);
  for (long long i = tid; i < end; i += stride) {
    const int32_t off = offsets[i];
    if (delta_valid(off, n)) atomicMax(out + off, static_cast<unsigned>(i + 1));
  }
  grid_barrier(&state[2], 3 * gridDim.x);
  for (long long i = tid; i < end; i += stride) {
    const int32_t off = offsets[i];
    win[i] = delta_valid(off, n) && __ldcg(out + off) == static_cast<uint32_t>(i + 1);
  }
  grid_barrier(&state[2], 4 * gridDim.x);
  for (long long i = tid; i < end; i += stride)
    if (win[i]) out[offsets[i]] = data[i];
}

// The route beside launch_memcpy: the scan with its stores, then the barrier
// and the claim rule.
__global__ void __launch_bounds__(kDeltaThreads)
delta_apply_kernel(uint32_t* __restrict__ out, long long n,
                   const int32_t* __restrict__ offsets,
                   const uint32_t* __restrict__ data, long long cap, bool vec,
                   uint8_t* __restrict__ win, unsigned* __restrict__ state) {
  delta_scan<true, false>(out, n, offsets, data, cap, vec, nullptr, state);
  grid_barrier(&state[2], gridDim.x);
  delta_claim_rule(out, n, offsets, data, win, state);
}

// The ring route's scan: hi, the flag and the chunk bounds; no stores.
__global__ void __launch_bounds__(kDeltaThreads)
delta_scan_kernel(long long n, const int32_t* __restrict__ offsets, long long cap, bool vec,
                  unsigned* __restrict__ first, unsigned* __restrict__ state) {
  delta_scan<false, true>(nullptr, n, offsets, nullptr, cap, vec, first, state);
}

// The ring route's copy: memcpy_bulk_kernel's ring (one CTA per SM, chunk
// blockIdx.x + j gridDim.x, kCopyStages bulk copies in flight) with every
// thread of the CTA patching the chunk's entries into shared memory between
// its load and its store.  The entries of chunk c are [start(c),
// start(c + 1)): start(c) = 0 up to the chunk of the first entry, hi after
// the chunk of the last, first[c] between.  n is a multiple of 4 and both
// buffers are 16-byte aligned.
__global__ void __launch_bounds__(kDeltaThreads)
delta_copy_patch_kernel(const uint32_t* __restrict__ ref, uint32_t* __restrict__ out,
                        long long n, const int32_t* __restrict__ offsets,
                        const uint32_t* __restrict__ data, const unsigned* __restrict__ first,
                        uint8_t* __restrict__ win, unsigned* __restrict__ state) {
  extern __shared__ __align__(128) uint8_t ring[];  // kCopyStages chunks, then the mbarriers
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kCopyStages * kCopyChunk);
  const long long bytes = n * 4;
  const long long n_chunks = (bytes + kCopyChunk - 1) / kCopyChunk;
  const long long mine =
      n_chunks > blockIdx.x ? (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const unsigned hi = load_acquire(&state[0]);
  const bool patch = hi > 0 && load_acquire(&state[1]) == 0;
  const long long c_first = patch ? offsets[0] / kChunkWords : 0;
  const long long c_last = patch ? offsets[hi - 1] / kChunkWords : -1;
  auto start = [&](long long c) -> unsigned {
    return c <= c_first ? 0u : c > c_last ? hi : __ldcg(first + c);
  };
  auto offset = [&](long long j) { return (blockIdx.x + j * gridDim.x) * kCopyChunk; };
  auto size = [&](long long j) {
    return static_cast<uint32_t>(min(static_cast<long long>(kCopyChunk), bytes - offset(j)));
  };
  const uint8_t* s = reinterpret_cast<const uint8_t*>(ref);
  uint8_t* d = reinterpret_cast<uint8_t*>(out);
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
  if (threadIdx.x == 0) {
    for (int st = 0; st < kCopyStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long j = 0; j < mine && j < kCopyStages; ++j) load(j);
  }
  __syncthreads();
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
    if (patch) {
      const long long c = blockIdx.x + j * gridDim.x;
      uint32_t* chunk = reinterpret_cast<uint32_t*>(ring + st * kCopyChunk);
      const unsigned e1 = start(c + 1);
      for (unsigned e = start(c) + threadIdx.x; e < e1; e += blockDim.x)
        chunk[offsets[e] - c * kChunkWords] = data[e];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
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
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  if (load_acquire(&state[1]) == 0) return;
  grid_barrier(&state[2], gridDim.x);
  delta_claim_rule(out, n, offsets, data, win, state);
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
  const bool vec = aligned16(dst);
  const long long items = vec ? span / 4 : span;  // uint4s, or words, a span
  const long long bx = (items + kFillPerCta - 1) / kFillPerCta;
  fill_words_kernel<<<dim3(static_cast<unsigned>(bx > 0 ? bx : 1), n_pe), kFillThreads, 0,
                      as_stream(stream)>>>(static_cast<uint32_t*>(dst), n_words, span,
                                           make_uint4(p0, p1, p2, p3), vec);
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

// out: n_words (written whole); win: cap bytes of scratch; scratch: 6 +
// ceil(n_words / kChunkWords) uint32, 8-byte aligned.  cap < 2^31 (entry indices are 32-bit
// on the card).
int dsa_delta_apply_words(const void* ref, void* out, long long n_words,
                          const void* offsets, const void* data, long long cap,
                          void* win, void* scratch, void* stream) {
  cudaStream_t s = as_stream(stream);
  if (cap < 0 || cap > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0 || n_words == 0) {
    if (n_words > 0) launch_memcpy(ref, out, n_words, 1, s);
    return static_cast<int>(cudaGetLastError());
  }
  uint32_t* o = static_cast<uint32_t*>(out);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  bool vec = aligned16(offsets);
  uint8_t* w = static_cast<uint8_t*>(win);
  unsigned* st = static_cast<unsigned*>(scratch);
  unsigned* first = st + 6;
  cudaError_t err = cudaMemsetAsync(st, 0, 6 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long need = ((cap + 3) / 4 + kDeltaThreads - 1) / kDeltaThreads;
  if (aligned16(ref) && aligned16(out) && n_words % 4 == 0 &&
      n_words * 4 >= static_cast<long long>(sms) * kCopyStages * kCopyChunk) {
    // the ring route: the scan, then the patching copy, one CTA per SM
    const long long most = static_cast<long long>(sms) * 8;
    delta_scan_kernel<<<static_cast<unsigned>(need < most ? need : most), kDeltaThreads, 0,
                        s>>>(n_words, off, cap, vec, first, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int bytes = kCopyStages * (kCopyChunk + 8);
    err = cudaFuncSetAttribute(delta_copy_patch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint32_t* r = static_cast<const uint32_t*>(ref);
    const unsigned* f = first;
    void* args[] = {&r, &o, &n_words, &off, &d, &f, &w, &st};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(delta_copy_patch_kernel),
                                      dim3(sms), dim3(kDeltaThreads), args, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  // beside launch_memcpy: as many CTAs as fit on the card at once (the grid
  // barrier needs every CTA resident; a cooperative launch guarantees it),
  // at most one thread per group of four entries
  launch_memcpy(ref, out, n_words, 1, s);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, delta_apply_kernel,
                                                      kDeltaThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long most = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < most ? need : most);
  void* args[] = {&o, &n_words, &off, &d, &cap, &vec, &w, &st};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(delta_apply_kernel),
                                    dim3(grid), dim3(kDeltaThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
