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
// CRC chains per CTA: one warp, so the <= 256 chains spread over 8 SMs.
constexpr int kCrcThreads = 32;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// ------------------------------------------------------------------ memcpy_words
// Replaces kernels/memcpy.py memcpy_words / _memcpy_kernel (Pallas).
// Bound: bytes.  A copy reads and writes each word once, so device-memory
// bandwidth (3.35 TB/s on an H100 SXM) is the limit.
// Design: the buffer splits into n_pe contiguous spans (blockIdx.y), the DSA
// PE lanes of the reference grid.  Inside a span a grid-stride loop moves
// 16-byte uint4 words, so a warp issues 512 contiguous bytes per load and
// store; a scalar loop copies the ragged tail.  The span bounds are explicit,
// so the 128-lane padding of the Pallas word grid is not needed.
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
// are far below the card's rate).  This design is further bound by latency:
// each word is one dependent slice-by-4 step (four shared-memory lookups and
// four xors) on its chunk's serial chain, and the JAX package's chunk choice
// allows at most 256 chains, so chain latency on a few SMs, not device
// memory, sets the time (PERF.md: 0.3 % of the bound at 1 GiB).
// Design: the [4,256] tables sit in shared memory (4 KiB per CTA).  One
// thread per chunk runs the step over its W contiguous words; one warp per
// CTA spreads the chains over C/32 SMs.  The copy variant stores each word it
// has just read to dst, so copy and checksum share one read pass.  The final
// xor matches crc32.py:82.
template <bool kCopy>
__global__ void crc_chunks_kernel(const uint32_t* __restrict__ data,
                                  const uint32_t* __restrict__ tables,
                                  uint32_t* __restrict__ states,
                                  uint32_t* __restrict__ dst, int C,
                                  long long W) {
  __shared__ uint32_t t[4][256];
  for (int k = threadIdx.x; k < 4 * 256; k += blockDim.x)
    t[k >> 8][k & 255] = tables[k];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long base = static_cast<long long>(c) * W;
  const uint32_t* p = data + base;
  uint32_t st = 0xFFFFFFFFu;
  for (long long w = 0; w < W; ++w) {
    const uint32_t word = p[w];
    if (kCopy) dst[base + w] = word;
    const uint32_t x = st ^ word;
    st = t[3][x & 0xFFu] ^ t[2][(x >> 8) & 0xFFu] ^ t[1][(x >> 16) & 0xFFu] ^
         t[0][x >> 24];
  }
  states[c] = st ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------------ gf2_fold
// Replaces kernels/crc32.py combine_chunk_crcs / gf2_apply, which the JAX
// package runs as jnp outside the Pallas kernel.
// Bound: latency.  The bytes are under 2 KiB; the time is C - 1 dependent
// 32-term GF(2) matrix-vector products (crc32_combine with equal chunk
// lengths) on one thread, about 0.08 ms at C = 256 (PERF.md).
// Design: one thread folds the chunk CRCs left to right with the [32] shift
// matrix held in registers, so the fold is one launch instead of C - 1
// host-driven steps.
__global__ void gf2_fold_kernel(const uint32_t* __restrict__ states,
                                const uint32_t* __restrict__ mat,
                                uint32_t* __restrict__ out, int C) {
  uint32_t m[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) m[b] = mat[b];
  uint32_t crc = states[0];
  for (int i = 1; i < C; ++i) {
    uint32_t s = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) s ^= m[b] & (0u - ((crc >> b) & 1u));
    crc = s ^ states[i];
  }
  out[0] = crc;
}

}  // namespace

extern "C" {

const char* dsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int dsa_memcpy_words(const void* src, void* dst, long long n_words, int n_pe,
                     void* stream) {
  long long span = (n_words + n_pe - 1) / n_pe;
  span = (span + 3) / 4 * 4;  // keeps every span 16-byte aligned
  const bool vec = aligned16(src) && aligned16(dst);
  const long long per_span_blocks =
      ((span + 3) / 4 + kCopyThreads - 1) / kCopyThreads;
  long long cap = kMaxCopyBlocks / n_pe;
  if (cap < 1) cap = 1;
  const unsigned bx =
      static_cast<unsigned>(per_span_blocks < cap ? per_span_blocks : cap);
  memcpy_words_kernel<<<dim3(bx, n_pe), kCopyThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), n_words,
      span, vec);
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

int dsa_crc32_chunk_states(const void* data, const void* tables, void* states,
                           int C, long long W, void* stream) {
  const int blocks = (C + kCrcThreads - 1) / kCrcThreads;
  crc_chunks_kernel<false><<<blocks, kCrcThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const uint32_t*>(tables),
      static_cast<uint32_t*>(states), nullptr, C, W);
  return static_cast<int>(cudaGetLastError());
}

int dsa_copy_crc_words(const void* data, const void* tables, void* states,
                       void* dst, int C, long long W, void* stream) {
  const int blocks = (C + kCrcThreads - 1) / kCrcThreads;
  crc_chunks_kernel<true><<<blocks, kCrcThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(data), static_cast<const uint32_t*>(tables),
      static_cast<uint32_t*>(states), static_cast<uint32_t*>(dst), C, W);
  return static_cast<int>(cudaGetLastError());
}

int dsa_gf2_fold(const void* states, const void* mat, void* out, int C,
                 void* stream) {
  gf2_fold_kernel<<<1, 1, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(states), static_cast<const uint32_t*>(mat),
      static_cast<uint32_t*>(out), C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
