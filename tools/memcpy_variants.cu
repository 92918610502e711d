// Copy-kernel variants timed against each other by tools/memcpy_variants.py
// on an H100 (sm_90a), to choose the design of memcpy_words
// (src/repro_torch/kernels/csrc/dsa_kernels.cu).  Not part of the port: the
// script builds this file on its own with nvcc.
//
//   0  memcpy_words_kernel's loop (the design before the bulk ring): a
//      grid-stride loop over uint4, one 16-byte load and store a thread a
//      step, 64-bit indices
//   1  U = 4 independent uint4 loads in flight a thread before their
//      stores, 32-bit inner indices, default caching
//   2  the same with streaming hints (ld.global.cs / st.global.cs)
//   3  U = 8 with streaming hints
//   4  U = 4, ld.global.nc.L1::no_allocate loads and st.global.cs stores
//   5  U = 8, ld.global.nc.L1::no_allocate loads and st.global.cs stores
//   6  a persistent grid whose CTAs each run a ring of TMA bulk copies:
//      cp.async.bulk global -> shared on an mbarrier, then shared -> global;
//      CTA i takes chunks i, i + grid, i + 2 grid, ...
//   7  the same ring, each CTA over one contiguous range of chunks
//   8  the ring of 6 with an L2 evict-first policy on its loads and stores
//   9  U = 4, default caching, each CTA over one contiguous range
//  10  cudaMemcpyAsync device to device (what Tensor.copy_ calls)
//  11  the ring of 6 with the evict-first policy on its stores only
//  12  four rings per CTA, one per warp (lane 0 of each), over the CTA's
//      chunks in turn
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void loop_copy(const uint4* __restrict__ s, uint4* __restrict__ d, long long nv) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < nv; i += stride) d[i] = s[i];
}

template <int HINT>
__device__ __forceinline__ uint4 load(const uint4* p) {
  if (HINT == 0) return *p;
  if (HINT == 1) return __ldcs(p);
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

template <int HINT>
__device__ __forceinline__ void store(uint4* p, uint4 v) {
  if (HINT == 0) *p = v;
  else __stcs(p, v);
}

template <int U, int HINT>
__global__ void unroll_copy(const uint4* __restrict__ s, uint4* __restrict__ d, long long nv) {
  const long long per = static_cast<long long>(U) * blockDim.x;
  const long long step = per * gridDim.x;
  for (long long base = blockIdx.x * per; base < nv; base += step) {
    const uint4* sp = s + base;
    uint4* dp = d + base;
    const int rem = static_cast<int>(nv - base < per ? nv - base : per);
    uint4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      if (i < rem) r[u] = load<HINT>(sp + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      if (i < rem) store<HINT>(dp + i, r[u]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int U>
__global__ void blocked_copy(const uint4* __restrict__ s, uint4* __restrict__ d, long long nv) {
  const long long per = static_cast<long long>(U) * blockDim.x;
  const long long steps = (nv + per - 1) / per;
  const long long mine = (steps + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * mine;
  const long long last = first + mine < steps ? first + mine : steps;
  for (long long step = first; step < last; ++step) {
    const long long base = step * per;
    const uint4* sp = s + base;
    uint4* dp = d + base;
    const int rem = static_cast<int>(nv - base < per ? nv - base : per);
    uint4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      if (i < rem) r[u] = sp[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      if (i < rem) dp[i] = r[u];
    }
  }
}

// One thread of each CTA runs the ring; nbytes and chunk are multiples of 16.
template <bool BLOCKED, int HINT>
__global__ void bulk_copy(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                          long long nbytes, int chunk, int stages) {
  extern __shared__ __align__(128) uint8_t buf[];
  if (threadIdx.x % 32 != 0) return;
  // one ring per warp: warp w of a CTA of W warps acts as CTA blockIdx.x * W + w
  const int rings = blockDim.x / 32;
  const int ring_id = threadIdx.x / 32;
  const uint32_t ring = smem_addr(buf) + ring_id * ((stages * (chunk + 8) + 127) / 128 * 128);
  const uint32_t bars = ring + stages * chunk;
  const long long cta = static_cast<long long>(blockIdx.x) * rings + ring_id;
  const long long grid = static_cast<long long>(gridDim.x) * rings;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8 * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint64_t policy = 0;
  if (HINT) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  const long long n_chunks = (nbytes + chunk - 1) / chunk;
  const long long per_cta = (n_chunks + grid - 1) / grid;
  const long long first = cta * per_cta;
  long long mine;
  if (BLOCKED)
    mine = first >= n_chunks ? 0 : (first + per_cta < n_chunks ? per_cta : n_chunks - first);
  else
    mine = n_chunks > cta ? (n_chunks - cta + grid - 1) / grid : 0;
  auto offset = [&](long long j) { return (BLOCKED ? first + j : cta + j * grid) * chunk; };
  auto size = [&](long long j) {
    const long long left = nbytes - offset(j);
    return static_cast<uint32_t>(left < chunk ? left : chunk);
  };
  auto load = [&](long long j) {
    const int s = static_cast<int>(j % stages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bars + 8 * s),
                 "r"(size(j))
                 : "memory");
    if (HINT == 1)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
          " [%0], [%1], %2, [%3], %4;" ::"r"(ring + s * chunk),
          "l"(src + offset(j)), "r"(size(j)), "r"(bars + 8 * s), "l"(policy)
          : "memory");
    else
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(ring + s * chunk),
          "l"(src + offset(j)), "r"(size(j)), "r"(bars + 8 * s)
          : "memory");
  };
  for (long long j = 0; j < mine && j < stages; ++j) load(j);
  for (long long j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % stages);
    const uint32_t parity = static_cast<uint32_t>((j / stages) & 1);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bars + 8 * s), "r"(parity)
          : "memory");
    }
    if (HINT)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(
              dst + offset(j)),
          "r"(ring + s * chunk), "r"(size(j)), "l"(policy)
          : "memory");
    else
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                       dst + offset(j)),
                   "r"(ring + s * chunk), "r"(size(j))
                   : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // refill the stage of chunk j - 1 once its store has read it
    if (j >= 1 && j - 1 + stages < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(j - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <bool BLOCKED, int HINT>
int launch_bulk(const void* src, void* dst, long long n_words, int blocks, int stages, int chunk,
                cudaStream_t st, int rings = 1) {
  const int bytes = rings * ((stages * (chunk + 8) + 127) / 128 * 128);
  cudaError_t err = cudaFuncSetAttribute(bulk_copy<BLOCKED, HINT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bulk_copy<BLOCKED, HINT><<<blocks, 32 * rings, bytes, st>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n_words * 4, chunk, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// blocks: the grid; stages, chunk: the bulk ring (variant 6 only).
int mv_copy(int variant, const void* src, void* dst, long long n_words, int blocks, int stages,
            int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nv = n_words / 4;  // the caller passes a multiple of 4 words
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  switch (variant) {
    case 0: loop_copy<<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 1: unroll_copy<4, 0><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 2: unroll_copy<4, 1><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 3: unroll_copy<8, 1><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 4: unroll_copy<4, 2><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 5: unroll_copy<8, 2><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 6: return launch_bulk<false, 0>(src, dst, n_words, blocks, stages, chunk, st);
    case 7: return launch_bulk<true, 0>(src, dst, n_words, blocks, stages, chunk, st);
    case 8: return launch_bulk<false, 1>(src, dst, n_words, blocks, stages, chunk, st);
    case 11: return launch_bulk<false, 2>(src, dst, n_words, blocks, stages, chunk, st);
    case 12: return launch_bulk<false, 0>(src, dst, n_words, blocks, stages, chunk, st, 4);
    case 9: blocked_copy<4><<<blocks, 256, 0, st>>>(s, d, nv); break;
    case 10: return static_cast<int>(
        cudaMemcpyAsync(dst, src, n_words * 4, cudaMemcpyDeviceToDevice, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
