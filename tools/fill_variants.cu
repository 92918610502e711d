// Fill-kernel variants timed against each other and Tensor.fill_ by
// tools/fill_variants.py on an H100 (sm_90a), to choose the design of
// fill_words (src/repro_torch/kernels/csrc/dsa_kernels.cu).  Not part of the
// port: the script builds this file on its own with nvcc.  A fill reads
// nothing, so the variants differ only in how the stores are issued:
//
//   0  fill_words_kernel's grid-stride loop before the redesign: 132 x 8
//      CTAs of 256 threads, one 16-byte store a thread a step
//   1  bulk stores from a pattern tile: a CTA writes the uint4 pattern into
//      a shared tile once, fences the async proxy, and one thread issues
//      cp.async.bulk.global.shared::cta stores of the tile over the CTA's
//      chunks (chunk c = blockIdx.x + j gridDim.x), at most INFLIGHT bulk
//      groups outstanding (cp.async.bulk.wait_group.read); 1 CTA per SM,
//      32 KiB tile, 8 in flight
//   2  the same, 2 CTAs per SM, 16 KiB tiles, 8 in flight
//   3  the same as 1, each CTA over one contiguous range of chunks
//   4  the same as 1, four warps of the CTA issuing (lane 0 of each), each
//      over every fourth of the CTA's chunks, 4 in flight each
//   5  the same as 1 with a 16 KiB tile and 16 in flight
//   6  the same as 1 with a 64 KiB tile and 4 in flight
//   7  a one-shot grid: no loop, each thread U = 4 uint4 stores spaced by
//      blockDim, 256 threads a CTA
//   8  one-shot, U = 8, 256 threads
//   9  one-shot, U = 4, 128 threads
//  10  one-shot, U = 1, 128 threads (the shape of PyTorch's vectorized
//      elementwise launch for 4-byte elements)
//  11  one-shot, U = 8, 256 threads, st.global.cs (streaming) stores
//  12  one-shot, U = 2, 128 threads
// The last 1-3 words (n not a multiple of 4) take a one-CTA scalar kernel.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void loop_fill(uint4* __restrict__ d, long long nv, uint4 pat) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < nv; i += stride) d[i] = pat;
}

template <int INFLIGHT, bool CONTIG>
__global__ void bulk_fill(uint8_t* __restrict__ dst, long long bytes, uint4 pat, int chunk,
                          int issuers) {
  extern __shared__ __align__(128) uint4 tile[];
  for (int i = threadIdx.x; i < chunk / 16; i += blockDim.x) tile[i] = pat;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 != 0 || warp >= issuers) return;
  const long long n_chunks = (bytes + chunk - 1) / chunk;
  long long lo, step, hi;
  if (CONTIG) {
    const long long per = (n_chunks + gridDim.x - 1) / gridDim.x;
    lo = blockIdx.x * per;
    hi = min(lo + per, n_chunks);
    step = 1;
  } else {
    lo = blockIdx.x;
    hi = n_chunks;
    step = gridDim.x;
  }
  const uint32_t src = smem_addr(tile);
  int issued = 0;
  for (long long c = lo + warp * step; c < hi; c += issuers * step) {
    const long long off = c * chunk;
    const uint32_t size = static_cast<uint32_t>(min(static_cast<long long>(chunk), bytes - off));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + off),
                 "r"(src), "r"(size)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (++issued >= INFLIGHT)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(INFLIGHT - 1) : "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int U, bool STREAM>
__global__ void oneshot_fill(uint4* __restrict__ d, long long nv, uint4 pat) {
  const long long base = static_cast<long long>(blockIdx.x) * U * blockDim.x + threadIdx.x;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = base + static_cast<long long>(u) * blockDim.x;
    if (i < nv) {
      if (STREAM)
        __stcs(d + i, pat);
      else
        d[i] = pat;
    }
  }
}

__global__ void tail_fill(uint32_t* __restrict__ d, long long from, long long n, uint4 pat) {
  const uint32_t w[4] = {pat.x, pat.y, pat.z, pat.w};
  const long long i = from + threadIdx.x;
  if (i < n) d[i] = w[i & 3];
}

template <int INFLIGHT, bool CONTIG>
cudaError_t bulk(uint8_t* d, long long bytes, uint4 pat, int ctas, int chunk, int issuers,
                 cudaStream_t s) {
  if (bytes == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(bulk_fill<INFLIGHT, CONTIG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, chunk);
  if (err != cudaSuccess) return err;
  const long long n_chunks = (bytes + chunk - 1) / chunk;
  const unsigned grid = static_cast<unsigned>(n_chunks < ctas ? n_chunks : ctas);
  bulk_fill<INFLIGHT, CONTIG><<<grid, 128, chunk, s>>>(d, bytes, pat, chunk, issuers);
  return cudaGetLastError();
}

template <int U, bool STREAM>
cudaError_t oneshot(uint4* d, long long nv, uint4 pat, int threads, cudaStream_t s) {
  if (nv == 0) return cudaSuccess;
  const long long per = static_cast<long long>(U) * threads;
  oneshot_fill<U, STREAM><<<static_cast<unsigned>((nv + per - 1) / per), threads, 0, s>>>(
      d, nv, pat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst: n_words uint32, 16-byte aligned; sms: the card's SM count
int fv_fill(int variant, void* dst, long long n_words, unsigned p0, unsigned p1, unsigned p2,
            unsigned p3, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4 pat = make_uint4(p0, p1, p2, p3);
  const long long nv = n_words / 4;
  uint4* d4 = static_cast<uint4*>(dst);
  uint8_t* d8 = static_cast<uint8_t*>(dst);
  constexpr int KiB = 1024;
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0: {
      if (nv == 0) break;
      long long blocks = (nv + 255) / 256;
      if (blocks > sms * 8) blocks = sms * 8;
      loop_fill<<<static_cast<unsigned>(blocks), 256, 0, s>>>(d4, nv, pat);
      err = cudaGetLastError();
      break;
    }
    case 1: err = bulk<8, false>(d8, nv * 16, pat, sms, 32 * KiB, 1, s); break;
    case 2: err = bulk<8, false>(d8, nv * 16, pat, 2 * sms, 16 * KiB, 1, s); break;
    case 3: err = bulk<8, true>(d8, nv * 16, pat, sms, 32 * KiB, 1, s); break;
    case 4: err = bulk<4, false>(d8, nv * 16, pat, sms, 32 * KiB, 4, s); break;
    case 5: err = bulk<16, false>(d8, nv * 16, pat, sms, 16 * KiB, 1, s); break;
    case 6: err = bulk<4, false>(d8, nv * 16, pat, sms, 64 * KiB, 1, s); break;
    case 7: err = oneshot<4, false>(d4, nv, pat, 256, s); break;
    case 8: err = oneshot<8, false>(d4, nv, pat, 256, s); break;
    case 9: err = oneshot<4, false>(d4, nv, pat, 128, s); break;
    case 10: err = oneshot<1, false>(d4, nv, pat, 128, s); break;
    case 11: err = oneshot<8, true>(d4, nv, pat, 256, s); break;
    case 12: err = oneshot<2, false>(d4, nv, pat, 128, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_words % 4) {
    tail_fill<<<1, 4, 0, s>>>(static_cast<uint32_t*>(dst), nv * 4, n_words, pat);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
