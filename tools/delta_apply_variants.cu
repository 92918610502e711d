// Variants of the part of delta_apply_words that follows its copy, timed by
// tools/delta_apply_variants.py on an H100 (sm_90a) to find where the time
// of the port's delta_apply_words goes on a checkpoint leaf's record (an
// ascending prefix of valid entries, then -1 pads).  Not part of the port:
// the script builds this file on its own with nvcc; the copy before each
// variant is the port's own memcpy_words.  They are the steps of the store
// route (copy, then a scan that stores the entries); the script times the
// port itself beside them, which takes the ring route on this record.
//
//   0  the scan of the store route's delta_apply_kernel with its stores of
//      the valid entries, then its grid barrier, in a cooperative launch
//      after a memset of its 3 scratch words (its fast path)
//   1  the same scan and stores in a plain launch: no memset, no barrier
//   2  the scan alone: the offsets read, hi and the flag found, no stores
//   3  the scan and stores of 1 with two groups of four entries a thread a
//      step (two 16-byte loads in flight)
//   4  the memset of the 3 scratch words alone
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool valid(int32_t off, long long n) { return off >= 0 && off < n; }

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One group of four entries starting at entry 4 g: stores the valid ones
// (when STORE), updates hi and broken.
template <bool STORE>
__device__ __forceinline__ void group(uint32_t* out, long long n, const int32_t* offsets,
                                      const uint32_t* data, long long cap, long long g,
                                      unsigned& hi, bool& broken) {
  const long long i0 = g * 4;
  int32_t o[5];
  if (i0 + 4 <= cap) {
    const int4 v = reinterpret_cast<const int4*>(offsets)[g];
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = i0 + k < cap ? offsets[i0 + k] : -1;
  }
  o[4] = i0 + 4 < cap ? offsets[i0 + 4] : -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool v = valid(o[k], n);
    if (v) {
      if (STORE) out[o[k]] = data[i0 + k];
      hi = static_cast<unsigned>(i0 + k + 1);
    }
    if (valid(o[k + 1], n) && !(v && o[k] < o[k + 1])) broken = true;
  }
}

__device__ __forceinline__ void publish(unsigned hi, bool broken, unsigned* state) {
  hi = __reduce_max_sync(0xFFFFFFFFu, hi);
  broken = __any_sync(0xFFFFFFFFu, broken);
  if (threadIdx.x % 32 == 0) {
    if (hi) atomicMax(&state[0], hi);
    if (broken) atomicOr(&state[1], 1u);
  }
}

template <bool STORE, bool BARRIER, int PER>
__global__ void __launch_bounds__(kThreads)
scan_kernel(uint32_t* __restrict__ out, long long n, const int32_t* __restrict__ offsets,
            const uint32_t* __restrict__ data, long long cap, unsigned* __restrict__ state) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned hi = 0;
  bool broken = false;
  const long long groups = (cap + 3) / 4;
  for (long long g = tid * PER; g < groups; g += stride * PER) {
#pragma unroll
    for (int p = 0; p < PER; ++p)
      if (g + p < groups) group<STORE>(out, n, offsets, data, cap, g + p, hi, broken);
  }
  publish(hi, broken, state);
  if (BARRIER) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(&state[2], 1u);
      while (load_acquire(&state[2]) < gridDim.x) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    if (load_acquire(&state[1]) == 0) return;
  }
}

template <bool STORE, bool BARRIER, int PER>
cudaError_t run(uint32_t* o, long long n, const int32_t* off, const uint32_t* d, long long cap,
                unsigned* st, int sms, cudaStream_t s) {
  auto kernel = scan_kernel<STORE, BARRIER, PER>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = ((cap + 3) / 4 + PER * kThreads - 1) / (PER * kThreads);
  const long long most = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < most ? need : most);
  if (!BARRIER) {
    kernel<<<grid, kThreads, 0, s>>>(o, n, off, d, cap, st);
    return cudaGetLastError();
  }
  err = cudaMemsetAsync(st, 0, 3 * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  void* args[] = {&o, &n, &off, &d, &cap, &st};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(kThreads), args, 0, s);
}

}  // namespace

extern "C" {

// out: n words holding the copy already; offsets, data: cap entries
// (offsets 16-byte aligned); state: 3 uint32 of scratch
int dv_apply(int variant, void* out, long long n, const void* offsets, const void* data,
             long long cap, void* state, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const uint32_t* d = static_cast<const uint32_t*>(data);
  unsigned* st = static_cast<unsigned*>(state);
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0: err = run<true, true, 1>(o, n, off, d, cap, st, sms, s); break;
    case 1: err = run<true, false, 1>(o, n, off, d, cap, st, sms, s); break;
    case 2: err = run<false, false, 1>(o, n, off, d, cap, st, sms, s); break;
    case 3: err = run<true, false, 2>(o, n, off, d, cap, st, sms, s); break;
    case 4: err = cudaMemsetAsync(st, 0, 3 * sizeof(unsigned), s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
