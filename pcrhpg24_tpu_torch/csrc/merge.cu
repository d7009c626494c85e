// B6 (and B6') and B8: dense framebuffer planes from a pid-SORTED stream,
// for Hopper (sm_90a).
//
// B6's device code, its design and its bound are `merge.cuh`'s; here it
// is instantiated with the header's defaults as the shipped kernel,
// `pcr_merge_nk1`.
//
// B8 replaces `_merge_kernel` (pallas_merge.py:137, through
// `dense_from_sorted` :1280, pallas_call at :1312).  Its stream is sorted
// by (pid, depth, payload), so a pixel's winner is the first entry of its
// run: one thread per entry, a run head (i == 0 or pid[i-1] != pid[i])
// with pid < size stores its payload (and its depth when the depth plane
// is asked for) with plain stores into EMPTY-filled planes.  No atomics:
// a pid has exactly one head.
//
// Bound on the H100: device-memory bytes.  B8 reads 8-12 B per entry and
// writes 4-8 B per live pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge.cuh"

namespace {

__global__ void merge_nk1_kernel(const uint32_t* __restrict__ pid,
                                 const uint32_t* __restrict__ dep,
                                 const uint32_t* __restrict__ pay,
                                 unsigned long long* __restrict__ plane,
                                 long long n, uint32_t size) {
  b6::merge_nk1<>(pid, dep, pay, plane, n, size, nullptr);
}

__global__ void merge_heads_kernel(const uint32_t* __restrict__ pid,
                                   const uint32_t* __restrict__ dep,  // may be null
                                   const uint32_t* __restrict__ pay,
                                   uint32_t* __restrict__ fb_d,  // may be null
                                   uint32_t* __restrict__ fb_p,
                                   long long n, uint32_t size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t q = pid[i];
    if (q < size && (i == 0 || pid[i - 1] != q)) {
      fb_p[q] = pay[i];
      if (fb_d != nullptr) fb_d[q] = dep[i];
    }
  }
}

}  // namespace

extern "C" int pcr_merge_nk1(const void* pid, const void* dep, const void* pay,
                             void* plane, long long n, int size, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  merge_nk1_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay),
      static_cast<unsigned long long*>(plane), n, static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcr_merge_heads(const void* pid, const void* dep, const void* pay,
                               void* fb_d, void* fb_p, long long n, int size,
                               void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  merge_heads_kernel<<<static_cast<int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay), static_cast<uint32_t*>(fb_d),
      static_cast<uint32_t*>(fb_p), n, static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}
