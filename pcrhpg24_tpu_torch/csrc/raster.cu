// B3: exact per-pixel u64 (depth << 32 | payload) min for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_merge_matscatter_kernel`
// (pcrhpg24_tpu/render/pallas_merge.py:467, reached through
// `dense_from_sorted_rows` :881 -> `_dense_rows_group` :1194, pallas_call
// at :1239).  The TPU has no atomics, so the reference sorts each chunk's
// stream (lax.sort) and merges the sorted rows into two EMPTY-filled u32
// planes.  Hopper has a 64-bit atomicMin, which gives the same planes in
// any order: this kernel resolves the UNSORTED stream, and the sort
// disappears from the frame (the source paper's own design,
// render.cu:276-303).
//
// The plane is one unsigned long long per swizzled pixel id, all ones
// at the start (EMPTY in both halves); the caller splits it into the
// depth and payload planes.
//
// Bound on the H100: the atomics' traffic to L2 — 12 B of stream read
// per entry, one 8-byte atomic per live entry into a 16.8 MB plane at
// 1080p that stays L2-resident.  Design: a grid-stride loop, one entry
// per thread step, coalesced stream reads; entries whose pid is the
// sentinel (clipped, masked or retired by the collapse) skip the atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void u64_min_kernel(const uint32_t* __restrict__ pid,
                               const uint32_t* __restrict__ dep,
                               const uint32_t* __restrict__ pay,
                               unsigned long long* __restrict__ plane,
                               long long n, uint32_t size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t q = pid[i];
    if (q < size) {
      const unsigned long long key =
          (static_cast<unsigned long long>(dep[i]) << 32) | pay[i];
      atomicMin(plane + q, key);
    }
  }
}

}  // namespace

extern "C" int pcr_u64_min(const void* pid, const void* dep, const void* pay,
                           void* plane, long long n, int size, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  u64_min_kernel<<<static_cast<int>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay),
      static_cast<unsigned long long*>(plane), n,
      static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}
