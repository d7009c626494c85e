// The card's counterpart of the TPU probe
// `experiments/exp_pallas_scatter_probe.py` (its pallas_calls at :31 and,
// chained, :63): what a random min-store costs.  The TPU probe runs 8192
// serial scalar min-stores from SMEM into one 1 MB VMEM tile; here each
// entry is an atomicMin into a plane in device memory, from one thread
// (the TPU's serial order), one warp or a full grid (a grid-stride loop
// whatever the launch).  T is int (the TPU probe's int32 min) or
// unsigned long long (B3's u64 key).  `flip` is XORed into every value:
// a chained launch's perturbation, as the TPU probe's.
//
// Bound: each entry's index and value read once, the plane written once;
// a random atomic moves a 32-byte L2 sector, so the atomics, not those
// bytes, are what the probe measures.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void scatter_min(const int* __restrict__ idx, const T* __restrict__ val,
                            long long n, T* __restrict__ plane, T flip) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    atomicMin(plane + idx[i], val[i] ^ flip);
}

}  // namespace

// n entries (idx int32, val int32 or u64 when `wide`) min-stored into
// plane, on `blocks` x `threads`.
extern "C" int pcr_probe_scatter(int wide, int blocks, int threads, const void* idx,
                                 const void* val, long long n, void* plane, long long flip,
                                 void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int*>(idx);
  if (wide)
    scatter_min<unsigned long long><<<blocks, threads, 0, s>>>(
        i, static_cast<const unsigned long long*>(val), n,
        static_cast<unsigned long long*>(plane), static_cast<unsigned long long>(flip));
  else
    scatter_min<int><<<blocks, threads, 0, s>>>(i, static_cast<const int*>(val), n,
                                                static_cast<int*>(plane),
                                                static_cast<int>(flip));
  return static_cast<int>(cudaGetLastError());
}
