// B10: independent 3-key sort of every 1024-entry tile, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sort_kernel`
// (pcrhpg24_tpu/render/pallas_raster.py:101, through `tile_sort3` :113,
// pallas_call at :121): each (8, 128) tile of three int32 key planes is
// sorted ascending by (k0, k1, k2), compared as SIGNED int32.  The TPU
// kernel runs a bitonic network whose partner exchanges are
// `pltpu.roll`s of whole (8, 128) vregs.  Here: one 512-thread block
// per tile, the three key arrays in shared memory (12 KB), and the same
// bitonic network with one compare-exchange per thread per stage (55
// stages, a barrier before each).  A sorted sequence of triples is
// unique, so the output equals the reference's whatever the network.
//
// Bound on the H100: device-memory bytes, 12 B per entry read once and
// written once; the network's 55 barriers per tile are what it pays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;

__global__ void __launch_bounds__(kTile / 2)
tile_sort3_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                  const int* __restrict__ k2, int* __restrict__ o0,
                  int* __restrict__ o1, int* __restrict__ o2) {
  __shared__ int s0[kTile], s1[kTile], s2[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t = threadIdx.x;
  for (int e = t; e < kTile; e += kTile / 2) {
    s0[e] = k0[base + e];
    s1[e] = k1[base + e];
    s2[e] = k2[base + e];
  }
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      __syncthreads();
      // this thread's pair (i, i + d): i has bit d clear
      const int i = ((t & ~(d - 1)) << 1) | (t & (d - 1));
      const int j = i | d;
      const int a0 = s0[i], a1 = s1[i], a2 = s2[i];
      const int b0 = s0[j], b1 = s1[j], b2 = s2[j];
      const bool gt = a0 > b0 || (a0 == b0 && (a1 > b1 || (a1 == b1 && a2 > b2)));
      const bool lt = a0 < b0 || (a0 == b0 && (a1 < b1 || (a1 == b1 && a2 < b2)));
      const bool up = (i & size) == 0;  // ascending region
      if (up ? gt : lt) {
        s0[i] = b0; s1[i] = b1; s2[i] = b2;
        s0[j] = a0; s1[j] = a1; s2[j] = a2;
      }
    }
  }
  __syncthreads();
  for (int e = t; e < kTile; e += kTile / 2) {
    o0[base + e] = s0[e];
    o1[base + e] = s1[e];
    o2[base + e] = s2[e];
  }
}

}  // namespace

extern "C" int pcr_tile_sort3(const void* k0, const void* k1, const void* k2,
                              void* o0, void* o1, void* o2, long long tiles,
                              void* stream) {
  tile_sort3_kernel<<<static_cast<unsigned>(tiles), kTile / 2, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(k0), static_cast<const int*>(k1),
      static_cast<const int*>(k2), static_cast<int*>(o0), static_cast<int*>(o1),
      static_cast<int*>(o2));
  return static_cast<int>(cudaGetLastError());
}
