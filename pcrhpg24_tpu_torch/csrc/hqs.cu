// B4 and B9: HQS tolerance-gated (r, g, b, 1) sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_hqs_matscatter_kernel`
// (pcrhpg24_tpu/render/pallas_hqs.py:185, reached through
// `hqs_sums_from_rows` :316 -> `_hqs_rows_group` :360, pallas_call at
// :393).  The TPU has no atomics, so the reference sorts each chunk's
// stream by pid and scatters the accepted entries into the four planes
// with one-hot bf16 matmuls fed by a DMA ring.  Integer sums do not
// depend on order, so here each accepted entry of the UNSORTED stream
// does four 32-bit atomicAdds and the planes come out the same (the
// source paper's huffman_hqs/render.cu:274-316 does the same with two
// 64-bit atomics).
//
// Per entry: q = pid; accept = q < size && w <= old * 1.01f, with
// w = f32(dep bits) and old = f32(fb_depth[q] bits), the multiply
// rounded on its own (__fmul_rn; the library is built with
// -fmad=false).  An EMPTY depth (all ones) is a NaN and accepts nothing.
//
// Bound on the H100: device-memory bytes of the stream (12 B per entry
// read once) plus the planes' atomics, which stay in the 50 MB L2 at
// 1080p (4 x 8.4 MB planes + the 8.4 MB depth plane).  Design: a
// grid-stride loop, one entry per thread step, coalesced stream reads,
// the depth plane read through the read-only path (__ldg); sentinel
// pids (clipped or masked entries) skip everything after the pid read.
//
// B9 replaces the Pallas TPU kernel `_hqs_sum_kernel`
// (pcrhpg24_tpu/render/pallas_hqs.py:71, reached through
// `hqs_sums_from_sorted[_multi]` :307/:428, pallas_call at :528): the same
// four planes from a stream sorted by pid, which the TPU kernel walks in
// 1024-entry windows per tile with a segmented suffix-sum and a binary
// search per pixel.  Here: one thread per entry with B4's accept test;
// a warp-segmented sum over each run of equal pid (`__ballot_sync` for the
// segment ends, five `__shfl_down_sync` doubling steps, never past a
// segment end, so nothing is counted twice) leaves each run segment's
// (r, g, b, n) in its first lane, which does the four atomicAdds: four
// atomics per (warp, pixel) instead of per accepted entry.  Sums wrap mod
// 2**32 like the reference's u32 planes.  Bound: as B4, the stream's 12 B
// per entry read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hqs_sums_kernel(const uint32_t* __restrict__ pid,
                                const uint32_t* __restrict__ dep,
                                const uint32_t* __restrict__ pay,
                                const uint32_t* __restrict__ fb_depth,
                                unsigned int* __restrict__ planes,  // (4, size)
                                long long n, uint32_t size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t q = pid[i];
    if (q >= size) continue;
    const float w = __uint_as_float(dep[i]);
    const float old = __uint_as_float(__ldg(fb_depth + q));
    if (!(w <= __fmul_rn(old, 1.01f))) continue;
    const uint32_t p = pay[i];
    atomicAdd(planes + q, p & 255u);
    atomicAdd(planes + size + q, (p >> 8) & 255u);
    atomicAdd(planes + 2ull * size + q, (p >> 16) & 255u);
    atomicAdd(planes + 3ull * size + q, 1u);
  }
}

constexpr unsigned kFull = 0xffffffffu;

__global__ void hqs_sorted_kernel(const uint32_t* __restrict__ pid,
                                  const uint32_t* __restrict__ dep,
                                  const uint32_t* __restrict__ pay,
                                  const uint32_t* __restrict__ fb_depth,
                                  unsigned int* __restrict__ planes,  // (4, size)
                                  long long n, uint32_t size) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t q = i < n ? pid[i] : 0xffffffffu;
  unsigned int r = 0, g = 0, b = 0, c = 0;
  if (q < size) {
    const float w = __uint_as_float(dep[i]);
    const float old = __uint_as_float(__ldg(fb_depth + q));
    if (w <= __fmul_rn(old, 1.01f)) {
      const uint32_t p = pay[i];
      r = p & 255u;
      g = (p >> 8) & 255u;
      b = (p >> 16) & 255u;
      c = 1u;
    }
  }
  const uint32_t prev = __shfl_up_sync(kFull, q, 1);  // every lane shuffles
  const bool head = lane == 0 || prev != q;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads above lane
  const int end = later ? __ffs(later) - 1 : 32;
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned int r2 = __shfl_down_sync(kFull, r, s);
    const unsigned int g2 = __shfl_down_sync(kFull, g, s);
    const unsigned int b2 = __shfl_down_sync(kFull, b, s);
    const unsigned int c2 = __shfl_down_sync(kFull, c, s);
    if (lane + s < end) {
      r += r2;
      g += g2;
      b += b2;
      c += c2;
    }
  }
  if (head && q < size && c != 0) {
    atomicAdd(planes + q, r);
    atomicAdd(planes + size + q, g);
    atomicAdd(planes + 2ull * size + q, b);
    atomicAdd(planes + 3ull * size + q, c);
  }
}

}  // namespace

extern "C" int pcr_hqs_sums(const void* pid, const void* dep, const void* pay,
                            const void* fb_depth, void* planes, long long n,
                            int size, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  hqs_sums_kernel<<<static_cast<int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay), static_cast<const uint32_t*>(fb_depth),
      static_cast<unsigned int*>(planes), n, static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcr_hqs_sorted(const void* pid, const void* dep, const void* pay,
                              const void* fb_depth, void* planes, long long n,
                              int size, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  hqs_sorted_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay), static_cast<const uint32_t*>(fb_depth),
      static_cast<unsigned int*>(planes), n, static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}
