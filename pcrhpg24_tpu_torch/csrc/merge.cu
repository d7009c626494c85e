// B6 (and B6') and B8: dense framebuffer planes from a pid-SORTED stream,
// for Hopper (sm_90a).
//
// B6 replaces the Pallas TPU kernels `_merge_nk1_kernel_ilp` and
// `_merge_nk1_kernel` (pcrhpg24_tpu/render/pallas_merge.py:362 and :278,
// reached through `dense_from_sorted_nk1[_multi]` :674/:716 ->
// `_dense_nk1_group` :748, pallas_call at :845).  Both compute one
// function: the exact per-pixel u64 (depth << 32 | payload) min of a
// stream sorted by pid alone, with (depth, payload) in any order inside
// a pid run.  The TPU kernels walk 1024-entry windows per framebuffer
// tile (window tables in SMEM, a DMA ring, an in-register segmented
// suffix-min and a binary search per pixel), because the TPU has no
// atomics and no scattered stores.  `ilp` only picks how many windows
// one TPU loop body interleaves, so B6' is this same kernel.
//
// Here: one thread per entry.  The sort makes a pixel's entries
// contiguous, so a warp holds a few runs; a warp-segmented min over the
// run (`__ballot_sync` finds each lane's segment end, five
// `__shfl_down_sync` doubling steps fold the u64 keys toward the head)
// leaves each run segment's min in its first lane, which does ONE
// `atomicMin(unsigned long long)` into a plane that starts at all ones
// (EMPTY in both halves).  That is one atomic per (warp, pixel) instead
// of B3's one per entry: the point of the sort.  A run that crosses a
// warp boundary takes one atomic per warp it touches and stays exact
// (min is associative).  Segments are maximal stretches of equal pid,
// so an unsorted stream still gives the exact planes, with more atomics.
// Pids >= size (clipped or masked entries, at the sorted tail) drop.
//
// B8 replaces `_merge_kernel` (pallas_merge.py:137, through
// `dense_from_sorted` :1280, pallas_call at :1312).  Its stream is sorted
// by (pid, depth, payload), so a pixel's winner is the first entry of its
// run: one thread per entry, a run head (i == 0 or pid[i-1] != pid[i])
// with pid < size stores its payload (and its depth when the depth plane
// is asked for) with plain stores into EMPTY-filled planes.  No atomics:
// a pid has exactly one head.
//
// Bound on the H100: device-memory bytes.  B6 reads 12 B per entry and
// its atomics land in a 16.6 MB plane at 1080p that stays in the 50 MB L2;
// B8 reads 8-12 B per entry and writes 4-8 B per live pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One past the last lane of this lane's run segment within the warp.
__device__ __forceinline__ int segment_end(bool head, int lane) {
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads above lane
  return later ? __ffs(later) - 1 : 32;
}

__global__ void merge_nk1_kernel(const uint32_t* __restrict__ pid,
                                 const uint32_t* __restrict__ dep,
                                 const uint32_t* __restrict__ pay,
                                 unsigned long long* __restrict__ plane,
                                 long long n, uint32_t size) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  // lanes past the end form a run of their own that never lands
  const uint32_t q = valid ? pid[i] : 0xffffffffu;
  unsigned long long key =
      valid ? (static_cast<unsigned long long>(dep[i]) << 32) | pay[i] : ~0ull;
  const uint32_t prev = __shfl_up_sync(kFull, q, 1);
  const bool head = lane == 0 || prev != q;
  const int end = segment_end(head, lane);
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned long long other = __shfl_down_sync(kFull, key, s);
    if (lane + s < end && other < key) key = other;
  }
  if (head && q < size) atomicMin(plane + q, key);
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
