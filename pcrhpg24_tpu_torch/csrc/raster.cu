// B3: exact per-pixel u64 (depth << 32 | payload) min for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_merge_matscatter_kernel`
// (pcrhpg24_tpu/render/pallas_merge.py:467, reached through
// `dense_from_sorted_rows` :881 -> `_dense_rows_group` :1194, pallas_call
// at :1239).  The TPU has no atomics, so the reference sorts each chunk's
// stream (lax.sort) and merges the sorted rows into two EMPTY-filled u32
// planes.  Hopper has a 64-bit atomicMin, which gives the same planes in
// any order: this kernel resolves the UNSORTED streams, and the sort
// disappears from the frame (the source paper's own design,
// render.cu:276-303).  The plane is one unsigned long long per swizzled
// pixel id, all ones at the start (EMPTY in both halves); the wrapper
// hands its two u32 halves on.  Pids >= size drop.
//
// Bound on the H100: device-memory bytes, each part's 12 B per entry read
// once and the 8 B per pixel plane written once (16.7 MB at 1080p, which
// stays in the 50 MB L2 while the kernel runs).  What held the first
// design back was the atomics: one 64-bit L2 read-modify-write per live
// entry (about 2M per colour orbit chunk, 4.2M in HQS mode), although most
// entries lose to a nearer point already in the plane, and one launch per
// chunk.  This design:
//  * one launch for all of a frame's parts: their pointers travel by
//    value in the kernel's parameters (up to 64 parts a launch, the
//    `Parts` of tiles.cuh, as B4), with no host-to-device copy;
//  * compare, then atomicMin.  Each lane first gathers the plane words of
//    its 16 entries (16 loads in flight, through L2 where the atomics
//    land; the flat layout's 8 a pass through L1), then an entry does its
//    atomicMin only if its key is below the word read.  This is exact whatever value the load sees: the plane
//    only ever falls, so a key that does not beat an earlier value cannot
//    beat the current one.  A key of all ones never lands, as in the
//    plain version;
//  * two layouts of a part, a template value of the kernel (`Layout` in
//    tiles.cuh).  kChain, the `.tpc` and `.huffman` streams: a warp
//    takes a 32-row x 16-column tile of a part (32 consecutive points of
//    16 chains) and reads it back transposed (`tiles::load_tile`), so
//    the lanes of one load or atomic instruction are Morton-adjacent
//    points of one chain, which mostly share a pixel and so a plane word
//    (warps over 32 consecutive entries, 32 chains, ran slower).  kFlat,
//    the `.las` and Potree parts (one entry a point, in file or node
//    order): a warp takes 512 consecutive entries straight into
//    registers (`tiles::load_flat`, 8 columns a pass): coalesced loads,
//    no shared-memory staging and no transpose.  Both layouts hold 4
//    blocks (32 warps) an SM: the chain one by its 52 KB a block, the
//    flat one by its 64 registers a thread (`__launch_bounds__`);
//  * evict-first stream reads, so the plane keeps the L2.
// Combining the lanes of one pixel in the warp before the atomic (B4's
// `__match_any_sync` groups, a segmented min over runs of one pid, or
// dropping a key that the lane below beats) cut the atomics but cost more
// than they saved once the compare skips the losers, so no lane combines
// in the chain layout.  In the flat layout two consecutive entries share
// a pixel about once in 3,000 or fewer (`chip_smoke.py` counts them on the
// `.las` and Potree parts), so a drop of keys that the next lane beats
// has nothing to save either.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kPitch;
using tiles::kTileWords;
using tiles::Parts;
constexpr int kWarps = 8;  // warps per block, one tile each
constexpr int kSmemBytes = kWarps * 3 * kTileWords * 4;  // 52,224 B

template <int kLayout>
__global__ void __launch_bounds__(kWarps * 32, 4)
u64_min_kernel(const __grid_constant__ Parts parts,
               unsigned long long* __restrict__ plane, uint32_t size) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= parts.tile0[parts.count]) return;  // the whole warp; no barrier
  if constexpr (kLayout == tiles::kFlat) {
    // lane l holds entries l, 32 + l, ... of the tile's 512, kFlatCols at
    // a time: the plane words of its live entries first, then an
    // atomicMin for each key below its word (a dead entry reads 0, which
    // no key is below).  The words come through L1 (`__ldca`): a Potree
    // node's points land near each other, so the lines one warp fetches
    // serve the next.  An L1 line may be older than the atomics in L2,
    // but the plane only falls within the launch, so an old word is never
    // below the current one and the compare stays exact.
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += tiles::kFlatCols) {
      uint32_t q[tiles::kFlatCols], d[tiles::kFlatCols], y[tiles::kFlatCols];
      tiles::load_flat(parts, t, lane, c0, q, d, y);
      unsigned long long old[tiles::kFlatCols];
#pragma unroll
      for (int c = 0; c < tiles::kFlatCols; ++c)
        old[c] = q[c] < size ? __ldca(plane + q[c]) : 0ull;
#pragma unroll
      for (int c = 0; c < tiles::kFlatCols; ++c) {
        const unsigned long long key = (static_cast<unsigned long long>(d[c]) << 32) | y[c];
        if (key < old[c]) atomicMin(plane + q[c], key);
      }
    }
  } else {
    extern __shared__ uint32_t tile[];
    uint32_t* sp = tile + warp * 3 * kTileWords;
    uint32_t* sd = sp + kTileWords;
    uint32_t* sy = sd + kTileWords;
    tiles::load_tile(parts, t, lane, sp, sd, sy);
    // lane l holds point l of the band in each of the tile's 16 chains: the
    // plane words of its live entries first, then an atomicMin for each key
    // below its word (a dead entry reads 0, which no key is below)
    unsigned long long old[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint32_t q = sp[lane * kPitch + c];
      old[c] = q < size ? __ldcg(plane + q) : 0ull;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int at = lane * kPitch + c;
      const unsigned long long key = (static_cast<unsigned long long>(sd[at]) << 32) | sy[at];
      if (key < old[c]) atomicMin(plane + sp[at], key);
    }
  }
}

// One launch of the kernel in kLayout over `count` (<= 64) parts.
template <int kLayout>
int launch_u64_min(const void* const* pid, const void* const* dep, const void* const* pay,
                   const long long* n, int count, void* plane, int size, void* stream) {
  Parts parts;
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, kLayout))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kLayout == tiles::kFlat ? 0 : kSmemBytes;
  static bool attr_set = false;
  if (!attr_set && smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        u64_min_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (parts.tile0[count] + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  u64_min_kernel<kLayout><<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<unsigned long long*>(plane), static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3 over `count` (<= 64) parts: pid/dep/pay are host arrays of the parts'
// device pointers, n of their entry counts; plane is the (size,) u64 plane.
// pcr_u64_min takes chain-layout parts, pcr_u64_min_flat flat ones.
extern "C" int pcr_u64_min(const void* const* pid, const void* const* dep,
                           const void* const* pay, const long long* n, int count,
                           void* plane, int size, void* stream) {
  return launch_u64_min<tiles::kChain>(pid, dep, pay, n, count, plane, size, stream);
}

extern "C" int pcr_u64_min_flat(const void* const* pid, const void* const* dep,
                                const void* const* pay, const long long* n, int count,
                                void* plane, int size, void* stream) {
  return launch_u64_min<tiles::kFlat>(pid, dep, pay, n, count, plane, size, stream);
}
