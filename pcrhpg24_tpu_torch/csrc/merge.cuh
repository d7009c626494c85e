// B6 (and B6'): the exact per-pixel u64 min of a pid-SORTED stream, for
// Hopper (sm_90a): the kernel's device code, templated on a variant.
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
// Bound on the H100: device-memory bytes.  B6 reads 12 B per entry and
// its atomics land in a 16.6 MB plane at 1080p that stays in the 50 MB L2.
//
// `merge.cu` instantiates the defaults as the shipped kernel; the probes
// of `experiments/` (r3_matscatter, r2_merge_tune, r3_kernel_floor,
// r3_build_v2, r3_merge_micro, r3_merge_micro2) instantiate the variants
// below through `experiments/probes.cuh`'s launcher, so that their `full`
// is this code and not a copy.  The template values (the defaults are the
// shipped kernel):
//   kLesion  kWhole: the resolve (shipped); kNoAtomic: the scan's live
//            heads fold their keys (hi ^ lo, added) into the checksum and
//            issue nothing; kReadOnly: the loads alone, XOR-folded
//            (pid ^ dep ^ pay); kGrid: no load, each thread XOR-folds its
//            entry index; kCount: kWhole, and counts the atomics issued.
//            (No scan at all is kSteps = 0.)
//   kSteps   doubling steps of the scan, 0-5 (shipped 5): a head then
//            holds the min of the first 2**kSteps entries of its segment,
//            which is exact where no warp-local run is longer.
//   kGroups  independent 32-entry groups a warp (shipped 1): a warp loads
//            all of them, then scans them step by step side by side.
//   kStages  0: direct loads (shipped); else a persistent grid whose warps
//            walk their tiles through a per-thread ring of kStages slots
//            in shared memory, filled by 4-byte `cp.async`s kStages - 1
//            tiles ahead (a lane reads back only the words it copied, so
//            no barrier is needed).
//   kLoad    kArrays: pid, dep and pay arrays (shipped); kInterleaved:
//            one (n, 4) array of (pid, dep, pay, 0), one 16-byte load a
//            lane.
//   kCut     a bit set (shipped: none), each exact: kUniform, a warp that
//            is one run takes two `__reduce_min_sync`s (depth, then the
//            payload among depth ties) in place of the scan; kDistinct, a
//            warp whose lanes are all heads skips the scan; kEarly, the
//            scan stops once no lane has a partner left (`__any_sync`);
//            kGatherFirst, a head reads its plane word and issues no
//            atomicMin that cannot win (as B3 does).
//   kHead    kWarpHeads: warp-local heads and atomicMin (shipped);
//            kRunHeads: no scan, each head of a run of the whole stream
//            (i == 0 or pid[i - 1] != pid[i]) stores its key with one
//            plain u64 store: exact only on one stream sorted by the full
//            key (pid, dep, pay), where a run's head is its minimum.
// A lesion that writes no plane folds what it read or decided into one
// of kSlots checksum words, one atomic a block (`experiments/probes.py`
// folds the words), or nvcc would drop its work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace b6 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // a block
constexpr int kSlots = 32;     // checksum words, one 128-byte line apart
constexpr int kSlotPitch = 32;

enum Lesion { kWhole = 0, kNoAtomic = 1, kReadOnly = 2, kGrid = 3, kCount = 4 };
enum Load { kArrays = 0, kInterleaved = 1 };
enum Cut { kUniform = 1, kDistinct = 2, kEarly = 4, kGatherFirst = 8 };
enum Head { kWarpHeads = 0, kRunHeads = 1 };

template <int kLesion>
constexpr bool kXorFold = kLesion == kReadOnly || kLesion == kGrid;
template <int kLesion>
constexpr bool kAddFold = kLesion == kNoAtomic || kLesion == kCount;

// One past the last lane of this lane's run segment within the warp,
// from the warp's head bits.
__device__ __forceinline__ int segment_end(unsigned heads, int lane) {
  const unsigned later = heads & ~((2u << lane) - 1u);  // heads above lane
  return later ? __ffs(later) - 1 : 32;
}

__device__ __forceinline__ unsigned long long key_of(uint32_t d, uint32_t y) {
  return (static_cast<unsigned long long>(d) << 32) | y;
}

// Entry i of the stream, or (for i >= n) a lane that forms a run of its
// own and never lands.
template <int kLoad>
__device__ __forceinline__ void load(const uint32_t* __restrict__ pid,
                                     const uint32_t* __restrict__ dep,
                                     const uint32_t* __restrict__ pay, long long i, long long n,
                                     uint32_t& q, unsigned long long& key) {
  const bool valid = i < n;
  if constexpr (kLoad == kInterleaved) {
    const uint4 v = valid ? reinterpret_cast<const uint4*>(pid)[i]
                          : make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0u);
    q = v.x;
    key = key_of(v.y, v.z);
  } else {
    q = valid ? pid[i] : 0xffffffffu;
    key = valid ? key_of(dep[i], pay[i]) : ~0ull;
  }
}

// A warp's kGroups x 32 entries (lane l holds entry 32 g + l of group g,
// i0 is its entry of group 0) into the plane: the heads, the scan, then
// an atomicMin (or, for kRunHeads, a store) for each head of a live pid.
template <int kLesion, int kSteps, int kGroups, int kCut, int kHead>
__device__ __forceinline__ void resolve(const uint32_t (&q)[kGroups],
                                        unsigned long long (&key)[kGroups], long long i0,
                                        int lane, const uint32_t* __restrict__ pid,
                                        unsigned long long* __restrict__ plane, uint32_t size,
                                        uint32_t& fold) {
  if constexpr (kHead == kRunHeads) {
    static_assert(kGroups == 1 && kCut == 0 && kLesion == kWhole, "run heads: one group");
    const uint32_t prev = __shfl_up_sync(kFull, q[0], 1);
    // a live lane's entry exists, and so does the one before it
    if (q[0] < size && (lane == 0 ? i0 == 0 || pid[i0 - 1] != q[0] : prev != q[0]))
      plane[q[0]] = key[0];
    return;
  }
  bool head[kGroups];
  unsigned heads[kGroups];
  int end[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const uint32_t prev = __shfl_up_sync(kFull, q[g], 1);
    head[g] = lane == 0 || prev != q[g];
    heads[g] = __ballot_sync(kFull, head[g]);
    end[g] = segment_end(heads[g], lane);
  }
  static_assert(kCut == 0 || kGroups == 1, "the cuts take one group a warp");
  bool scanned = false;  // a cut did the scan's work
  if constexpr ((kCut & kUniform) != 0) {
    if (heads[0] == 1u) {  // one run: lane 0 its only head
      const uint32_t d = __reduce_min_sync(kFull, static_cast<uint32_t>(key[0] >> 32));
      const uint32_t y = __reduce_min_sync(
          kFull, static_cast<uint32_t>(key[0] >> 32) == d ? static_cast<uint32_t>(key[0])
                                                          : 0xffffffffu);
      key[0] = key_of(d, y);
      scanned = true;
    }
  }
  if constexpr ((kCut & kDistinct) != 0) scanned = scanned || heads[0] == kFull;
  if (!scanned) {
    for (int s = 1; s < (1 << kSteps); s <<= 1) {
      if constexpr ((kCut & kEarly) != 0) {
        if (!__any_sync(kFull, lane + s < end[0])) break;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const unsigned long long other = __shfl_down_sync(kFull, key[g], s);
        if (lane + s < end[g] && other < key[g]) key[g] = other;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (head[g] && q[g] < size) {
      if constexpr (kLesion == kNoAtomic) {
        fold += static_cast<uint32_t>(key[g] >> 32) ^ static_cast<uint32_t>(key[g]);
      } else {
        if constexpr ((kCut & kGatherFirst) != 0) {
          if (!(key[g] < __ldcg(plane + q[g]))) continue;
        }
        atomicMin(plane + q[g], key[g]);
        if constexpr (kLesion == kCount) ++fold;
      }
    }
  }
}

// The kernel's body: one thread per entry (kStages = 0), or a persistent
// warp per kStages ring (see the header).  `sums` is read by the lesions
// that fold (kXorFold, kAddFold) alone.
template <int kLesion = kWhole, int kSteps = 5, int kGroups = 1, int kStages = 0,
          int kLoad = kArrays, int kCut = 0, int kHead = kWarpHeads>
__device__ __forceinline__ void merge_nk1(const uint32_t* __restrict__ pid,
                                          const uint32_t* __restrict__ dep,
                                          const uint32_t* __restrict__ pay,
                                          unsigned long long* __restrict__ plane, long long n,
                                          uint32_t size, unsigned int* __restrict__ sums) {
  static_assert(kSteps >= 0 && kSteps <= 5, "0-5 doubling steps");
  static_assert(kHead == kWarpHeads || kLoad == kArrays, "run heads read pid[i - 1]");
  const int lane = threadIdx.x & 31;
  uint32_t fold = 0u;
  if constexpr (kStages > 0) {
    static_assert((kStages & (kStages - 1)) == 0 && kLoad == kArrays && kCut == 0 &&
                      kHead == kWarpHeads && kLesion == kWhole,
                  "the ring: a power of 2 of stages, the shipped resolve");
    constexpr int kTile = 32 * kGroups;  // entries a warp-tile
    extern __shared__ uint32_t ring[];   // [kStages][3][kGroups][blockDim.x]
    const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
    const long long w0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long tiles = (n + kTile - 1) / kTile;
    auto word = [&](int s, int a, int g) {
      return ring + ((s * 3 + a) * kGroups + g) * blockDim.x + threadIdx.x;
    };
    // tile k of this warp (if it has one) into slot k % kStages, as one
    // commit group (an empty one past the warp's last tile)
    auto fetch = [&](long long k) {
      const long long w = w0 + k * warps;
      if (w < tiles) {
        const int s = static_cast<int>(k % kStages);
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const long long i = w * kTile + 32 * g + lane;
          if (i < n) {
            async_copy::copy4(word(s, 0, g), pid + i);
            async_copy::copy4(word(s, 1, g), dep + i);
            async_copy::copy4(word(s, 2, g), pay + i);
          }
        }
      }
      async_copy::commit();
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) fetch(k);
    for (long long k = 0; w0 + k * warps < tiles; ++k) {  // warp-uniform
      fetch(k + kStages - 1);
      async_copy::wait_groups<kStages - 1>();  // tile k has landed
      const int s = static_cast<int>(k % kStages);
      const long long i0 = (w0 + k * warps) * kTile + lane;
      uint32_t q[kGroups];
      unsigned long long key[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const bool valid = i0 + 32 * g < n;
        q[g] = valid ? *word(s, 0, g) : 0xffffffffu;
        key[g] = valid ? key_of(*word(s, 1, g), *word(s, 2, g)) : ~0ull;
      }
      resolve<kLesion, kSteps, kGroups, kCut, kHead>(q, key, i0, lane, pid, plane, size, fold);
    }
    async_copy::wait_groups<0>();  // no copy in flight at exit
  } else {
    long long i0;
    if constexpr (kGroups == 1) {
      i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    } else {
      i0 = (static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31)) * kGroups +
           lane;
    }
    if constexpr (kLesion == kGrid) {
      static_assert(kGroups == 1, "the grid alone: one group");
      if (i0 < n) fold = static_cast<uint32_t>(i0);
    } else {
      uint32_t q[kGroups];
      unsigned long long key[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) load<kLoad>(pid, dep, pay, i0 + 32 * g, n, q[g], key[g]);
      if constexpr (kLesion == kReadOnly) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (i0 + 32 * g < n)
            fold ^= q[g] ^ static_cast<uint32_t>(key[g] >> 32) ^ static_cast<uint32_t>(key[g]);
      } else {
        resolve<kLesion, kSteps, kGroups, kCut, kHead>(q, key, i0, lane, pid, plane, size,
                                                       fold);
      }
    }
  }
  if constexpr (kXorFold<kLesion> || kAddFold<kLesion>) {
    // one atomic a block, into slot blockIdx.x % kSlots: one a warp (16.8M
    // entries: 524K atomics on 32 words) took longer than the loads
    static_assert(kStages == 0, "a fold takes the one-thread-an-entry grid");
    auto reduce = [](uint32_t v) {
      return kXorFold<kLesion> ? __reduce_xor_sync(kFull, v) : __reduce_add_sync(kFull, v);
    };
    __shared__ uint32_t warp_folds[kThreads / 32];
    const uint32_t v = reduce(fold);
    if (lane == 0) warp_folds[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
      const uint32_t b = reduce(lane < kThreads / 32 ? warp_folds[lane] : 0u);
      unsigned int* slot = sums + (blockIdx.x % kSlots) * kSlotPitch;
      if (lane == 0) {
        if constexpr (kXorFold<kLesion>) atomicXor(slot, b);
        else atomicAdd(slot, b);
      }
    }
  }
}

}  // namespace b6

