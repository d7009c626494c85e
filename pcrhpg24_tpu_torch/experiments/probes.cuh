// The card's counterpart of the TPU probes of B3's merge
// (`experiments/r3_mat_lesion.py`, `r4_floor.py`, `r4_winsize.py`): B3's
// body (`csrc/raster.cu`, `u64_min_kernel`) re-stated with a lesion and
// a tile width as template values, for the probe modules beside this
// file to time on the frames' parts.  The loads are the shipped ones
// (`tiles.cuh`) wherever the width is the shipped width and the entries
// are read; `kFull` at the shipped width is the shipped kernel.
//
// What a lesion keeps of B3, per warp-tile (32 entries x kCols):
//   kFull       stream read, plane gather, compare, atomicMin (shipped);
//   kAtomicAll  stream read, an atomicMin for every live entry (exact:
//               the minimum does not depend on the compare);
//   kNoAtomic   stream read, gather and compare; counts the would-be
//               atomics (against a plane that stays EMPTY: every live
//               key but all ones);
//   kFloor      the stream read alone; XORs every word it loaded;
//   kNoLoad     gather, compare and atomic on entries made in registers
//               from a hash of the entry's index (`made`), no stream read;
//   kCount      kFull, and counts the atomics it issued;
//   kNoop       the grid and the tile's part lookup alone (chain layout);
//               XORs each tile's (part, index).
// A lesion that writes no plane folds what it read or decided into a
// checksum, or nvcc would drop its work: each warp reduces its lanes'
// folds and adds or XORs the result into one of kSlots words (one word
// would serialise every warp's atomic on one L2 line); the wrapper folds
// the slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace probes {

using tiles::kFull;
using tiles::kRow;
using tiles::Parts;

constexpr int kWarps = 8;      // warps per block, one tile each, as B3
constexpr int kSlots = 32;     // checksum words, one 128-byte line apart
constexpr int kSlotPitch = 32;

enum Lesion { kFullB3 = 0, kAtomicAll = 1, kNoAtomic = 2, kFloor = 3, kNoLoad = 4,
              kCount = 5, kNoop = 6 };

// the lesions whose checksum is an XOR, and those whose checksum is a count
template <int kLesion>
constexpr bool kXorFold = kLesion == kFloor || kLesion == kNoop;
template <int kLesion>
constexpr bool kAddFold = kLesion == kNoAtomic || kLesion == kCount;

// lowbias32 (a 32-bit integer hash): every step wraps mod 2**32
__host__ __device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// kNoLoad's entry e of part p: a pixel and a depth from the hash, the
// index as the payload (`probes.made_parts` is its plain version)
__device__ __forceinline__ void made(int p, long long e, uint32_t size, uint32_t& q,
                                     uint32_t& d, uint32_t& y) {
  const uint32_t h = mix(static_cast<uint32_t>(e) + static_cast<uint32_t>(p) * 0x9e3779b9u);
  q = h % size;
  d = mix(h ^ 0x5bd1e995u);
  y = static_cast<uint32_t>(e);
}

// Chain tiles of kCols columns: 32 rows x kCols, kRow / kCols column
// blocks a 32-row band of a part.
template <int kCols>
__host__ __device__ inline int chain_tiles(long long n) {
  const long long rows = (n + kRow - 1) / kRow;
  return static_cast<int>((rows + 31) / 32) * (kRow / kCols);
}

// tiles::load_tile at kCols columns, from the stream or (kMade) made in
// registers.  At the shipped width, reading the stream, it is load_tile.
template <int kCols, bool kMade>
__device__ __forceinline__ void load_tile(const Parts& parts, int t, int lane, uint32_t size,
                                          uint32_t* sp, uint32_t* sd, uint32_t* sy) {
  if constexpr (kCols == tiles::kCols && !kMade) {
    tiles::load_tile(parts, t, lane, sp, sd, sy);
  } else {
    constexpr int kPitch = kCols + 1;
    constexpr int kRowsAStep = 32 / kCols;
    int local;
    const int p = tiles::part_of(parts, t, local);
    const long long n = parts.n[p];
    const long long base = static_cast<long long>(local / (kRow / kCols)) * 32 * kRow +
                           (local % (kRow / kCols)) * kCols + (lane % kCols);
#pragma unroll 8
    for (int r2 = 0; r2 < kCols; ++r2) {  // kRowsAStep tile rows a step
      const int r = kRowsAStep * r2 + lane / kCols;
      const long long e = base + static_cast<long long>(r) * kRow;
      const bool in = e < n;
      const int at = r * kPitch + (lane % kCols);
      uint32_t q = kFull, d = 0u, y = 0u;
      if constexpr (kMade) {
        if (in) made(p, e, size, q, d, y);
      } else if (in) {
        q = __ldcs(parts.pid[p] + e);
        d = __ldcs(parts.dep[p] + e);
        y = __ldcs(parts.pay[p] + e);
      }
      sp[at] = q;
      sd[at] = d;
      sy[at] = y;
    }
    __syncwarp();
  }
}

// tiles::load_flat at kPass columns a pass, from the stream or (kMade)
// made in registers.  At the shipped width, reading the stream, it is
// load_flat.
template <int kPass, bool kMade>
__device__ __forceinline__ void load_flat(const Parts& parts, int t, int lane, int c0,
                                          uint32_t size, uint32_t (&q)[kPass],
                                          uint32_t (&d)[kPass], uint32_t (&y)[kPass]) {
  if constexpr (kPass == tiles::kFlatCols && !kMade) {
    tiles::load_flat(parts, t, lane, c0, q, d, y);
  } else {
    int local;
    const int p = tiles::part_of(parts, t, local);
    const long long n = parts.n[p];
    const long long base = static_cast<long long>(local) * tiles::kFlatTile + 32 * c0 + lane;
#pragma unroll
    for (int c = 0; c < kPass; ++c) {
      const long long e = base + 32 * c;
      const bool in = e < n;
      q[c] = kFull;
      d[c] = 0u;
      y[c] = 0u;
      if constexpr (kMade) {
        if (in) made(p, e, size, q[c], d[c], y[c]);
      } else if (in) {
        q[c] = __ldcs(parts.pid[p] + e);
        d[c] = __ldcs(parts.dep[p] + e);
        y[c] = __ldcs(parts.pay[p] + e);
      }
    }
  }
}

// B3's compare-then-atomicMin over kW columns of a lane (pid(c), key(c)),
// with the lesion's cuts; plane words through L1 (kL1, the flat layout)
// or L2 only (the chain layout), as the shipped kernel reads them.
template <int kLesion, bool kL1, int kW, typename Pid, typename Key>
__device__ __forceinline__ void resolve(const Pid& pid, const Key& key,
                                        unsigned long long* __restrict__ plane,
                                        uint32_t size, uint32_t& fold) {
  if constexpr (kLesion == kFloor) {
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const unsigned long long k = key(c);
      fold ^= pid(c) ^ static_cast<uint32_t>(k >> 32) ^ static_cast<uint32_t>(k);
    }
  } else if constexpr (kLesion == kAtomicAll) {
#pragma unroll
    for (int c = 0; c < kW; ++c)
      if (pid(c) < size) atomicMin(plane + pid(c), key(c));
  } else {
    unsigned long long old[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      old[c] = q < size ? (kL1 ? __ldca(plane + q) : __ldcg(plane + q)) : 0ull;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const unsigned long long k = key(c);
      if constexpr (kLesion == kNoAtomic) {
        fold += k < old[c] ? 1u : 0u;
      } else if (k < old[c]) {
        atomicMin(plane + pid(c), k);
        if constexpr (kLesion == kCount) ++fold;
      }
    }
  }
}

// B3 in kLayout with lesion kLesion; kWidth is the chain tile's columns
// (shipped: 16) or the flat tile's columns a pass (shipped: 8).  Parts
// carry tile0 for that width (`make_parts`).
template <int kLayout, int kLesion, int kWidth>
__global__ void __launch_bounds__(kWarps * 32, 4)
b3_probe(const __grid_constant__ Parts parts, unsigned long long* __restrict__ plane,
         uint32_t size, unsigned int* __restrict__ sums) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= parts.tile0[parts.count]) return;  // the whole warp; no barrier
  constexpr bool kMade = kLesion == kNoLoad;
  uint32_t fold = 0u;
  if constexpr (kLesion == kNoop) {
    int local;
    const int p = tiles::part_of(parts, t, local);
    fold = lane == 0 ? static_cast<uint32_t>(local) ^ (static_cast<uint32_t>(p) << 24) : 0u;
  } else if constexpr (kLayout == tiles::kFlat) {
#pragma unroll 1
    for (int c0 = 0; c0 < tiles::kCols; c0 += kWidth) {
      uint32_t q[kWidth], d[kWidth], y[kWidth];
      load_flat<kWidth, kMade>(parts, t, lane, c0, size, q, d, y);
      resolve<kLesion, true, kWidth>(
          [&](int c) { return q[c]; },
          [&](int c) { return (static_cast<unsigned long long>(d[c]) << 32) | y[c]; },
          plane, size, fold);
    }
  } else {
    constexpr int kPitch = kWidth + 1;
    constexpr int kTileWords = 32 * kPitch;
    extern __shared__ uint32_t tile[];
    uint32_t* sp = tile + warp * 3 * kTileWords;
    uint32_t* sd = sp + kTileWords;
    uint32_t* sy = sd + kTileWords;
    load_tile<kWidth, kMade>(parts, t, lane, size, sp, sd, sy);
    // lane l holds point l of the band in each of the tile's chains
    resolve<kLesion, false, kWidth>(
        [&](int c) { return sp[lane * kPitch + c]; },
        [&](int c) {
          const int at = lane * kPitch + c;
          return (static_cast<unsigned long long>(sd[at]) << 32) | sy[at];
        },
        plane, size, fold);
  }
  if constexpr (kXorFold<kLesion> || kAddFold<kLesion>) {
    const uint32_t v = kXorFold<kLesion> ? __reduce_xor_sync(kFull, fold)
                                         : __reduce_add_sync(kFull, fold);
    unsigned int* slot = sums + (t % kSlots) * kSlotPitch;
    if (lane == 0) {
      if constexpr (kXorFold<kLesion>) atomicXor(slot, v);
      else atomicAdd(slot, v);
    }
  }
}

// The Parts of `count` parts for kLayout at kWidth: the shipped ones,
// with the chain tiles recounted at kWidth columns; false if out of range.
template <int kLayout, int kWidth>
inline bool make_parts(Parts& parts, const void* const* pid, const void* const* dep,
                       const void* const* pay, const long long* n, int count) {
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, kLayout)) return false;
  if constexpr (kLayout == tiles::kChain)
    for (int p = 0; p < count; ++p)
      parts.tile0[p + 1] = parts.tile0[p] + chain_tiles<kWidth>(n[p]);
  return true;
}

// One launch of b3_probe<kLayout, kLesion, kWidth> over `count` (<= 64)
// parts; sums is kSlots x kSlotPitch words, zeroed by the caller.
template <int kLayout, int kLesion, int kWidth>
int launch_b3(const void* const* pid, const void* const* dep, const void* const* pay,
              const long long* n, int count, void* plane, int size, void* sums,
              void* stream) {
  Parts parts;
  if (!make_parts<kLayout, kWidth>(parts, pid, dep, pay, n, count))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kLayout == tiles::kFlat || kLesion == kNoop
                       ? 0 : kWarps * 3 * 32 * (kWidth + 1) * 4;
  auto kernel = b3_probe<kLayout, kLesion, kWidth>;
  static bool attr_set = false;
  if (!attr_set && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (parts.tile0[count] + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<unsigned long long*>(plane), static_cast<uint32_t>(size),
      static_cast<unsigned int*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probes

// One instance of b3_probe as a case of a probe module's C entry point,
// whose arguments are (layout, lesion, width, then pcr_u64_min's, then
// the checksum words): `int symbol(int layout, int lesion, int width,
// const void* const* pid, const void* const* dep, const void* const*
// pay, const long long* n, int count, void* plane, int size, void* sums,
// void* stream)`.
#define PCR_B3_CASE(L, K, W)                                                        \
  if (layout == (L) && lesion == (K) && width == (W))                               \
  return probes::launch_b3<L, K, W>(pid, dep, pay, n, count, plane, size, sums, stream)
