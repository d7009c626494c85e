// The card's counterpart of the TPU probes of B3's merge
// (`experiments/r3_mat_lesion.py`, `r4_floor.py`, `r4_winsize.py`,
// `r3_corient.py`, `r3_flushacc.py`, `r3_i8dot.py`, `r3_p4dot.py`,
// `r4_pwin.py`): B3's body (`csrc/raster.cu`, `u64_min_kernel`) re-stated
// with a lesion, a tile width and a way to read the tile (a form) as
// template values, for the probe modules beside this file to time on the
// frames' parts.  The loads are the shipped ones (`tiles.cuh`) wherever
// the width is the shipped width, the form kStaged and the entries are
// read; `kFull` at the shipped width and form is the shipped kernel.
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
//               XORs each tile's (part, index);
//   kCombine    kFull with a warp's same-pixel keys combined first: for
//               each column, the lanes of one pid (`__match_any_sync`)
//               take their least key (two `__reduce_min_sync`s: depth,
//               then the payload of the lanes at that depth), and the
//               lowest of them alone issues one atomicMin, if that key
//               is below its gathered word (exact);
//   kCombineCount     kCombine, and counts the atomics it issued;
//   kCombineWouldBe   kCombine against a plane that stays EMPTY: counts
//               the (tile, column, pid) groups of live entries with a key
//               below all ones, and issues nothing;
//   kDepthPass  a u32 atomicMin of each depth into a u32 depth plane
//               (the first half of `plane`'s words), after a compare
//               with the depth gathered from it;
//   kPayPass    after kDepthPass, in another launch: each live entry whose
//               depth equals its pixel's final depth issues a u32
//               atomicMin of its payload into the payload plane (the
//               second half); the two planes are the u64 plane's halves;
//   kHalfGather kFull with the compare narrowed to the depth half of the
//               plane word (a 4-byte gather, `d <= plane_d`); the
//               atomicMin stays u64 (exact: an entry it skips has a
//               depth above the word's, so a key above the word).
//
// How a warp reads its tile (kForm; the shipped kernel: kStaged):
//   kStaged     `tiles::load_tile` / `load_flat`, the shipped loads;
//   kRowLoad    chain: lane l reads row l of its tile itself, its 16
//               columns (64 bytes of each stream) as four 16-byte loads,
//               into registers: no shared memory, no transpose;
//   kShflLoad   chain: the shipped coalesced loads (16 lanes a row, two
//               rows an instruction), then a 32 x 16 register transpose
//               by `__shfl_sync` rounds, so that lane l holds row l (its
//               columns in a rotated order);
//   kRowLoad8, kShflLoad8   the same, 8 columns a pass (two passes a
//               tile, as the flat layout resolves its tile): half the
//               registers; kShflLoad8 loads with 8 lanes a row;
//   kPosition   tiles cut at fixed positions of the launch's parts laid
//               end to end, not per part: chain, 32-row bands of the
//               parts' rows (staged as kStaged); flat, runs of 512
//               entries.  Each row or entry walks forward to its own
//               part, so a tile may read from several parts, and no
//               tile is padded at a part's end.
// Every form keeps the shipped 4 blocks an SM (64 registers a thread):
// the 16-column register forms hold 48 words of the tile and 16 plane
// words a lane, and ptxas spills what does not fit.
// A lesion that writes no plane folds what it read or decided into a
// checksum, or nvcc would drop its work: each warp reduces its lanes'
// folds and adds or XORs the result into one of kSlots words (one word
// would serialise every warp's atomic on one L2 line); the wrapper folds
// the slots.
//
// At the end, for the B6 probes (`r3_matscatter.cu`, `r2_merge_tune.cu`):
// B6's body (`csrc/merge.cuh`) with its template values as a kernel of
// its own, its launcher, and PCR_B6_CASE.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge.cuh"
#include "tiles.cuh"

namespace probes {

using tiles::kFull;
using tiles::kRow;
using tiles::Parts;

constexpr int kWarps = 8;      // warps per block, one tile each, as B3
constexpr int kSlots = 32;     // checksum words, one 128-byte line apart
constexpr int kSlotPitch = 32;

enum Lesion { kFullB3 = 0, kAtomicAll = 1, kNoAtomic = 2, kFloor = 3, kNoLoad = 4,
              kCount = 5, kNoop = 6, kCombine = 7, kCombineCount = 8, kCombineWouldBe = 9,
              kDepthPass = 10, kPayPass = 11, kHalfGather = 12 };
enum Form { kStaged = 0, kRowLoad = 1, kShflLoad = 2, kPosition = 3, kRowLoad8 = 4,
            kShflLoad8 = 5 };
// columns a pass of a register form (0: not one)
template <int kForm>
constexpr int kPassCols = kForm == kRowLoad || kForm == kShflLoad     ? tiles::kCols
                          : kForm == kRowLoad8 || kForm == kShflLoad8 ? tiles::kCols / 2
                                                                      : 0;

// the lesions whose checksum is an XOR, and those whose checksum is a count
template <int kLesion>
constexpr bool kXorFold = kLesion == kFloor || kLesion == kNoop;
template <int kLesion>
constexpr bool kAddFold = kLesion == kNoAtomic || kLesion == kCount ||
                          kLesion == kCombineCount || kLesion == kCombineWouldBe;
template <int kLesion>
constexpr bool kCombined = kLesion == kCombine || kLesion == kCombineCount ||
                           kLesion == kCombineWouldBe;

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

// Rows of a chain part of n entries
__host__ __device__ __forceinline__ long long chain_rows(long long n) {
  return (n + kRow - 1) / kRow;
}

// The first entry of chain tile t's row `lane`, column c0 (16-column
// tiles), and its part.
__device__ __forceinline__ long long row_entry(const Parts& parts, int t, int lane, int c0,
                                               int& p) {
  int local;
  p = tiles::part_of(parts, t, local);
  constexpr int kBlocks = kRow / tiles::kCols;
  return static_cast<long long>(local / kBlocks) * 32 * kRow +
         static_cast<long long>(lane) * kRow + (local % kBlocks) * tiles::kCols + c0;
}

__device__ __forceinline__ void unpack(const uint4& v, uint32_t* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// kRowLoad, kRowLoad8: columns c0 .. c0 + kW - 1 of row `lane` of chain
// tile t, kW / 4 16-byte evict-first loads of each stream (the part
// pointers are 16-byte aligned: the wrapper checks); a row that ends
// inside them is read entry by entry up to n.  Entries past n read kFull,
// 0, 0.
template <int kW>
__device__ __forceinline__ void load_row_pass(const Parts& parts, int t, int lane, int c0,
                                              uint32_t (&q)[kW], uint32_t (&d)[kW],
                                              uint32_t (&y)[kW]) {
  int p;
  const long long e0 = row_entry(parts, t, lane, c0, p);
  const long long n = parts.n[p];
  if (e0 + kW <= n) {
    const uint4* gp = reinterpret_cast<const uint4*>(parts.pid[p] + e0);
    const uint4* gd = reinterpret_cast<const uint4*>(parts.dep[p] + e0);
    const uint4* gy = reinterpret_cast<const uint4*>(parts.pay[p] + e0);
#pragma unroll
    for (int v = 0; v < kW / 4; ++v) {
      unpack(__ldcs(gp + v), q + 4 * v);
      unpack(__ldcs(gd + v), d + 4 * v);
      unpack(__ldcs(gy + v), y + 4 * v);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const bool in = e0 + c < n;
      q[c] = in ? __ldcs(parts.pid[p] + e0 + c) : kFull;
      d[c] = in ? __ldcs(parts.dep[p] + e0 + c) : 0u;
      y[c] = in ? __ldcs(parts.pay[p] + e0 + c) : 0u;
    }
  }
}

// A 32 x kW transpose in registers (R = 32 / kW rows an instruction):
// before it, v[j] of lane s is row R j + s / kW, column s % kW of a pass;
// after it, v[k] of lane l is row l, column (l / R + k) % kW.  Round k
// reads lane kW (l % R) + (l / R + k) % kW, which holds row l in
// register l / R; each lane first rotates its registers so that round k
// sends v[(s % kW - k) % kW] from a fixed slot (a reversal, then a barrel
// rotation by s % kW in log2(kW) select stages).
template <int kW>
__device__ __forceinline__ void transpose_pass(uint32_t (&v)[kW], int lane) {
  static_assert(kW == 8 || kW == 16, "a pass of 8 or 16 columns");
  constexpr int kR = 32 / kW;
  uint32_t a[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) a[k] = v[(kW - k) & (kW - 1)];
  const int m = lane & (kW - 1);
#pragma unroll
  for (int b = 0; (1 << b) < kW; ++b) {
    const bool on = (m >> b) & 1;
    uint32_t r[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) r[k] = on ? a[(k - (1 << b)) & (kW - 1)] : a[k];
#pragma unroll
    for (int k = 0; k < kW; ++k) a[k] = r[k];
  }
  const int src = kW * (lane % kR);
  const int j = lane / kR;
#pragma unroll
  for (int k = 0; k < kW; ++k) v[k] = __shfl_sync(kFull, a[k], src + ((j + k) & (kW - 1)));
}

// kShflLoad, kShflLoad8: columns c0 .. c0 + kW - 1 of chain tile t by
// coalesced evict-first loads (lane l: row R j + l / kW, column l % kW,
// for j < kW; at kW = 16 the shipped loads), transposed so that lane l
// holds row l.  Entries past n read kFull, 0, 0.
template <int kW>
__device__ __forceinline__ void load_shfl_pass(const Parts& parts, int t, int lane, int c0,
                                               uint32_t (&q)[kW], uint32_t (&d)[kW],
                                               uint32_t (&y)[kW]) {
  constexpr int kR = 32 / kW;
  int p;
  const long long base = row_entry(parts, t, 0, c0 + (lane & (kW - 1)), p);
  const long long n = parts.n[p];
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const long long e = base + static_cast<long long>(kR * j + lane / kW) * kRow;
    const bool in = e < n;
    q[j] = in ? __ldcs(parts.pid[p] + e) : kFull;
    d[j] = in ? __ldcs(parts.dep[p] + e) : 0u;
    y[j] = in ? __ldcs(parts.pay[p] + e) : 0u;
  }
  transpose_pass<kW>(q, lane);
  transpose_pass<kW>(d, lane);
  transpose_pass<kW>(y, lane);
}

// kPosition, chain: stage band t / 64 of the launch's rows laid end to end
// (part p's chain_rows(n) rows after the parts' before it), columns 16 (t
// % 64) .. + 15, as load_tile stages a tile.  Each lane walks forward from
// part 0 to its rows' parts; entries past a part's end read kFull, 0, 0.
__device__ __forceinline__ void load_position_tile(const Parts& parts, int t, int lane,
                                                   uint32_t* sp, uint32_t* sd, uint32_t* sy) {
  constexpr int kBlocks = kRow / tiles::kCols;
  const long long band = static_cast<long long>(t / kBlocks) * 32;
  const int col = (t % kBlocks) * tiles::kCols + (lane & (tiles::kCols - 1));
  int p = 0;
  long long row0 = 0, row1 = chain_rows(parts.n[0]);
#pragma unroll 8
  for (int r2 = 0; r2 < 16; ++r2) {  // two tile rows a step, as load_tile
    const int r = 2 * r2 + (lane >> 4);
    const long long g = band + r;
    while (g >= row1 && p + 1 < parts.count) {
      ++p;
      row0 = row1;
      row1 += chain_rows(parts.n[p]);
    }
    const long long e = (g - row0) * kRow + col;
    const bool in = g < row1 && e < parts.n[p];
    const int at = r * tiles::kPitch + (lane & (tiles::kCols - 1));
    sp[at] = in ? __ldcs(parts.pid[p] + e) : kFull;
    sd[at] = in ? __ldcs(parts.dep[p] + e) : 0u;
    sy[at] = in ? __ldcs(parts.pay[p] + e) : 0u;
  }
  __syncwarp();
}

// kPosition, flat: columns c0 .. c0 + kPass - 1 of the 512-entry run t of
// the launch's entries laid end to end; lane l, column c holds entry
// 512 t + 32 (c0 + c) + l, which walks forward to its own part.
template <int kPass>
__device__ __forceinline__ void load_position_flat(const Parts& parts, int t, int lane, int c0,
                                                   uint32_t (&q)[kPass], uint32_t (&d)[kPass],
                                                   uint32_t (&y)[kPass]) {
  const long long g0 = static_cast<long long>(t) * tiles::kFlatTile + 32 * c0 + lane;
  int p = 0;
  long long e0 = 0, e1 = parts.n[0];
#pragma unroll
  for (int c = 0; c < kPass; ++c) {
    const long long g = g0 + 32 * c;
    while (g >= e1 && p + 1 < parts.count) {
      ++p;
      e0 = e1;
      e1 += parts.n[p];
    }
    const bool in = g < e1;
    q[c] = in ? __ldcs(parts.pid[p] + (g - e0)) : kFull;
    d[c] = in ? __ldcs(parts.dep[p] + (g - e0)) : 0u;
    y[c] = in ? __ldcs(parts.pay[p] + (g - e0)) : 0u;
  }
}

template <bool kL1, typename T>
__device__ __forceinline__ T plane_load(const T* at) {
  return kL1 ? __ldca(at) : __ldcg(at);
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
  } else if constexpr (kCombined<kLesion>) {
    // every lane reaches every match and reduce (dead entries with their
    // pids, which no live pid equals); only the atomic is predicated
    const int lane = threadIdx.x & 31;
    unsigned long long old[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      old[c] = q < size ? plane_load<kL1>(plane + q) : 0ull;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      const unsigned long long k = key(c);
      const uint32_t kd = static_cast<uint32_t>(k >> 32);
      const unsigned peers = __match_any_sync(kFull, q);
      const uint32_t dm = __reduce_min_sync(peers, kd);
      const uint32_t ym = __reduce_min_sync(peers, kd == dm ? static_cast<uint32_t>(k) : kFull);
      const unsigned long long km = (static_cast<unsigned long long>(dm) << 32) | ym;
      if (__ffs(peers) - 1 == lane && km < old[c]) {
        if constexpr (kLesion == kCombineWouldBe) {
          ++fold;
        } else {
          atomicMin(plane + q, km);
          if constexpr (kLesion == kCombineCount) ++fold;
        }
      }
    }
  } else if constexpr (kLesion == kDepthPass) {
    uint32_t* dp = reinterpret_cast<uint32_t*>(plane);
    uint32_t old[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      old[c] = q < size ? plane_load<kL1>(dp + q) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t kd = static_cast<uint32_t>(key(c) >> 32);
      if (kd < old[c]) atomicMin(dp + pid(c), kd);
    }
  } else if constexpr (kLesion == kPayPass) {
    const uint32_t* dp = reinterpret_cast<const uint32_t*>(plane);
    uint32_t* yp = reinterpret_cast<uint32_t*>(plane) + size;
    uint32_t won[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      won[c] = q < size ? plane_load<kL1>(dp + q) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      const unsigned long long k = key(c);
      if (q < size && static_cast<uint32_t>(k >> 32) == won[c])
        atomicMin(yp + q, static_cast<uint32_t>(k));
    }
  } else if constexpr (kLesion == kHalfGather) {
    // the depth half of word q is u32 word 2q + 1 (little-endian)
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(plane) + 1;
    uint32_t old[kW];
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      old[c] = q < size ? plane_load<kL1>(hi + 2 * static_cast<size_t>(q)) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kW; ++c) {
      const uint32_t q = pid(c);
      const unsigned long long k = key(c);
      if (q < size && static_cast<uint32_t>(k >> 32) <= old[c]) atomicMin(plane + q, k);
    }
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

// B3 in kLayout with lesion kLesion, its tiles read as kForm says; kWidth
// is the chain tile's columns (shipped: 16) or the flat tile's columns a
// pass (shipped: 8).  Parts carry tile0 for that width and form
// (`make_parts`).
template <int kLayout, int kLesion, int kWidth, int kForm = kStaged>
__global__ void __launch_bounds__(kWarps * 32, 4)
b3_probe(const __grid_constant__ Parts parts, unsigned long long* __restrict__ plane,
         uint32_t size, unsigned int* __restrict__ sums) {
  static_assert(kForm == kStaged || (kForm == kPosition && kLesion != kNoop &&
                                     kWidth == (kLayout == tiles::kFlat ? tiles::kFlatCols
                                                                        : tiles::kCols)) ||
                    (kLayout == tiles::kChain && kWidth == tiles::kCols && kLesion != kNoop),
                "a form other than the shipped loads takes the shipped width");
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
      if constexpr (kForm == kPosition) load_position_flat<kWidth>(parts, t, lane, c0, q, d, y);
      else load_flat<kWidth, kMade>(parts, t, lane, c0, size, q, d, y);
      resolve<kLesion, true, kWidth>(
          [&](int c) { return q[c]; },
          [&](int c) { return (static_cast<unsigned long long>(d[c]) << 32) | y[c]; },
          plane, size, fold);
    }
  } else if constexpr (kPassCols<kForm> > 0) {
    // the tile in registers, lane l row l, kW columns a pass
    constexpr int kW = kPassCols<kForm>;
#pragma unroll 1
    for (int c0 = 0; c0 < tiles::kCols; c0 += kW) {
      uint32_t q[kW], d[kW], y[kW];
      if constexpr (kForm == kRowLoad || kForm == kRowLoad8)
        load_row_pass<kW>(parts, t, lane, c0, q, d, y);
      else
        load_shfl_pass<kW>(parts, t, lane, c0, q, d, y);
      resolve<kLesion, false, kW>(
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
    if constexpr (kForm == kPosition) load_position_tile(parts, t, lane, sp, sd, sy);
    else load_tile<kWidth, kMade>(parts, t, lane, size, sp, sd, sy);
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

// Tiles of kForm kPosition over `count` parts of n entries laid end to
// end: 32-row bands x 16-column blocks of their rows (chain), or runs of
// 512 of their entries (flat).
template <int kLayout>
inline long long position_tiles(const long long* n, int count) {
  long long total = 0;
  for (int p = 0; p < count; ++p) total += kLayout == tiles::kChain ? chain_rows(n[p]) : n[p];
  return kLayout == tiles::kChain ? (total + 31) / 32 * (kRow / tiles::kCols)
                                  : (total + tiles::kFlatTile - 1) / tiles::kFlatTile;
}

// The Parts of `count` parts for kLayout at kWidth: the shipped ones,
// with the chain tiles recounted at kWidth columns; for kPosition,
// tile0[count] is the launch's position tiles (the rest, per part, is
// not read); false if out of range.
template <int kLayout, int kWidth, int kForm = kStaged>
inline bool make_parts(Parts& parts, const void* const* pid, const void* const* dep,
                       const void* const* pay, const long long* n, int count) {
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, kLayout)) return false;
  if constexpr (kLayout == tiles::kChain)
    for (int p = 0; p < count; ++p)
      parts.tile0[p + 1] = parts.tile0[p] + chain_tiles<kWidth>(n[p]);
  if constexpr (kForm == kPosition) {
    const long long tiles = position_tiles<kLayout>(n, count);
    if (tiles > 0x7fffffff) return false;
    parts.tile0[count] = static_cast<int>(tiles);
  }
  return true;
}

// One launch of b3_probe<kLayout, kLesion, kWidth, kForm> over `count`
// (<= 64) parts; sums is kSlots x kSlotPitch words, zeroed by the caller.
template <int kLayout, int kLesion, int kWidth, int kForm = kStaged>
int launch_b3(const void* const* pid, const void* const* dep, const void* const* pay,
              const long long* n, int count, void* plane, int size, void* sums,
              void* stream) {
  Parts parts;
  if (!make_parts<kLayout, kWidth, kForm>(parts, pid, dep, pay, n, count))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = kLayout == tiles::kChain && kLesion != kNoop &&
                      (kForm == kStaged || kForm == kPosition);
  const int smem = staged ? kWarps * 3 * 32 * (kWidth + 1) * 4 : 0;
  auto kernel = b3_probe<kLayout, kLesion, kWidth, kForm>;
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

// One instance of b3_probe as a case of a probe module's C entry point
// that also takes a form: `int symbol(int layout, int lesion, int width,
// int form, ...)`, the rest as PCR_B3_CASE's.
#define PCR_B3_FORM(L, K, W, F)                                                     \
  if (layout == (L) && lesion == (K) && width == (W) && form == (F))                \
  return probes::launch_b3<L, K, W, F>(pid, dep, pay, n, count, plane, size, sums, stream)

// ---- B6's variants (`csrc/merge.cuh`'s merge_nk1), for the B6 probes ----

namespace b6 {

// A variant as its own kernel, with the checksum words and, for a ring,
// its shared memory.
template <int kLesion, int kSteps, int kGroups, int kStages, int kLoad, int kCut, int kHead>
__global__ void merge_nk1_probe(const uint32_t* __restrict__ pid,
                                const uint32_t* __restrict__ dep,
                                const uint32_t* __restrict__ pay,
                                unsigned long long* __restrict__ plane, long long n,
                                uint32_t size, unsigned int* __restrict__ sums) {
  merge_nk1<kLesion, kSteps, kGroups, kStages, kLoad, kCut, kHead>(pid, dep, pay, plane, n,
                                                                   size, sums);
}

// One launch of a variant over n entries (for kInterleaved, pid is the
// (n, 4) array and dep, pay are not read); sums is kSlots x kSlotPitch
// words, zeroed by the caller.  A ring's grid is what the card holds at
// once: its warps walk the tiles.
template <int kLesion, int kSteps, int kGroups, int kStages, int kLoad, int kCut, int kHead>
int launch_probe(const void* pid, const void* dep, const void* pay, void* plane, long long n,
                 int size, void* sums, void* stream) {
  auto kernel = merge_nk1_probe<kLesion, kSteps, kGroups, kStages, kLoad, kCut, kHead>;
  const long long per_block = static_cast<long long>(kThreads) * kGroups;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks == 0) return 0;
  const int smem = kStages * 3 * kGroups * kThreads * 4;
  if constexpr (kStages > 0) {
    static bool attr_set = false;
    if (!attr_set && smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay), static_cast<unsigned long long*>(plane), n,
      static_cast<uint32_t>(size), static_cast<unsigned int*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b6

// One variant as a case of a B6 probe's C entry point, whose arguments
// are (lesion, steps, groups, stages, load, cut, head, then
// pcr_merge_nk1's, then the checksum words): `int symbol(int lesion, int
// steps, int groups, int stages, int load, int cut, int head, const void*
// pid, const void* dep, const void* pay, void* plane, long long n, int
// size, void* sums, void* stream)`.
#define PCR_B6_CASE(K, S, G, ST, LD, C, H)                                                  \
  if (lesion == (K) && steps == (S) && groups == (G) && stages == (ST) && load == (LD) &&  \
      cut == (C) && head == (H))                                                            \
  return b6::launch_probe<K, S, G, ST, LD, C, H>(pid, dep, pay, plane, n, size, sums, stream)
