// A frame's stream parts, passed to one launch by value, and the two
// tile loads that B3 (raster.cu) and B4 (hqs.cu) share, one per layout
// of a part.  A part is one (pid, dep, pay) stream of n u32 entries.
//
// kChain (the `.tpc` and `.huffman` streams): the part is rows of kRow
// entries (a row is one point index of one batch, its 8 x 128 chains).
// A tile is 32 rows x kCols columns: 32 consecutive points of kCols
// chains.  One warp loads a tile with evict-first loads (the stream is
// read once; the planes the kernels scatter into keep the L2), stages it
// in shared memory and reads it back transposed, so lane l holds point l
// of the band in each of the tile's chains: Morton-adjacent points,
// which mostly share a pixel.
//
// kFlat (the `.las` and Potree parts): one entry a point, in file or
// node order, so the transpose would give a lane entries 1024 apart,
// which share nothing.  A tile is 32 x kCols consecutive entries, loaded
// straight into registers: lane l, column c holds entry 32c + l, one
// coalesced 128-byte evict-first load a column and stream, and no shared
// memory (the kernels' 64 registers a thread still cap an SM at 4 blocks,
// as the chain tiles' 52 KB do).  A lane holds kFlatCols columns at once
// (two passes a tile), to stay within those 64 registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxParts = 64;     // parts per launch (kernel parameters)
constexpr int kRow = 1024;        // entries per stream row (8 groups x 128)
constexpr int kCols = 16;         // tile: 32 rows x 16 columns
constexpr int kPitch = kCols + 1; // tile row pitch: conflict-free columns
constexpr int kTileWords = 32 * kPitch;
constexpr int kFlatTile = 32 * kCols;  // entries of a flat tile
constexpr int kFlatCols = 8;           // columns of a flat tile a pass
enum Layout { kChain = 0, kFlat = 1 };

struct Parts {
  const uint32_t* pid[kMaxParts];
  const uint32_t* dep[kMaxParts];
  const uint32_t* pay[kMaxParts];
  long long n[kMaxParts];
  int tile0[kMaxParts + 1];  // first tile of each part; tile0[count] = all
  int count;
};

// kChain: 32-row bands x 16-column blocks of a part's rows of kRow
// entries; kFlat: runs of kFlatTile entries
__host__ __device__ inline int part_tiles(long long n, int layout) {
  if (layout == kFlat) return static_cast<int>((n + kFlatTile - 1) / kFlatTile);
  const long long rows = (n + kRow - 1) / kRow;
  return static_cast<int>((rows + 31) / 32) * (kRow / kCols);
}

// The Parts of `count` (1..kMaxParts) streams in `layout` whose device
// pointers and entry counts are in the host arrays; false if count or
// layout is out of range.
inline bool make_parts(Parts& parts, const void* const* pid, const void* const* dep,
                       const void* const* pay, const long long* n, int count,
                       int layout) {
  if (count < 1 || count > kMaxParts || (layout != kChain && layout != kFlat)) return false;
  parts.count = count;
  parts.tile0[0] = 0;
  for (int p = 0; p < count; ++p) {
    parts.pid[p] = static_cast<const uint32_t*>(pid[p]);
    parts.dep[p] = static_cast<const uint32_t*>(dep[p]);
    parts.pay[p] = static_cast<const uint32_t*>(pay[p]);
    parts.n[p] = n[p];
    parts.tile0[p + 1] = parts.tile0[p] + part_tiles(n[p], layout);
  }
  return true;
}

// The part of tile t (< parts.tile0[parts.count]) and t's index in it.
__device__ __forceinline__ int part_of(const Parts& parts, int t, int& local) {
  int p = 0;
  while (t >= parts.tile0[p + 1]) ++p;
  local = t - parts.tile0[p];
  return p;
}

// Stage chain tile t (< parts.tile0[parts.count]) of its part in sp/sd/sy
// (kTileWords each), row r of the tile at r * kPitch, so that lane l then
// reads row l.  Entries past the part's end read pid kFull (>= any size:
// dead), dep 0 and pay 0.
__device__ __forceinline__ void load_tile(const Parts& parts, int t, int lane,
                                          uint32_t* sp, uint32_t* sd, uint32_t* sy) {
  int local;
  const int p = part_of(parts, t, local);
  const long long n = parts.n[p];
  const long long base = static_cast<long long>(local / (kRow / kCols)) * 32 * kRow +
                         (local % (kRow / kCols)) * kCols + (lane & (kCols - 1));
  const uint32_t* gp = parts.pid[p];
  const uint32_t* gd = parts.dep[p];
  const uint32_t* gy = parts.pay[p];
#pragma unroll 8
  for (int r2 = 0; r2 < 16; ++r2) {  // two tile rows a step, 64 B each
    const int r = 2 * r2 + (lane >> 4);
    const long long e = base + static_cast<long long>(r) * kRow;
    const bool in = e < n;
    const int at = r * kPitch + (lane & (kCols - 1));
    sp[at] = in ? __ldcs(gp + e) : kFull;
    sd[at] = in ? __ldcs(gd + e) : 0u;
    sy[at] = in ? __ldcs(gy + e) : 0u;
  }
  __syncwarp();
}

// Load columns c0 .. c0 + kFlatCols - 1 of flat tile t (< parts.tile0[
// parts.count]) into registers: q[c], d[c], y[c] of lane l are entry
// 32 (c0 + c) + l of the tile.  Entries past the part's end read pid
// kFull (dead), dep 0 and pay 0, as in load_tile.
__device__ __forceinline__ void load_flat(const Parts& parts, int t, int lane, int c0,
                                          uint32_t (&q)[kFlatCols], uint32_t (&d)[kFlatCols],
                                          uint32_t (&y)[kFlatCols]) {
  int local;
  const int p = part_of(parts, t, local);
  const long long n = parts.n[p];
  const long long base = static_cast<long long>(local) * kFlatTile + 32 * c0 + lane;
  const uint32_t* gp = parts.pid[p];
  const uint32_t* gd = parts.dep[p];
  const uint32_t* gy = parts.pay[p];
#pragma unroll
  for (int c = 0; c < kFlatCols; ++c) {
    const long long e = base + 32 * c;
    const bool in = e < n;
    q[c] = in ? __ldcs(gp + e) : kFull;
    d[c] = in ? __ldcs(gd + e) : 0u;
    y[c] = in ? __ldcs(gy + e) : 0u;
  }
}

}  // namespace tiles
