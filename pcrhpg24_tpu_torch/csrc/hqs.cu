// B4 and B9: HQS tolerance-gated (r, g, b, 1) sums for Hopper (sm_90a).
//
// B4 replaces the Pallas TPU kernel `_hqs_matscatter_kernel`
// (pcrhpg24_tpu/render/pallas_hqs.py:185, reached through
// `hqs_sums_from_rows` :316 -> `_hqs_rows_group` :360, pallas_call at
// :393).  The TPU has no atomics, so the reference sorts each chunk's
// stream by pid and scatters the accepted entries into the four planes
// with one-hot bf16 matmuls fed by a DMA ring.  Integer sums do not
// depend on order, so here the UNSORTED stream is summed with atomics and
// the planes come out the same (the source paper's
// huffman_hqs/render.cu:274-316 sums with 64-bit atomics).
//
// Per entry: q = pid; accept = q < size && w <= old * 1.01f, with
// w = f32(dep bits) and old = f32(fb_depth[q] bits), the multiply
// rounded on its own (__fmul_rn; the library is built with
// -fmad=false).  An EMPTY depth (all ones) is a NaN and accepts nothing.
// Sums wrap mod 2**32 like the reference's u32 planes.
//
// Bound on the H100: device-memory bytes, the stream's 12 B per entry
// read once (the depth plane and the sums stay in the 50 MB L2 at 1080p).
// What held the first design back (one thread per entry, four atomics
// into four separate (4, size) planes) was the atomics: one entry's four
// landed on four cache lines, and a warp's 32 lanes never combined.  This
// design:
//  * one interleaved (size, 4) accumulator, so an entry's (r, g, b, n)
//    atomics fall in one 16-byte sector.  The wrapper hands the consumer
//    the four planes as strided views of it (no split pass): the
//    consumer's unswizzle copies each plane once anyway, and
//    `chip_smoke.py` times views against a contiguous split;
//  * combining before the atomic.  A warp takes a 32-row x 16-column
//    tile of the stream seen as rows of 1024 entries (a row is one point
//    index of one batch, its 8 x 128 chains), stages it in shared memory
//    and reads it back transposed, so its 32 lanes hold 32 consecutive
//    points of one chain: Morton-adjacent points, which mostly share a
//    pixel.  Each lane first gathers fb_depth for all 16 of its entries
//    (16 loads in flight), then per column `__match_any_sync` groups the
//    lanes of equal pid, each lane tests its own entry, and two
//    `__reduce_add_sync`s sum the group's (r | g << 16) and
//    (b | 1 << 16) (at most 32 x 255 per field: no carry).  One lane per
//    (warp, pixel) does the four atomics.  52 KB of tiles a block leave
//    room for 32 warps an SM;
//  * one launch for all of a frame's parts: their pointers travel by
//    value in the kernel's parameters (up to 64 parts a launch), with no
//    host-to-device copy.  The stream is read with evict-first loads so
//    the depth plane and the sums keep the L2.
// All of the above is the chain layout (`tiles::kChain`), the `.tpc` and
// `.huffman` streams.  The `.las` and Potree parts are flat (one entry a
// point, in file or node order: `tiles::kFlat`, a template value of the
// kernel).  There the transpose gives a lane entries 1024 apart, and even
// 32 consecutive entries seldom share a pixel (`chip_smoke.py`'s atomic
// groups: about one group per accepted entry on both), so each match
// group is one lane and pays for the match, two reductions and four
// atomics, each of the four a warp instruction whose 32 lanes hit 32
// rows.  The flat design:
//  * a warp takes 512 consecutive entries straight into registers
//    (`tiles::load_flat`, 8 columns a pass, no shared memory) and
//    gathers each pass's depth-plane words first;
//  * no match: per column, lanes 4k..4k+3 add the (r, g, b, n) of the
//    column's entry 8j + k, in four rounds j (a round none of whose
//    eight entries is accepted is skipped).  One instruction's atomics
//    then fall on 8 rows of 16 bytes, 4 lanes a row, and the memory
//    system takes a row's four as one request, as it does for
//    `index_add_` of (size, 4) rows: a quarter of the requests of four
//    atomics a lane.
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
// (r, g, b, n) in its first lane, which does the four atomicAdds into
// (4, size) planes: four atomics per (warp, pixel) instead of per
// accepted entry.  Bound: as B4, the stream's 12 B per entry read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kFull;
using tiles::kPitch;
using tiles::kTileWords;
using tiles::Parts;
constexpr int kWarps = 8;         // B4 warps per block, one tile each
constexpr int kSmemBytes = kWarps * 3 * kTileWords * 4;  // 52,224 B

template <int kLayout>
__global__ void __launch_bounds__(kWarps * 32, 4)
hqs_sums_kernel(const __grid_constant__ Parts parts,
                const uint32_t* __restrict__ fb_depth,
                unsigned int* __restrict__ acc,  // (size, 4): r, g, b, n
                uint32_t size) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= parts.tile0[parts.count]) return;  // the whole warp; no barrier
  if constexpr (kLayout == tiles::kFlat) {
    // lane l holds entries l, 32 + l, ... of the tile's 512, kFlatCols at
    // a time
    const int f = lane & 3;  // the field this lane adds: r, g, b or n
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += tiles::kFlatCols) {
      uint32_t q[tiles::kFlatCols], d[tiles::kFlatCols], y[tiles::kFlatCols];
      uint32_t old[tiles::kFlatCols];
      tiles::load_flat(parts, t, lane, c0, q, d, y);
#pragma unroll
      for (int c = 0; c < tiles::kFlatCols; ++c)
        old[c] = q[c] < size ? __ldg(fb_depth + q[c]) : 0u;
#pragma unroll
      for (int c = 0; c < tiles::kFlatCols; ++c) {
        const bool ok =
            q[c] < size && __uint_as_float(d[c]) <= __fmul_rn(__uint_as_float(old[c]), 1.01f);
        const unsigned live = __ballot_sync(kFull, ok);
        const uint32_t qa = ok ? q[c] : kFull;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // lanes 4k..4k+3: entry 8j + k's four fields
          if (((live >> (8 * j)) & 255u) == 0u) continue;  // the whole warp
          const int src = 8 * j + (lane >> 2);
          const uint32_t qs = __shfl_sync(kFull, qa, src);
          const uint32_t ys = __shfl_sync(kFull, y[c], src);
          if (qs != kFull) atomicAdd(acc + 4ull * qs + f, f == 3 ? 1u : (ys >> (8 * f)) & 255u);
        }
      }
    }
  } else {
    extern __shared__ uint32_t tile[];
    uint32_t* sp = tile + warp * 3 * kTileWords;
    uint32_t* sd = sp + kTileWords;
    uint32_t* sy = sd + kTileWords;
    tiles::load_tile(parts, t, lane, sp, sd, sy);
    // lane l holds point l of the band in each of the tile's 16 chains
    uint32_t q[kCols], old[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      q[c] = sp[lane * kPitch + c];
      old[c] = q[c] < size ? __ldg(fb_depth + q[c]) : 0u;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const unsigned grp = __match_any_sync(kFull, q[c]);
      const float w = __uint_as_float(sd[lane * kPitch + c]);
      const bool ok = q[c] < size && w <= __fmul_rn(__uint_as_float(old[c]), 1.01f);
      const uint32_t y = sy[lane * kPitch + c];
      const uint32_t rg = __reduce_add_sync(grp, ok ? (y & 255u) | (((y >> 8) & 255u) << 16) : 0u);
      const uint32_t bn = __reduce_add_sync(grp, ok ? ((y >> 16) & 255u) | (1u << 16) : 0u);
      if (lane == __ffs(grp) - 1 && bn != 0u) {  // bn != 0: a live, accepted group
        unsigned int* a = acc + 4ull * q[c];
        atomicAdd(a + 0, rg & 0xffffu);
        atomicAdd(a + 1, rg >> 16);
        atomicAdd(a + 2, bn & 0xffffu);
        atomicAdd(a + 3, bn >> 16);
      }
    }
  }
}

// One launch of B4 in kLayout over `count` (<= 64) parts.
template <int kLayout>
int launch_hqs_sums(const void* const* pid, const void* const* dep, const void* const* pay,
                    const long long* n, int count, const void* fb_depth, void* acc,
                    int size, void* stream) {
  Parts parts;
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, kLayout))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kLayout == tiles::kFlat ? 0 : kSmemBytes;
  static bool attr_set = false;
  if (!attr_set && smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        hqs_sums_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int blocks = (parts.tile0[count] + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  hqs_sums_kernel<kLayout><<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      parts, static_cast<const uint32_t*>(fb_depth), static_cast<unsigned int*>(acc),
      static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}

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

// B4 over `count` (<= 64) parts: pid/dep/pay are host arrays of the parts'
// device pointers, n of their entry counts; acc is the (size, 4) sums.
// pcr_hqs_sums takes chain-layout parts, pcr_hqs_sums_flat flat ones.
extern "C" int pcr_hqs_sums(const void* const* pid, const void* const* dep,
                            const void* const* pay, const long long* n,
                            int count, const void* fb_depth, void* acc,
                            int size, void* stream) {
  return launch_hqs_sums<tiles::kChain>(pid, dep, pay, n, count, fb_depth, acc, size,
                                        stream);
}

extern "C" int pcr_hqs_sums_flat(const void* const* pid, const void* const* dep,
                                 const void* const* pay, const long long* n,
                                 int count, const void* fb_depth, void* acc,
                                 int size, void* stream) {
  return launch_hqs_sums<tiles::kFlat>(pid, dep, pay, n, count, fb_depth, acc, size,
                                       stream);
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
