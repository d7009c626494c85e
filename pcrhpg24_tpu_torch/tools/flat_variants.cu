// Variants of the flat-layout B3 (csrc/raster.cu) and B4 (csrc/hqs.cu)
// kernels, each differing from the kernel the package ships in one
// choice, for tools/flat_variants.py to time on the same parts.  Variant
// 0 of each is the shipped design, rebuilt here so that all are compiled
// alike.  Every variant computes the same planes: a minimum or a sum mod
// 2**32 does not depend on the order of its atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using tiles::kCols;
using tiles::kFlatTile;
using tiles::kFull;
using tiles::Parts;

constexpr int kWarps = 8;

// tiles::load_flat with kPass columns a pass (8 or 16)
template <int kPass>
__device__ __forceinline__ void load_cols(const Parts& parts, int t, int lane, int c0,
                                          uint32_t (&q)[kPass], uint32_t (&d)[kPass],
                                          uint32_t (&y)[kPass]) {
  int local;
  const int p = tiles::part_of(parts, t, local);
  const long long n = parts.n[p];
  const long long base = static_cast<long long>(local) * kFlatTile + 32 * c0 + lane;
#pragma unroll
  for (int c = 0; c < kPass; ++c) {
    const long long e = base + 32 * c;
    const bool in = e < n;
    q[c] = in ? __ldcs(parts.pid[p] + e) : kFull;
    d[c] = in ? __ldcs(parts.dep[p] + e) : 0u;
    y[c] = in ? __ldcs(parts.pay[p] + e) : 0u;
  }
}

// B3: kPass columns a pass, plane words through L1 (__ldca) or L2 only
// (__ldcg), and optionally a drop of a key that the next lane (the next
// entry) beats on the same pixel.
template <int kPass, bool kL1, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32, 4)
b3_variant(const __grid_constant__ Parts parts, unsigned long long* __restrict__ plane,
           uint32_t size) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= parts.tile0[parts.count]) return;
#pragma unroll 1
  for (int c0 = 0; c0 < kCols; c0 += kPass) {
    uint32_t q[kPass], d[kPass], y[kPass];
    load_cols<kPass>(parts, t, lane, c0, q, d, y);
    unsigned long long old[kPass];
#pragma unroll
    for (int c = 0; c < kPass; ++c)
      old[c] = q[c] < size ? (kL1 ? __ldca(plane + q[c]) : __ldcg(plane + q[c])) : 0ull;
#pragma unroll
    for (int c = 0; c < kPass; ++c) {
      const unsigned long long key = (static_cast<unsigned long long>(d[c]) << 32) | y[c];
      bool beaten = false;
      if constexpr (kDrop) {
        const uint32_t qn = __shfl_down_sync(kFull, q[c], 1);
        const unsigned long long kn = __shfl_down_sync(kFull, key, 1);
        beaten = lane < 31 && qn == q[c] && kn < key;
      }
      if (!beaten && key < old[c]) atomicMin(plane + q[c], key);
    }
  }
}

enum B4Mode { kQuad = 0, kPerLane = 1, kMatch = 2 };

// B4: an accepted entry's four sums by a quad of lanes (the shipped
// design), by its own lane (four atomics a lane), or combined first over
// the lanes of one pixel (`__match_any_sync` groups, as the chain layout).
template <int kMode>
__global__ void __launch_bounds__(kWarps * 32, 4)
b4_variant(const __grid_constant__ Parts parts, const uint32_t* __restrict__ fb_depth,
           unsigned int* __restrict__ acc, uint32_t size) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= parts.tile0[parts.count]) return;
  const int f = lane & 3;
#pragma unroll 1
  for (int c0 = 0; c0 < kCols; c0 += tiles::kFlatCols) {
    uint32_t q[tiles::kFlatCols], d[tiles::kFlatCols], y[tiles::kFlatCols];
    uint32_t old[tiles::kFlatCols];
    load_cols<tiles::kFlatCols>(parts, t, lane, c0, q, d, y);
#pragma unroll
    for (int c = 0; c < tiles::kFlatCols; ++c)
      old[c] = q[c] < size ? __ldg(fb_depth + q[c]) : 0u;
#pragma unroll
    for (int c = 0; c < tiles::kFlatCols; ++c) {
      const bool ok =
          q[c] < size && __uint_as_float(d[c]) <= __fmul_rn(__uint_as_float(old[c]), 1.01f);
      if constexpr (kMode == kQuad) {
        const unsigned live = __ballot_sync(kFull, ok);
        const uint32_t qa = ok ? q[c] : kFull;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (((live >> (8 * j)) & 255u) == 0u) continue;
          const int src = 8 * j + (lane >> 2);
          const uint32_t qs = __shfl_sync(kFull, qa, src);
          const uint32_t ys = __shfl_sync(kFull, y[c], src);
          if (qs != kFull) atomicAdd(acc + 4ull * qs + f, f == 3 ? 1u : (ys >> (8 * f)) & 255u);
        }
      } else if constexpr (kMode == kPerLane) {
        if (ok) {
          unsigned int* a = acc + 4ull * q[c];
          atomicAdd(a + 0, y[c] & 255u);
          atomicAdd(a + 1, (y[c] >> 8) & 255u);
          atomicAdd(a + 2, (y[c] >> 16) & 255u);
          atomicAdd(a + 3, 1u);
        }
      } else {
        const unsigned grp = __match_any_sync(kFull, q[c]);
        const uint32_t rg =
            __reduce_add_sync(grp, ok ? (y[c] & 255u) | (((y[c] >> 8) & 255u) << 16) : 0u);
        const uint32_t bn = __reduce_add_sync(grp, ok ? ((y[c] >> 16) & 255u) | (1u << 16) : 0u);
        if (lane == __ffs(grp) - 1 && bn != 0u) {
          unsigned int* a = acc + 4ull * q[c];
          atomicAdd(a + 0, rg & 0xffffu);
          atomicAdd(a + 1, rg >> 16);
          atomicAdd(a + 2, bn & 0xffffu);
          atomicAdd(a + 3, bn >> 16);
        }
      }
    }
  }
}

template <typename K, typename... A>
int launch(K kernel, const Parts& parts, void* stream, A... args) {
  const int blocks = (parts.tile0[parts.count] + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(parts, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3 variant v over `count` (<= 64) flat parts: 0 shipped (2 passes of 8
// columns, L1 gathers), 1 L2 gathers, 2 one pass of 16 columns, 3 the
// drop of keys the next lane beats.
extern "C" int pcr_probe_b3(int v, const void* const* pid, const void* const* dep,
                            const void* const* pay, const long long* n, int count,
                            void* plane, int size, void* stream) {
  Parts parts;
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, tiles::kFlat))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* pl = static_cast<unsigned long long*>(plane);
  const auto s = static_cast<uint32_t>(size);
  switch (v) {
    case 0: return launch(b3_variant<8, true, false>, parts, stream, pl, s);
    case 1: return launch(b3_variant<8, false, false>, parts, stream, pl, s);
    case 2: return launch(b3_variant<16, true, false>, parts, stream, pl, s);
    case 3: return launch(b3_variant<8, true, true>, parts, stream, pl, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B4 variant v (a B4Mode) over `count` (<= 64) flat parts.
extern "C" int pcr_probe_b4(int v, const void* const* pid, const void* const* dep,
                            const void* const* pay, const long long* n, int count,
                            const void* fb_depth, void* acc, int size, void* stream) {
  Parts parts;
  if (!tiles::make_parts(parts, pid, dep, pay, n, count, tiles::kFlat))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fb = static_cast<const uint32_t*>(fb_depth);
  auto* a = static_cast<unsigned int*>(acc);
  const auto s = static_cast<uint32_t>(size);
  switch (v) {
    case kQuad: return launch(b4_variant<kQuad>, parts, stream, fb, a, s);
    case kPerLane: return launch(b4_variant<kPerLane>, parts, stream, fb, a, s);
    case kMatch: return launch(b4_variant<kMatch>, parts, stream, fb, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
