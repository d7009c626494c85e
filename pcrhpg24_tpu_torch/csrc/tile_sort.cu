// B10: independent 3-key sort of every 1024-entry tile, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sort_kernel`
// (pcrhpg24_tpu/render/pallas_raster.py:101, through `tile_sort3` :113,
// pallas_call at :121): each (8, 128) tile of three int32 key planes is
// sorted ascending by (k0, k1, k2), compared as SIGNED int32.  The TPU
// kernel runs a bitonic network whose partner exchanges are
// `pltpu.roll`s of whole (8, 128) vregs.  A sorted sequence of triples
// is unique, so any correct sort gives the reference's bits.
//
// Bound on the H100: device-memory bytes, 12 B per entry read once and
// written once (24 B an entry at 3.35 TB/s: 0.030 ms for 4,096 tiles).
// What costs is the compare-exchange work: a bitonic network is 55
// stages of 512 compare-exchanges a tile, each a 3-key compare and six
// selects.  Run in shared memory with a barrier before every stage it
// took 10x the bound; run in registers (one warp per tile, shuffles
// between lanes) it issues ~12k integer instructions a tile and is
// bound by the integer pipe at 4x the bound.  So this kernel does less
// work instead, the merge sort's n log n against the network's
// n log^2 n / 4:
//  - one warp per tile; lane l loads 32 entries (16 B a lane, coalesced:
//    a sort may read its input in any order) and sorts them in registers
//    with Batcher's odd-even merge sort (191 compare-exchanges);
//  - five merge levels through shared memory join runs of 32 into 1024:
//    lane l finds where the merge path of its pair of runs crosses the
//    diagonal of its 32 outputs (a binary search), then merges serially,
//    one compare and three selects an output, into its registers;
//  - one predicate per compare: the keys are biased to unsigned at load,
//    and a subtract-with-borrow chain over (k2, k1, k0) yields "a < b";
//  - each key plane of the warp lives in shared memory with one pad word
//    per 32, so a lane's run is written without bank conflicts; a run
//    that is used up reads a pad word holding the largest triple, so the
//    merge needs no bounds test (an entry equal to it is emitted as the
//    same value);
//  - the sorted tile leaves through the same rows as coalesced 16 B
//    stores.  Blocks of two warps, one tile each; no block barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kPerLane = 32;  // entries a lane holds
constexpr int kWarps = 2;     // tiles a block sorts
constexpr unsigned kBias = 0x80000000u;  // signed order -> unsigned order
constexpr int kRow = kPerLane + 1;       // a lane's run and one pad word
constexpr int kPlane = kTile / kPerLane * kRow;
constexpr int kSentinel = kPlane - 1;  // a pad word: holds the largest triple

struct Keys {
  unsigned a[kPerLane], b[kPerLane], c[kPerLane];
};

// All ones when (a0, a1, a2) < (b0, b1, b2) as unsigned triples, else 0:
// the borrow out of (a2 - b2), (a1 - b1 - borrow), (a0 - b0 - borrow).
__device__ __forceinline__ unsigned lt_mask(unsigned a0, unsigned a1, unsigned a2,
                                            unsigned b0, unsigned b1, unsigned b2) {
  unsigned m;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %4;\n\t"
      "subc.cc.u32 t, %2, %5;\n\t"
      "subc.cc.u32 t, %3, %6;\n\t"
      "subc.u32 %0, %7, %7;\n\t}"
      : "=r"(m)
      : "r"(a2), "r"(a1), "r"(a0), "r"(b2), "r"(b1), "r"(b0), "r"(0u));
  return m;
}

__device__ __forceinline__ unsigned pick(unsigned m, unsigned x, unsigned y) {
  return (x & m) | (y & ~m);
}

// Registers x < y of one thread: the smaller triple to x.
__device__ __forceinline__ void ce(Keys& v, int x, int y) {
  const unsigned m = lt_mask(v.a[y], v.b[y], v.c[y], v.a[x], v.b[x], v.c[x]);
  const unsigned a = v.a[x], b = v.b[x], c = v.c[x];
  v.a[x] = pick(m, v.a[y], a);
  v.b[x] = pick(m, v.b[y], b);
  v.c[x] = pick(m, v.c[y], c);
  v.a[y] = pick(m, a, v.a[y]);
  v.b[y] = pick(m, b, v.b[y]);
  v.c[y] = pick(m, c, v.c[y]);
}

// One stage (P, K) of Batcher's odd-even merge sort of the lane's 32
// registers: compare-exchanges at distance K inside merges of size 2P.
template <int P, int K>
__device__ __forceinline__ void oem_stage(Keys& v) {
#pragma unroll
  for (int j = K % P; j + K < kPerLane; j += 2 * K)
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i + j + K < kPerLane && (i + j) / (2 * P) == (i + j + K) / (2 * P))
        ce(v, i + j, i + j + K);
}

template <int P, int K>
__device__ __forceinline__ void oem_merge(Keys& v) {
  oem_stage<P, K>(v);
  if constexpr (K > 1) oem_merge<P, K / 2>(v);
}

template <int P = 1>
__device__ __forceinline__ void oem_sort(Keys& v) {
  oem_merge<P, P>(v);
  if constexpr (2 * P < kPerLane) oem_sort<2 * P>(v);
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void load_plane(const int* __restrict__ src, unsigned (&k)[kPerLane],
                                           int lane) {
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < kPerLane / 4; ++q) {
    const int4 x = __ldcs(p + q * 32 + lane);
    k[4 * q + 0] = static_cast<unsigned>(x.x) ^ kBias;
    k[4 * q + 1] = static_cast<unsigned>(x.y) ^ kBias;
    k[4 * q + 2] = static_cast<unsigned>(x.z) ^ kBias;
    k[4 * q + 3] = static_cast<unsigned>(x.w) ^ kBias;
  }
}

// The lane's 32 entries (entries 32l..32l+31 of the tile) to its rows.
__device__ __forceinline__ void put_rows(const Keys& v, unsigned* sa, unsigned* sb, unsigned* sc,
                                         int lane) {
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int i = lane * kRow + r;
    sa[i] = v.a[r];
    sb[i] = v.b[r];
    sc[i] = v.c[r];
  }
}

// Serial merge of the runs A = [a, a_end) and B = [b, b_end) (entry
// indices) into the lane's 32 registers, A first on ties.
__device__ __forceinline__ void serial_merge(Keys& v, int a, int b, int a_end, int b_end,
                                             const unsigned* sa, const unsigned* sb,
                                             const unsigned* sc) {
  int ia = a < a_end ? pad(a) : kSentinel, ib = b < b_end ? pad(b) : kSentinel;
  unsigned a0 = sa[ia], a1 = sb[ia], a2 = sc[ia];
  unsigned b0 = sa[ib], b1 = sb[ib], b2 = sc[ib];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const bool p = lt_mask(b0, b1, b2, a0, a1, a2);
    v.a[r] = p ? b0 : a0;
    v.b[r] = p ? b1 : a1;
    v.c[r] = p ? b2 : a2;
    if (r + 1 == kPerLane) break;
    if (p) {
      ++b;
      ib = b < b_end ? pad(b) : kSentinel;
      b0 = sa[ib];
      b1 = sb[ib];
      b2 = sc[ib];
    } else {
      ++a;
      ia = a < a_end ? pad(a) : kSentinel;
      a0 = sa[ia];
      a1 = sb[ia];
      a2 = sc[ia];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
tile_sort3_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                  const int* __restrict__ k2, int* __restrict__ o0,
                  int* __restrict__ o1, int* __restrict__ o2, long long tiles) {
  __shared__ unsigned sk[kWarps][3][kPlane];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (tile >= tiles) return;
  const long long base = tile * kTile;
  unsigned* sa = sk[warp][0];
  unsigned* sb = sk[warp][1];
  unsigned* sc = sk[warp][2];
  if (lane == 0) sa[kSentinel] = sb[kSentinel] = sc[kSentinel] = ~0u;
  Keys v;
  load_plane(k0 + base, v.a, lane);
  load_plane(k1 + base, v.b, lane);
  load_plane(k2 + base, v.c, lane);
  oem_sort(v);

  // runs of L into 2L: lane l makes entries 32l..32l+31, which lie on the
  // diagonal j of its pair of runs
#pragma unroll 1
  for (int L = kPerLane; L < kTile; L <<= 1) {
    put_rows(v, sa, sb, sc, lane);
    __syncwarp();
    const int j = (kPerLane * lane) & (2 * L - 1);
    const int s0 = kPerLane * lane - j;  // A = [s0, s0 + L), B after it
    int lo = max(0, j - L), hi = min(j, L);
    while (lo < hi) {  // how many of the first j outputs come from A
      const int mid = (lo + hi) >> 1;
      const int ia = pad(s0 + mid), ib = pad(s0 + L + j - 1 - mid);
      if (lt_mask(sa[ib], sb[ib], sc[ib], sa[ia], sb[ia], sc[ia])) hi = mid;
      else lo = mid + 1;
    }
    serial_merge(v, s0 + lo, s0 + L + j - lo, s0 + L, s0 + 2 * L, sa, sb, sc);
    __syncwarp();
  }

  // through the rows to coalesced 16 B stores
  put_rows(v, sa, sb, sc, lane);
  __syncwarp();
  int* out[3] = {o0 + base, o1 + base, o2 + base};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned* s = sk[warp][k];
    int4* p = reinterpret_cast<int4*>(out[k]);
#pragma unroll
    for (int q = 0; q < kPerLane / 4; ++q) {
      const int i = pad(4 * (q * 32 + lane));  // four entries of one row
      __stcs(p + q * 32 + lane,
             make_int4(static_cast<int>(s[i] ^ kBias), static_cast<int>(s[i + 1] ^ kBias),
                       static_cast<int>(s[i + 2] ^ kBias), static_cast<int>(s[i + 3] ^ kBias)));
    }
  }
}

}  // namespace

extern "C" int pcr_tile_sort3(const void* k0, const void* k1, const void* k2,
                              void* o0, void* o1, void* o2, long long tiles,
                              void* stream) {
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  tile_sort3_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(k0), static_cast<const int*>(k1),
      static_cast<const int*>(k2), static_cast<int*>(o0), static_cast<int*>(o1),
      static_cast<int*>(o2), tiles);
  return static_cast<int>(cudaGetLastError());
}
