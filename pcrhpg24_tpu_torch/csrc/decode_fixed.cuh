// B1: fbatch (`.tpc` v2, fixed-width) geometry decode for Hopper (sm_90a):
// the kernel's device code, templated on a variant.
//
// Replaces the Pallas TPU kernel `_decode_fixed_kernel`
// (pcrhpg24_tpu/render/pallas_decode_fixed.py:52, launched by
// `decode_fixed_batches` at :162/:172).  `decode_fixed.cu` instantiates
// the shipped kernel (`<0, false>`); the probe `experiments/r3_decode_ilp.cu`
// instantiates it and the variants, so that its `full` is this code and
// not a copy.
//
// What it computes: each of a batch's 1024 chains (8 groups x 128 lanes)
// has three fixed zigzag widths; point i consumes Wb = wx+wy+wz bits.
// Before extracting point i a chain refills cnt_i = F(i+1) - F(i) words
// (F(i) = (i*Wb+31)>>5, closed form) from its group's stream, at linear
// word ptrs[b, i] + rank, where rank is the exclusive prefix of cnt_i
// over the group's 128 chains (the encoder interleaves the chains' words
// in that order).  Three fields come out of a 4-word window, are
// unzigzagged and summed onto the chain's start values.
//
// Bound on the H100: device-memory bytes in principle (the coordinate
// write dominates: 50 MB per 64-batch chunk, 0.015 ms at 3.35 TB/s), in
// practice the latency of each chain's 64 dependent points, ~16 warps
// per SM being all a chunk's 65,536 chains fill.  A plain port of the
// TPU kernel (one 128-thread block per group, a block scan for the rank)
// adds two block barriers and a dependent device-memory load to every
// point, although the whole load schedule is known before the first one.
//
// Design:
//  - One block per (batch, group): 4 consumer warps, one chain per
//    thread, and a producer warp; no barrier in the point loop.  cnt_i
//    depends only on the widths, so before the loop each warp sums its
//    chains' counts for every round (`__reduce_add_sync`) into shared
//    memory and one block barrier publishes them.  A round's rank is the
//    earlier warps' totals (one 16-byte shared load) plus the warp's own
//    lanes below: a ballot per count level (cnt <= 3 for the format's
//    widths, so three ballots; wider counts take more), none of which
//    waits for data.  (One warp per group with four chains per lane
//    needed no totals but left one warp per scheduler, and ran slower
//    than the block-scan kernel.)
//  - The stream in shared memory before it is needed: a ring of 8 chunks
//    x 1024 words (32 KB, async_copy.cuh), a chunk being 8 rows
//    streams[b, r, g, :] of 512 bytes at a 4 KB stride, one
//    `cp.async.bulk` per row, all on the slot's full mbarrier.  The
//    producer's lane 0 streams the chunks in, each into the slot all 128
//    consumer threads have released.  Round i reads words [ptrs[i],
//    ptrs[i] + 384); the pointers only grow, so a warp releases a chunk
//    once its rounds have passed it, and up to seven chunks (~40 rounds of
//    the bench terrain) are in flight ahead.  The ring streams a group of
//    any length: the format's worst case (64 x 96 bits x 128 chains =
//    24,576 words, 96 KB) wraps it three times, and the smem per block
//    stays 34 KB whatever the stream, so all 512 blocks of a 64-batch
//    chunk stay resident (~3.9 per SM).  Staging a whole group, 96 KB at
//    worst, would leave two blocks per SM.  A round whose words do not lie
//    inside the stream, or behind the chunks a warp still holds (no
//    encoder writes one), reads device memory with the reference's clamp.
//  - The 4-word register window and `extract` keep the reference's steps;
//    the refilled words go into the window slots by selects (ve, the
//    words left from the last point, is 0 or 1).  Each point's 3 output
//    rows are 512-byte coalesced stores.
//
// Shifts: `extract` keeps the reference's `(hi >> 1) >> (31 - sh)`,
// `(32 - w) & 31` and `w > 0` guard, so no shift is ever by 32 (that is
// undefined behaviour in C++, and PTX would give another answer).
//
// The variants (the probe's template values): kUnroll > 0 runs the 64
// rounds as a loop of known trip count under `#pragma unroll kUnroll`
// (the shipped kernel's loop, kUnroll = 0, runs `points` rounds, not
// unrolled); kAhead computes each chain's own-lane rank of all 64 rounds
// before the loop, with the warps' totals, into shared memory (u8: a
// chain's words before it within its warp are at most 31 x 3, and 8 KB
// keeps the block's static shared memory under 48 KB), so that no ballot
// stays on the loop path.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {
namespace b1 {

namespace ac = async_copy;

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;    // consumer warps, one chain per thread
constexpr int kThreads = kLanes + 32;  // and the producer warp
constexpr int kRounds = 64;            // POINTS_PER_THREAD: ptrs has 64 entries
constexpr int kSpan = 3 * kLanes;      // words a round reads at most
constexpr int kRowWords = kLanes;      // one row streams[b, r, g, :]
using StreamRing = ac::Ring<10, 8>;    // 8 chunks x 1024 words = 8 rows each
constexpr int kChunkRows = StreamRing::kChunk / kRowWords;

__device__ __forceinline__ uint32_t extract(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3,
                                            int off, int w) {
  const int word = off >> 5;  // 0..2: off <= 31 + 32 + 32
  const uint32_t sh = static_cast<uint32_t>(off & 31);
  const uint32_t lo = word == 0 ? w0 : (word == 1 ? w1 : w2);
  const uint32_t hi = word == 0 ? w1 : (word == 1 ? w2 : w3);
  const uint32_t top = (lo << sh) | ((hi >> 1) >> (31u - sh));
  const uint32_t v = top >> (static_cast<uint32_t>(32 - w) & 31u);
  return w > 0 ? v : 0u;
}

__device__ __forceinline__ int unzigzag(uint32_t z) {
  return static_cast<int>(z >> 1) ^ -static_cast<int>(z & 1u);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_idx(int idx, int n) {
  return idx < 0 ? 0 : (idx >= n ? n - 1 : idx);
}

// Sum of cnt over the warp's lanes in `lanes`: a ballot per count level,
// 3 for the format's widths (cnt <= 3), more only for wider ones.
__device__ __forceinline__ int words_before(int cnt, unsigned lanes) {
  int sum = __popc(__ballot_sync(0xffffffffu, cnt >= 1) & lanes) +
            __popc(__ballot_sync(0xffffffffu, cnt >= 2) & lanes) +
            __popc(__ballot_sync(0xffffffffu, cnt >= 3) & lanes);
  if (__any_sync(0xffffffffu, cnt > 3)) {
    const int levels = __reduce_max_sync(0xffffffffu, cnt);
    for (int v = 4; v <= levels; ++v) sum += __popc(__ballot_sync(0xffffffffu, cnt >= v) & lanes);
  }
  return sum;
}

struct Shared {
  StreamRing ring;
  int ptrs[kRounds];
  int2 span[kRounds];          // first and last chunk a round reads
  int4 tot[kRounds];           // words each warp's chains take in a round
  int nchunks;
};

// kAhead's ranks: each chain's words before it within its warp, per round
struct SharedAhead : Shared {
  uint8_t rank[kRounds][kLanes];
};

template <bool kAhead>
using SharedOf = std::conditional_t<kAhead, SharedAhead, Shared>;

// The words of the chains before the thread's within its warp, in round
// i: by ballots, or (kAhead) as stored before the loop.
template <bool kAhead, class S>
__device__ __forceinline__ int own_words(const S& s, int i, int cnt, unsigned lt) {
  if constexpr (kAhead)
    return s.rank[i][threadIdx.x];
  else
    return words_before(cnt, lt);
}

// The words of round i for the thread's chain: n[j], j < min(cnt, 3).
template <bool kRingReads>
__device__ __forceinline__ void fetch(uint32_t (&n)[3], int base, int cnt,
                                      const StreamRing& ring, const uint32_t* gstream,
                                      int nwords) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    n[j] = 0;
    if (cnt > j) {
      if (kRingReads) {  // the round's span lies inside the stream: no clamp
        n[j] = ring.word(base + j);
      } else {
        const int idx = clamp_idx(base + j, nwords);
        n[j] = ac::load_global(gstream + static_cast<long long>(idx >> 7) * kGroups * kLanes +
                               (idx & (kLanes - 1)));
      }
    }
  }
}

template <int kUnroll = 0, bool kAhead = false>
__global__ void __launch_bounds__(kThreads)
decode_fixed_kernel(const int* __restrict__ widths,     // (B,3,8,128)
                    const uint32_t* __restrict__ streams,  // (B,maxt,8,128)
                    const int* __restrict__ ptrs,       // (B,1,64)
                    const int* __restrict__ starts,     // (B,3,8,128)
                    int* __restrict__ out,              // (B,points,3,8,128)
                    int maxt, int points) {
  __shared__ __align__(128) SharedOf<kAhead> s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / kGroups;
  const int g = blockIdx.x % kGroups;
  // the group's words: linear word idx sits at row idx >> 7, column idx & 127
  const uint32_t* gstream =
      streams + static_cast<long long>(b) * maxt * kGroups * kLanes +
      static_cast<long long>(g) * kLanes;
  const int nwords = maxt * kLanes;  // words in this group's stream
  // chunk j: rows [8j, 8j + 8) of the group, one bulk copy of 512 bytes each
  auto copy = [&](int j, uint32_t* dst, uint64_t* bar) {
    const int left = maxt - j * kChunkRows;
    const int rows = left < kChunkRows ? left : kChunkRows;
    ac::expect_tx(bar, rows * kRowWords * 4u);
    for (int r = 0; r < rows; ++r)
      ac::bulk_load(dst + r * kRowWords,
                    gstream + static_cast<long long>(j * kChunkRows + r) * kGroups * kLanes,
                    kRowWords * 4u, bar);
  };

  // the producer's first chunk goes out before anything else
  if (tid == kWarps * 32) {
    s.ring.init(kWarps * 32);
    ac::bar_init_fence();
    s.ring.produce(0, 1, copy);
  }
  if (tid < kRounds) {
    const int p = ptrs[b * kRounds + tid];
    s.ptrs[tid] = p;
    // the chunks the round reads, if its words lie inside the stream
    // (always, for an encoder's stream); else -1: the round reads device
    // memory, clamping as the reference does
    s.span[tid] = p >= 0 && p <= nwords - kSpan
                      ? make_int2(p >> StreamRing::kChunkLog2,
                                  (p + kSpan - 1) >> StreamRing::kChunkLog2)
                      : make_int2(-1, -1);
  }
  const long long chain = static_cast<long long>(g) * kLanes + tid;
  const long long b3 = static_cast<long long>(b) * 3 * kGroups * kLanes;
  int wx = 0, wy = 0, wz = 0, wb = 0;
  if (warp == kWarps) {
    // the chunks up to the last one any of the first `points` rounds reads
    int hi = 0;
    for (int i = lane; i < points; i += 32) {
      const int h = clamp_idx(ptrs[b * kRounds + i] + kSpan - 1, nwords);
      hi = h > hi ? h : hi;
    }
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) s.nchunks = (hi >> StreamRing::kChunkLog2) + 1;
  } else {
    wx = widths[b3 + 0 * kGroups * kLanes + chain];
    wy = widths[b3 + 1 * kGroups * kLanes + chain];
    wz = widths[b3 + 2 * kGroups * kLanes + chain];
    wb = wx + wy + wz;  // <= 96 bits per point
    // cnt_i depends only on the widths: each warp's words in every round
#pragma unroll 8
    for (int i = 0; i < points; ++i) {
      const int cnt = ((i * wb + wb + 31) >> 5) - ((i * wb + 31) >> 5);
      const int total = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0) (&s.tot[i].x)[warp] = total;
      if constexpr (kAhead)
        s.rank[i][tid] = static_cast<uint8_t>(words_before(cnt, (1u << lane) - 1u));
    }
  }
  __syncthreads();
  const int nchunks = s.nchunks;
  if (warp == kWarps) {
    if (lane == 0) s.ring.produce(1, nchunks, copy);
    return;
  }

  int px = starts[b3 + 0 * kGroups * kLanes + chain];
  int py = starts[b3 + 1 * kGroups * kLanes + chain];
  int pz = starts[b3 + 2 * kGroups * kLanes + chain];
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  const unsigned lt = (1u << lane) - 1u;
  ac::Reader<StreamRing> rg{s.ring};

  auto point = [&](int i) {
    const int bits = i * wb;
    const int bp = bits & 31;
    const int fi = (bits + 31) >> 5;
    const int ve = fi - (bits >> 5);               // window words valid now: 0 or 1
    const int cnt = ((bits + wb + 31) >> 5) - fi;  // refill, 0..3
    // the words of the earlier warps' chains, then of the warp's own
    const int4 tot = s.tot[i];
    const int base = s.ptrs[i] + own_words<kAhead>(s, i, cnt, lt) + (warp > 0 ? tot.x : 0) +
                     (warp > 1 ? tot.y : 0) + (warp > 2 ? tot.z : 0);
    uint32_t n[3];
    const int2 span = s.span[i];
    if (rg.enter(span.x, span.y))
      fetch<true>(n, base, cnt, s.ring, gstream, nwords);
    else
      fetch<false>(n, base, cnt, s.ring, gstream, nwords);
    // slot ve + j takes word j, j < cnt
    if (ve == 0) {
      w0 = cnt > 0 ? n[0] : w0;
      w1 = cnt > 1 ? n[1] : w1;
      w2 = cnt > 2 ? n[2] : w2;
    } else {
      w1 = cnt > 0 ? n[0] : w1;
      w2 = cnt > 1 ? n[1] : w2;
      w3 = cnt > 2 ? n[2] : w3;
    }
    const uint32_t zx = extract(w0, w1, w2, w3, bp, wx);
    const uint32_t zy = extract(w0, w1, w2, w3, bp + wx, wy);
    const uint32_t zz = extract(w0, w1, w2, w3, bp + wx + wy, wz);
    px = wrap_add(px, unzigzag(zx));
    py = wrap_add(py, unzigzag(zy));
    pz = wrap_add(pz, unzigzag(zz));
    int* o = out + (static_cast<long long>(b) * points + i) * 3 * kGroups * kLanes + chain;
    o[0 * kGroups * kLanes] = px;
    o[1 * kGroups * kLanes] = py;
    o[2 * kGroups * kLanes] = pz;
    // advance the window by the k words this point consumed
    const int k = (bp + wb) >> 5;
    const uint32_t n0 = k == 0 ? w0 : (k == 1 ? w1 : (k == 2 ? w2 : w3));
    const uint32_t n1 = k == 0 ? w1 : (k == 1 ? w2 : w3);
    const uint32_t n2 = k == 0 ? w2 : w3;
    w0 = n0;
    w1 = n1;
    w2 = n2;
  };
  if constexpr (kUnroll == 0) {
    for (int i = 0; i < points; ++i) point(i);
  } else {  // the caller passes points == kRounds
#pragma unroll(kUnroll)
    for (int i = 0; i < kRounds; ++i) point(i);
  }
  rg.drain(nchunks);
}

// One launch of decode_fixed_kernel<kUnroll, kAhead> over `batches` batches.
template <int kUnroll = 0, bool kAhead = false>
int launch(const void* widths, const void* streams, const void* ptrs, const void* starts,
           void* out, int batches, int maxt, int points, void* stream) {
  decode_fixed_kernel<kUnroll, kAhead><<<batches * kGroups, kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(widths), static_cast<const uint32_t*>(streams),
      static_cast<const int*>(ptrs), static_cast<const int*>(starts),
      static_cast<int*>(out), maxt, points);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b1
}  // namespace
