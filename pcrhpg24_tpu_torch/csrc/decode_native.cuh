// B5: tbatch (`.tpc` v1, canonical bucket-Huffman) geometry decode for
// Hopper (sm_90a): the kernel's device code, templated on a variant.
//
// Replaces the Pallas TPU kernel `_decode_kernel_impl`
// (pcrhpg24_tpu/render/pallas_decode.py:55, launched by
// `decode_native_batches` at :169/:188).  `decode_native.cu` instantiates
// the shipped kernel (`kFull`); the probe
// `experiments/exp_pallas_variants.cu` instantiates it and the variants
// with stages cut out or done another way, so that its `full` is this
// code and not a copy.
//
// What it computes: each of a batch's 1024 chains (8 groups x 128 lanes)
// decodes 192 symbols (64 points x 3 components) from its group's word
// stream.  A chain holds a two-word window (cur, nxt) and a bit offset.
// Per symbol: the top 12 window bits give the code length L and, through
// the batch's canonical length limits, the symbol index, which a
// 128-entry LUT maps to a zigzag bit-length bucket; `bucket - 1` raw
// extra bits follow.  After each of the two consumes, chains whose offset
// passed 32 shift nxt into cur and take a new word at ptrs[b, t, g] +
// rank, rank being the exclusive prefix of that need over the group's
// 128 chains (the encoder interleaved the words in that order,
// codec/native.py:264-294).  Deltas are unzigzagged and summed onto the
// chain's start values.
//
// Bound on the H100: latency.  Each chain is a serial chain of 192
// symbols (a symbol's length decides where the next starts), and a 64-batch
// chunk has only 65,536 chains, ~500 per SM, so the card holds ~16 warps
// per SM whatever the layout; the bytes (~5 stream bytes read, 12
// coordinate bytes written per point: 0.021 ms a chunk) and the issue
// (~60 instructions per symbol: ~0.025 ms) lie below it.  A plain port
// of the TPU kernel (one 128-thread block per group) puts a block
// barrier, a serial walk over the warps' counts and a dependent
// device-memory load on every one of 384 rounds, and an 11-step compare
// ladder (22 shared reads) on every symbol.  So the design shortens each
// symbol's dependent path:
//  - A symbol's two refill rounds are resolved together: both rounds'
//    needs follow from the table entry (L, then bucket - 1 extra bits)
//    before either word is read, so one hand-over and two parallel reads
//    serve both rounds.
//  - The ladder becomes a table: each block builds, from lj and the LUT,
//    the 4096-entry u16 table `L | bucket << 4` indexed by the 12-bit
//    window (the ladder's L and bucket depend on nothing else), so a
//    symbol costs one shared load.  The build keeps the ladder's
//    expressions, the clip of the symbol index to [0, 127] and L's shift
//    guard, and walks each thread's run of windows from one ladder
//    evaluation, applying the limits it passes; buckets lie in [0, 33)
//    (codec/native.py:200), so 12 bits hold them.  `code_table_plain`
//    (render/decode_tbatch.py) is its plain version.
//  - No block barrier: one block per (batch, group) holds 2 consumer
//    warps, two chains per thread (chains 64w + 32k + lane), and a
//    producer warp.  A chain's rank is the popc of the earlier chain
//    rows' ballots plus popc(ballot & lanemask_lt); warp 1 adds warp 0's
//    counts, which warp 0 publishes in shared memory per symbol (count + 1,
//    so that 0 means "not yet"; every symbol has its own slot).  Two chains
//    per thread give the same latency hiding as one chain in twice the
//    warps, with half the hand-overs.  (One warp per group with four
//    chains per lane needed no hand-over but left one warp per scheduler,
//    and ran slower than this.)
//  - No device memory on the path: the group's word stream is staged in
//    shared memory ahead of use, in a ring of 4 chunks x 1024 words (16
//    KB, async_copy.cuh) with a full and an empty mbarrier per slot.  The
//    producer's lane 0 streams the chunks in with `cp.async.bulk`, each
//    into the slot that all consumer threads have released.  Point i's
//    six rounds read words [min ptrs, max ptrs + 128); the pointers only
//    grow (cumulative word counts), so a warp releases a chunk once its
//    points have passed it, and up to three chunks (~100 rounds of the
//    bench terrain) are in flight ahead of the slower warp.  The ring
//    streams a row of any length: the format's worst case (192 symbols x
//    128 chains x (12 + 31) bits, about 33k words per group) wraps it
//    eight times; the crafted gates run a 24.5k-word group through it.  A
//    point whose words do not lie inside the row, or behind the chunks a
//    warp still holds (no encoder writes one), reads device memory with
//    the reference's clamp, so the result never depends on the ring.
//  - Grid: 512 blocks of 96 threads for a 64-batch chunk, 28 KB of static
//    shared memory each: all resident at once (~3.9 blocks per SM).
//  - Each point's 3 output rows are 512-byte coalesced stores.
//
// Shifts: the reference's guards are kept as written, since a C++ shift
// by 32 or more is undefined: `nxt >> min(32 - bitpos, 31)` used only
// where bitpos > 0, `(win2 >> (31 - e)) >> 1`, `win12 >> min(12 - L, 12)`
// and the clip of the symbol index to [0, 127].  e = max(bucket - 1, 0)
// lies in [0, 31] because buckets lie in [0, 33).
//
// The variants (`Variant`, the probe's template values; `Stages` says
// which stage each keeps).  A variant that reads no word from the ring
// streams none into it either: its producer warp copies nothing and its
// consumers hold no slot, so no barrier waits on a slot nobody frees.
//  - kLadder: no table: L by the 11-compare ladder against lj in
//    registers, then dD[L] and the LUT from shared memory (the TPU's
//    production form, which the table replaced).
//  - kRankScan: the rank by a scan of the group's 128 needs in shared
//    memory, a barrier of the two consumer warps between its 7 steps, in
//    place of the ballots and the hand-over.
//  - kNoTable: L by the ladder and bucket = L: no table, no dD, no LUT.
//  - kNoWindow: ranks and hand-over kept; the refilled word is the rank.
//  - kNoRefill: no word is ever taken: no ring, no rank, no hand-over.
//  - kNoRefillNoTable: both cuts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {
namespace b5 {

namespace ac = async_copy;

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kChains = 2;                       // chains per consumer thread
constexpr int kWarps = kLanes / (32 * kChains);  // 2 consumer warps per group
constexpr int kThreads = 32 * (kWarps + 1);      // and the producer warp
constexpr int kMaxL = 12;
constexpr int kTable = 1 << kMaxL;
constexpr int kPoints = 64;
constexpr int kSymbols = 3 * kPoints;
constexpr int kRounds = 2 * kSymbols;  // a refill round after each of a symbol's 2 consumes
// warp 0's two round counts ride in one word, 8 bits each (at most 64 + 1)
static_assert(kWarps == 2 && 32 * kChains + 1 < 256, "one hand-over word, two fields");

enum Variant : int {
  kFull = 0,
  kLadder = 1,
  kRankScan = 2,
  kNoTable = 3,
  kNoWindow = 4,
  kNoRefill = 5,
  kNoRefillNoTable = 6,
};

template <int V>
struct Stages {
  // the 4096-entry (L, bucket) table; else the ladder
  static constexpr bool kTab = V == kFull || V == kRankScan || V == kNoWindow || V == kNoRefill;
  // the bucket from dD and the LUT; else bucket = L
  static constexpr bool kLut = V != kNoTable && V != kNoRefillNoTable;
  static constexpr bool kRefill = V != kNoRefill && V != kNoRefillNoTable;
  static constexpr bool kRing = kRefill && V != kNoWindow;  // words from the ring
  static constexpr bool kBallots = kRefill && V != kRankScan;
};

__device__ __forceinline__ uint32_t window_hi(uint32_t cur, uint32_t nxt,
                                              int bitpos) {
  const uint32_t hi = cur << static_cast<uint32_t>(bitpos);
  const int s = 32 - bitpos < 31 ? 32 - bitpos : 31;
  const uint32_t lo = nxt >> static_cast<uint32_t>(s);
  return hi | (bitpos > 0 ? lo : 0u);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_row(int idx, int maxw) {
  return idx < 0 ? 0 : (idx >= maxw ? maxw - 1 : idx);
}

using StreamRing = ac::Ring<10, 4>;  // 4 chunks x 1024 words

struct Shared {
  StreamRing ring;
  int ptrs[kRounds];
  int2 span[kPoints];  // first and last chunk a point's 6 rounds read
  // per symbol, warp 0's two round counts: (countA + 1) | countB << 8, 0
  // until published
  int cnt[kSymbols];
  uint16_t tab[kTable];  // the ladder variants keep dD[L] in its first words
  int lj[32];
  int lut[kLanes];
  int nchunks;
};

// kRankScan's scan: each chain's needs (a | b << 16), double-buffered
struct SharedScan : Shared {
  int scan[2][kLanes];
};

template <int V>
using SharedOf = std::conditional_t<V == kRankScan, SharedScan, Shared>;

// The thread's chains: warp * 32 * kChains + 32 * k + lane, k < kChains.
struct Chains {
  uint32_t cur[kChains], nxt[kChains];
  int bitpos[kChains];
};

// A barrier of the consumer warps alone (the producer has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWarps * 32) : "memory");
}

// The ladder's table entry `L | bucket << 4` for a 12-bit window: L
// counts the limits at or below it; the bucket is lut[(win12 >> (12 - L))
// + dD[L]] (dD in the table's first words) or, without the LUT, L.
template <bool kLut>
__device__ __forceinline__ int ladder_entry(int win12, const int (&lim)[kMaxL - 1],
                                            const Shared& s) {
  int L = 1;
#pragma unroll
  for (int j = 0; j < kMaxL - 1; ++j) L += win12 >= lim[j] ? 1 : 0;
  if constexpr (!kLut) {
    return L | (L << 4);
  } else {
    const int sh = kMaxL - L < kMaxL ? kMaxL - L : kMaxL;
    int sym_idx = (win12 >> sh) + reinterpret_cast<const int*>(s.tab)[L];
    sym_idx = sym_idx < 0 ? 0 : (sym_idx > 127 ? 127 : sym_idx);
    return L | (s.lut[sym_idx] << 4);
  }
}

// kRankScan: the exclusive prefix of both rounds' needs over the group's
// 128 chains, by a Hillis-Steele scan in shared memory (7 steps, each
// behind a barrier of the consumer warps).
__device__ __forceinline__ void scan_ranks(SharedScan& s, const bool (&need_a)[kChains],
                                           const bool (&need_b)[kChains], int local,
                                           int2 ptr, int (&pos_a)[kChains],
                                           int (&pos_b)[kChains]) {
  int own[kChains], run[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    own[k] = (need_a[k] ? 1 : 0) | (need_b[k] ? 1 << 16 : 0);
    run[k] = own[k];
    s.scan[0][local + 32 * k] = own[k];
  }
  consumer_sync();
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    const int d = 1 << t;
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const int c = local + 32 * k;
      if (c >= d) run[k] += s.scan[t & 1][c - d];
      s.scan[(t & 1) ^ 1][c] = run[k];
    }
    consumer_sync();
  }
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    const int excl = run[k] - own[k];
    pos_a[k] = ptr.x + (excl & 0xffff);
    pos_b[k] = ptr.y + (excl >> 16);
  }
}

// One symbol (rounds t = 2 * sym and t + 1) of the thread's chains: both
// rounds' needs follow from the table entry before either word is read,
// so the ballots, the hand-over and the reads of both rounds go together.
template <int V, bool kRingReads>
__device__ __forceinline__ void decode_symbol(Chains& ch, int (&delta)[kChains], int sym,
                                              SharedOf<V>& s, const uint32_t* gstream,
                                              int maxw, int warp, unsigned lt,
                                              const int (&lim)[kMaxL - 1]) {
  using St = Stages<V>;
  const int2 ptr = *reinterpret_cast<const int2*>(&s.ptrs[2 * sym]);  // rounds t, t + 1
  int ent[kChains], bit_a[kChains], bit_b[kChains];
  bool need_a[kChains], need_b[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    const int win12 =
        static_cast<int>(window_hi(ch.cur[k], ch.nxt[k], ch.bitpos[k]) >> (32 - kMaxL));
    if constexpr (St::kTab)
      ent[k] = s.tab[win12];
    else
      ent[k] = ladder_entry<St::kLut>(win12, lim, s);
    const int bucket = ent[k] >> 4;
    const int e = bucket - 1 > 0 ? bucket - 1 : 0;
    bit_a[k] = ch.bitpos[k] + (ent[k] & 15);  // + L
    need_a[k] = bit_a[k] >= 32;
    if (need_a[k]) bit_a[k] -= 32;
    bit_b[k] = bit_a[k] + e;
    need_b[k] = bit_b[k] >= 32;
    if (need_b[k]) bit_b[k] -= 32;
  }
  // ranks in chain order: the warp's earlier chain rows, then lanes below
  int pos_a[kChains], pos_b[kChains];
  if constexpr (St::kBallots) {
    int run_a = 0, run_b = 0;
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const unsigned ballot_a = __ballot_sync(0xffffffffu, need_a[k]);
      const unsigned ballot_b = __ballot_sync(0xffffffffu, need_b[k]);
      pos_a[k] = ptr.x + run_a + __popc(ballot_a & lt);
      pos_b[k] = ptr.y + run_b + __popc(ballot_b & lt);
      run_a += __popc(ballot_a);
      run_b += __popc(ballot_b);
    }
    if (warp == 0) {
      if ((threadIdx.x & 31) == 0) ac::store_volatile(&s.cnt[sym], (run_a + 1) | (run_b << 8));
    } else {  // warp 1's chains follow warp 0's
      int c = ac::load_volatile(&s.cnt[sym]);
      while (c == 0) c = ac::load_volatile(&s.cnt[sym]);
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        pos_a[k] += (c & 255) - 1;
        pos_b[k] += c >> 8;
      }
    }
  } else if constexpr (V == kRankScan) {
    scan_ranks(s, need_a, need_b, warp * 32 * kChains + (threadIdx.x & 31), ptr, pos_a,
               pos_b);
  }
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    uint32_t word_a = 0, word_b = 0;
    if constexpr (St::kRing) {
      if (kRingReads) {  // the point's span lies inside the row: no clamp
        if (need_a[k]) word_a = s.ring.word(pos_a[k]);
        if (need_b[k]) word_b = s.ring.word(pos_b[k]);
      } else {
        if (need_a[k]) word_a = ac::load_global(gstream + clamp_row(pos_a[k], maxw));
        if (need_b[k]) word_b = ac::load_global(gstream + clamp_row(pos_b[k], maxw));
      }
    } else if constexpr (St::kRefill) {  // kNoWindow: the word is the rank
      word_a = static_cast<uint32_t>(pos_a[k] - ptr.x);
      word_b = static_cast<uint32_t>(pos_b[k] - ptr.y);
    }
    if (St::kRefill && need_a[k]) {  // round t
      ch.cur[k] = ch.nxt[k];
      ch.nxt[k] = word_a;
    }
    const int bucket = ent[k] >> 4;
    const uint32_t eu = static_cast<uint32_t>(bucket - 1 > 0 ? bucket - 1 : 0);
    const uint32_t win2 = window_hi(ch.cur[k], ch.nxt[k], bit_a[k]);
    const uint32_t extra = ((win2 >> (31u - eu)) >> 1) & ((1u << eu) - 1u);
    if (St::kRefill && need_b[k]) {  // round t + 1
      ch.cur[k] = ch.nxt[k];
      ch.nxt[k] = word_b;
    }
    ch.bitpos[k] = bit_b[k];
    const uint32_t z = bucket == 0 ? 0u : ((1u << eu) | extra);
    delta[k] = static_cast<int>(z >> 1) ^ -static_cast<int>(z & 1u);
  }
}

template <int V, bool kRingReads>
__device__ __forceinline__ void decode_point(Chains& ch, int (&px)[kChains],
                                             int (&py)[kChains], int (&pz)[kChains], int i,
                                             SharedOf<V>& s, const uint32_t* gstream,
                                             int maxw, int warp, unsigned lt,
                                             const int (&lim)[kMaxL - 1]) {
  int d[kChains];
  decode_symbol<V, kRingReads>(ch, d, 3 * i, s, gstream, maxw, warp, lt, lim);
#pragma unroll
  for (int k = 0; k < kChains; ++k) px[k] = wrap_add(px[k], d[k]);
  decode_symbol<V, kRingReads>(ch, d, 3 * i + 1, s, gstream, maxw, warp, lt, lim);
#pragma unroll
  for (int k = 0; k < kChains; ++k) py[k] = wrap_add(py[k], d[k]);
  decode_symbol<V, kRingReads>(ch, d, 3 * i + 2, s, gstream, maxw, warp, lt, lim);
#pragma unroll
  for (int k = 0; k < kChains; ++k) pz[k] = wrap_add(pz[k], d[k]);
}

template <int V = kFull>
__global__ void __launch_bounds__(kThreads)
decode_native_kernel(const int* __restrict__ lj,          // (B,1,32)
                     const uint32_t* __restrict__ streams,  // (B,8,maxw)
                     const int* __restrict__ ptrs,        // (B,384,8)
                     const int* __restrict__ lut,         // (B,1,128)
                     const int* __restrict__ starts,      // (B,3,8,128)
                     int* __restrict__ out,               // (B,points,3,8,128)
                     int maxw, int points) {
  using St = Stages<V>;
  __shared__ __align__(128) SharedOf<V> s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / kGroups;
  const int g = blockIdx.x % kGroups;
  const uint32_t* gstream =
      streams + (static_cast<long long>(b) * kGroups + g) * maxw;
  const int* gptrs = ptrs + static_cast<long long>(b) * kRounds * kGroups + g;  // stride 8
  // chunk j of the row: one bulk copy (maxw % 4 == 0 keeps it 16-byte aligned)
  auto copy = [&](int j, uint32_t* dst, uint64_t* bar) {
    const int left = maxw - j * StreamRing::kChunk;
    const uint32_t bytes = 4u * (left < StreamRing::kChunk ? left : StreamRing::kChunk);
    ac::expect_tx(bar, bytes);
    ac::bulk_load(dst, gstream + static_cast<long long>(j) * StreamRing::kChunk, bytes, bar);
  };

  for (int k = tid; k < kRounds; k += kThreads) s.ptrs[k] = gptrs[k * kGroups];
  if (tid < 32) s.lj[tid] = lj[b * 32 + tid];
  for (int k = tid; k < kLanes; k += kThreads) s.lut[k] = lut[b * kLanes + k];
  for (int k = tid; k < kSymbols; k += kThreads) s.cnt[k] = 0;
  if (tid == 0) s.ring.init(kWarps * 32);
  ac::bar_init_fence();
  __syncthreads();

  if (tid < kPoints) {
    // the chunks the point's rounds read, if every round's words lie
    // inside the row (always, for an encoder's stream); else -1: the
    // point reads device memory, clamping as the reference does
    int lo = maxw, hi = 0;
    bool inside = true;
#pragma unroll
    for (int r = 6 * tid; r < 6 * tid + 6; ++r) {
      const int p = s.ptrs[r];
      inside = inside && p >= 0 && p <= maxw - kLanes;
      lo = p < lo ? p : lo;
      hi = p > hi ? p : hi;
    }
    s.span[tid] = inside ? make_int2(lo >> StreamRing::kChunkLog2,
                                     (hi + kLanes - 1) >> StreamRing::kChunkLog2)
                         : make_int2(-1, -1);
  }
  if (warp == kWarps) {
    // producer: the chunks up to the last word any round of the first
    // `points` reads, the first kStages of them before the table is built
    int hi = 0;
    for (int t = lane; t < 6 * points; t += 32) {
      const int h = clamp_row(s.ptrs[t] + kLanes - 1, maxw);
      hi = h > hi ? h : hi;
    }
    const int n = (__reduce_max_sync(0xffffffffu, hi) >> StreamRing::kChunkLog2) + 1;
    if (lane == 0) {
      s.nchunks = n;
      if (St::kRing) s.ring.produce(0, n < StreamRing::kStages ? n : StreamRing::kStages, copy);
    }
  }

  if constexpr (St::kTab) {
    // the (L, bucket) table of the batch's code.  The ladder's L and dD[L]
    // change only where the window reaches one of the 11 limits, so each
    // thread runs the ladder once for the first of its run of windows and
    // then steps through the run, applying the limits it passes.
    constexpr int kRun = (kTable + kThreads - 1) / kThreads;
    int lim[kMaxL - 1], dlt[kMaxL - 1];
#pragma unroll
    for (int j = 0; j < kMaxL - 1; ++j) {
      lim[j] = s.lj[j];
      dlt[j] = s.lj[16 + j];
    }
    const int w0 = tid * kRun;
    const int end = w0 + kRun < kTable ? w0 + kRun : kTable;
    int L = 1;
    int dd = s.lj[28];
    int next = kTable;  // the next window above w0 where a limit lies
#pragma unroll
    for (int j = 0; j < kMaxL - 1; ++j) {
      const int ge = w0 >= lim[j] ? 1 : 0;
      L += ge;
      dd += ge * dlt[j];
      if (lim[j] > w0 && lim[j] < next) next = lim[j];
    }
    for (int w = w0; w < end; ++w) {
      if (w == next) {
        next = kTable;
#pragma unroll
        for (int j = 0; j < kMaxL - 1; ++j) {
          if (lim[j] == w) {
            ++L;
            dd += dlt[j];
          }
          if (lim[j] > w && lim[j] < next) next = lim[j];
        }
      }
      const int sh = kMaxL - L < kMaxL ? kMaxL - L : kMaxL;
      int sym_idx = (w >> sh) + dd;
      sym_idx = sym_idx < 0 ? 0 : (sym_idx > 127 ? 127 : sym_idx);
      s.tab[w] = static_cast<uint16_t>(L | (s.lut[sym_idx] << 4));
    }
  } else if constexpr (St::kLut) {
    // kLadder: dD[L] = dD[1] + the deltas of the limits below L, for
    // L = 1..12, in the table's first words
    if (tid <= kMaxL) {
      int dd = s.lj[28];
      for (int j = 0; j + 1 < tid; ++j) dd = wrap_add(dd, s.lj[16 + j]);
      reinterpret_cast<int*>(s.tab)[tid] = dd;
    }
  }
  __syncthreads();
  const int nchunks = s.nchunks;

  if (warp == kWarps) {
    if (St::kRing && lane == 0) s.ring.produce(StreamRing::kStages, nchunks, copy);
    return;
  }

  const long long b3 = static_cast<long long>(b) * 3 * kGroups * kLanes;
  const int local = warp * 32 * kChains + lane;  // the first chain, in the group
  int px[kChains], py[kChains], pz[kChains];
  Chains ch;
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    const int c = g * kLanes + local + 32 * k;
    px[k] = starts[b3 + 0 * kGroups * kLanes + c];
    py[k] = starts[b3 + 1 * kGroups * kLanes + c];
    pz[k] = starts[b3 + 2 * kGroups * kLanes + c];
    ch.cur[k] = gstream[local + 32 * k];
    ch.nxt[k] = gstream[kLanes + local + 32 * k];
    ch.bitpos[k] = 0;
  }
  const unsigned lt = (1u << lane) - 1u;
  int lim[kMaxL - 1];  // the ladder's limits (the variants without the table)
#pragma unroll
  for (int j = 0; j < kMaxL - 1; ++j) lim[j] = St::kTab ? 0 : s.lj[j];
  ac::Reader<StreamRing> rg{s.ring};

  for (int i = 0; i < points; ++i) {
    if constexpr (St::kRing) {
      const int2 sp = s.span[i];
      if (rg.enter(sp.x, sp.y))
        decode_point<V, true>(ch, px, py, pz, i, s, gstream, maxw, warp, lt, lim);
      else
        decode_point<V, false>(ch, px, py, pz, i, s, gstream, maxw, warp, lt, lim);
    } else {
      decode_point<V, true>(ch, px, py, pz, i, s, gstream, maxw, warp, lt, lim);
    }
    int* o = out + (static_cast<long long>(b) * points + i) * 3 * kGroups * kLanes +
             g * kLanes + local;
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      o[0 * kGroups * kLanes + 32 * k] = px[k];
      o[1 * kGroups * kLanes + 32 * k] = py[k];
      o[2 * kGroups * kLanes + 32 * k] = pz[k];
    }
  }
  if constexpr (St::kRing) rg.drain(nchunks);
}

// One launch of decode_native_kernel<V> over `batches` batches.
template <int V = kFull>
int launch(const void* lj, const void* streams, const void* ptrs, const void* lut,
           const void* starts, void* out, int batches, int maxw, int points,
           void* stream) {
  decode_native_kernel<V><<<batches * kGroups, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lj), static_cast<const uint32_t*>(streams),
      static_cast<const int*>(ptrs), static_cast<const int*>(lut),
      static_cast<const int*>(starts), static_cast<int*>(out), maxw, points);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace b5
}  // namespace
