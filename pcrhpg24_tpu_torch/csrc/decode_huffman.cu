// B12: `.huffman` (the reference's own scene format) stream decode for
// Hopper (sm_90a).
//
// No Pallas kernel: the reference decodes these streams in plain XLA
// (pcrhpg24_tpu/render/decode_jax.py:34, `decode_batches_core`), which
// vectorises the source system's CUDA warp decoder
// (modules/huffman_mem_iter_cuda/render.cu:398-451) over every batch and
// lane at once.  This kernel computes the same bits as
// `decode_batches_core`.
//
// What it computes: each of a batch's 1024 chains (32 warps x 32 lanes)
// decodes `points` x 3 Huffman symbols, the x y z deltas of its points.
// A lane keeps a two-word window (cur, nxt) on its warp's word stream,
// which starts at enc_offsets[b] + cluster_sizes[b, warp - 1]; the top
// 12 bits of the window index the batch's 4096-entry table; a length
// <= 0 is an escape whose symbol comes from `separate` at the lane's own
// pointer.  When a lane's window runs dry (cur_bits <= 0) it takes the
// next word of the warp's stream: lanes that need one read, in lane
// order, words already, already + 1, ... (`__ballot_sync`, then the
// popcount of the lanes below), and `already` grows by the ballot's
// popcount.  Deltas are summed onto the chain's start values with u32
// wrap-around, and the coordinates written in B1's layout
// (B, points, 3, 8, 128), chain c at (c / 128, c % 128).
//
// Bound on the H100: device-memory bytes, 0.0248 ms per 64-batch chunk
// of the bench terrain at 64 points (50.3 MB of coordinates written,
// 18.1 MB of words and 11.3 MB of escapes read, 3.2 MB of tables,
// offsets and start values).  What stands between a warp decoder and
// that bound is latency: each lane's 192 symbols form one dependent
// chain (a symbol's length decides where the next starts), and in the
// source's design links of it wait on device memory, for a refill every
// ~2.8 symbols and an escape every ~4.4 on the terrain.  A chunk has
// only 2,048 warp streams, 16 per SM, so the latency of each link shows.
// The design takes device memory off the chain, shortens the chain, and
// spreads the streams over every SM:
//  - Word streams staged ahead of use.  A warp's stream is one
//    contiguous run of words, [base, enc_offsets[b] + cluster_sizes[b,
//    warp]), known at block start.  Each warp streams it through its own
//    ring of 4 chunks of 128 words in shared memory (2 KB) with
//    `cp.async.bulk` and one mbarrier per slot (async_copy.cuh's Ring,
//    of which it uses the slots and full barriers alone): lane 0
//    issues chunks 0..3 at block start, and before a point whose reads,
//    [head, head + 96) at most, pass the words that have landed, the warp
//    refills the slots of the chunks below head's with the next chunks
//    and waits for the ones the point reads.  `already` (and so head) is
//    warp-uniform, so the warp is its own producer: no producer warp and
//    no block barrier after the start.
//  - Escapes staged whole.  A warp's escapes are one contiguous run too
//    (`separate_sizes` is an inclusive prefix over the batch's lanes):
//    ~1,384 ints on the terrain, copied into shared memory by one bulk
//    copy at block start with 3 x points ints more (a lane may read that
//    far), up to kEscCap = 2,048 ints; each lane then reads its escapes
//    there in order.  (A lane's next escape kept loaded ahead in a
//    register does not take the load off the chain: a warp's register
//    scoreboard waits for all its lanes, and nearly every symbol has some
//    lane escaping.)
//  - Fast points.  When the table is tame (every length in [-12, 12], as
//    the format writes them; checked once per block), the point's words
//    have landed and the warp's escapes all lie in the staged run, a
//    point takes fast steps: shared-memory reads with no bound check and
//    no branch.  With tame lengths cur_bits stays in [1, 32], and a step
//    that takes a word leaves cur_bits >= 21 and takes none the next
//    step, so the next window's top 12 bits come from cur alone: the
//    word taken waits in `fresh` and enters nxt only after the next
//    step's table load, which takes the word's shared load, and the
//    ballot and popcounts that address it, off the chain.  Any other
//    point takes checked steps, the reference's step for any input.
//  - Staging never decides the result.  Bulk copies need 16-byte-aligned
//    sources and sizes, and a stream starts at any word, so each window
//    is rounded outwards to 16-byte boundaries of the buffer's addresses,
//    clipped to the buffer's last whole 16 bytes and to the cap, and
//    starts at the buffer's first aligned word at the earliest.  A
//    checked step reads any index outside what was staged and has landed
//    (a warp's words before its aligned start, the buffer's last 1-3
//    words, reads past understated or corrupt `cluster_sizes`, escapes
//    past the cap or outside the warp's run) from device memory with the
//    reference's clamp: past the end reads 0, below 0 reads element 0
//    (`word_at`, `sep_at`).
//  - A grid that fills the card.  A batch's 32 warp streams are
//    independent; only its table is shared.  Blocks of 8 warps, 4 per
//    batch (256 blocks per 64-batch chunk), each with its own copy of the
//    table, 115 KB of shared memory: up to two blocks (16 warps) resident
//    per SM, so the whole chunk is resident at once on the 132 SMs (124
//    of them hold two blocks, 8 hold one).  Blocks of 16 warps took the
//    same time; blocks of 32, one per batch as in the source, 2.4x as
//    long (PERF.md).
//  - One shared load per symbol: the block interleaves the batch's two
//    table rows into one (value, length) int2 array, read with one 8-byte
//    load.  The table rows are the first loads a block issues, ahead of
//    its bulk copies.  Stream and escape offsets within a warp are 32-bit
//    (at most 64 + 32 x 192 words); only the base offsets and the
//    device-memory fallback are 64-bit.
//  - Each point's three output rows are 128-byte coalesced warp stores.
//
// Reference semantics kept exactly (`decode_jax.py:49-104`):
//  - shifts: the window is `cur` when cur_bits == 32, else
//    `cur << (32 - cb) | nxt >> cb` with cb = clamp(cur_bits, 1, 31) (a
//    funnel shift by 32 - cb, or by 0), so no shift is ever by 32;
//  - `lit = len > 0`; an escape (len <= 0, zero included) takes
//    separate[sep_ptr++]; cur_bits -= |len|; one refill adds 32;
//  - reads past a buffer's end: the reference pads `encoding` with zero
//    words and `separate` with one zero (an empty `separate` becomes one
//    zero) and clips every index into the padded array, so an index past
//    the end reads 0 and a negative one reads element 0;
//  - int32 arithmetic wraps: sums are done on unsigned values.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

namespace ac = async_copy;

constexpr int kLanes = 1024;  // chains per batch
constexpr int kBatchWarps = 32;
constexpr int kTable = 4096;
constexpr int kMaxCwLen = 12;
constexpr int kChunkLog2 = 7;  // ring chunk: 128 words (512 B)
constexpr int kChunk = 1 << kChunkLog2;
constexpr int kStages = 4;  // ring slots per warp
using WordRing = ac::Ring<kChunkLog2, kStages>;
// words a warp stages at most, above any index a decode reads
// (3 + 64 + 32 x 192)
constexpr int kMaxStaged = 8192;

// A block of kWarps warps, each decoding one of the batch's 32 warp
// streams: kBatchWarps / kWarps blocks per batch.  The escape cap fills
// the shared memory of kMinBlocks blocks per SM.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerBatch = kBatchWarps / kWarps;
constexpr int kMinBlocks = 2;
constexpr int kEscCap = 2048;
// table | word rings | escape runs | escape barriers, one of each per warp
constexpr int kRingOff = kTable * 8;
constexpr int kEscOff = kRingOff + kWarps * (int)sizeof(WordRing);
constexpr int kBarOff = kEscOff + kWarps * kEscCap * 4;
constexpr int kSmem = kBarOff + kWarps * 8;
static_assert(sizeof(WordRing) % 16 == 0, "bulk copies land 16-byte aligned");

// `jnp.take(padded, i, mode="clip")` of a buffer of n words padded with
// zeros at its end.  The load may not be speculated: issued beside every
// shared-memory read, the symbol chain would wait on it at each step.
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ a,
                                            long long n, long long i) {
  if (i < 0) i = 0;
  return i < n ? ac::load_global(a + i) : 0u;
}

__device__ __forceinline__ int sep_at(const int* __restrict__ a, long long n,
                                      long long i) {
  return (int)word_at(reinterpret_cast<const uint32_t*>(a), n, i);
}

// The largest word index j <= i of `buf` whose address is 16-byte aligned.
__device__ __forceinline__ long long align_down(const void* buf, long long i) {
  const long long mis = (long long)((reinterpret_cast<uintptr_t>(buf) >> 2) & 3);
  return ((i + mis) & ~3LL) - mis;
}

// Words [lo, lo + words) of a buffer of n words that a warp stages for
// its run [begin, end): rounded outwards to 16 bytes, inside the buffer's
// whole 16-byte blocks, at most `cap`; off = begin - lo (in -3..3).
// words == 0: nothing staged.
struct Window {
  long long lo;
  int words, off;
};

__device__ __forceinline__ Window stage_window(const void* buf, long long n, long long begin,
                                               long long end, int cap) {
  Window w{0, 0, 0};
  if (begin < 0) return w;
  long long lo = align_down(buf, begin);
  if (lo < 0) lo += 4;  // the buffer's first aligned word
  const long long hi = min(min(align_down(buf, end + 3), align_down(buf, n)), lo + cap);
  if (hi > lo) {
    w.lo = lo;
    w.words = (int)(hi - lo);
    w.off = (int)(begin - lo);
  }
  return w;
}

// One warp stream of a batch: its staging, its 32 lanes' decode state,
// and the steps.  Every member is per lane; those that say so are the
// same in all lanes of the warp.
struct Stream {
  const uint32_t* enc;
  long long n_enc, base;  // the stream's first word in `encoding`
  Window ww;              // its staged words (uniform)
  WordRing* ring;
  uint64_t* esc_bar;      // the escape run's barrier
  int nchunks, issued, ready, avail;  // uniform: chunks in flight, landed; staged words landed
  const int* sep;
  long long n_sep, sp;    // this lane's first escape in `separate`
  Window we;              // the staged escape run (uniform)
  int* esc;
  int erel;               // this lane's first escape in the staged run; 1 << 30: outside
  bool esc_staged;        // uniform: no lane's escapes leave the staged run
  uint32_t cur, nxt, fresh, pos[3];
  bool taken_now;         // the last fast step took `fresh`, not yet in nxt
  int cur_bits, already, taken;  // already: words of the stream taken (uniform)
  int* o;

  // chunk j of the stream's words into its slot, completing on its barrier
  __device__ __forceinline__ void copy_chunk(int j) {
    const uint32_t bytes = 4u * (uint32_t)min(kChunk, ww.words - j * kChunk);
    ac::expect_tx(ring->full_of(j), bytes);
    ac::bulk_load(ring->slot(j), enc + ww.lo + j * kChunk, bytes, ring->full_of(j));
  }
  // Readies the ring for a point whose reads start at `head` (relative to
  // ww.lo): refills the slots of the chunks below head's with the next
  // chunks, and waits for those that [head, head + 96) touches.
  __device__ __forceinline__ void refresh(int head, int lane) {
    const int want = min(nchunks, (head >> kChunkLog2) + kStages);
    if (issued < want) {
      // the slots of the chunks below head's were read in earlier points
      while (ready <= want - 1 - kStages) ring->wait_full(ready++);
      __syncwarp();
      if (lane == 0) {
        ac::proxy_fence();
        for (int j = issued; j < want; ++j) copy_chunk(j);
      }
      issued = want;
    }
    const int last = min(head + 96, ww.words) - 1;
    while (ready <= (last >> kChunkLog2)) ring->wait_full(ready++);
    avail = min(ready << kChunkLog2, ww.words);
  }
  // Before a point: whether it may take the fast steps.  A point reads
  // words [head, head + 96) at most (3 steps of at most 32).
  __device__ __forceinline__ bool prepare(bool tame, int lane) {
    const int head = ww.off + already;
    if (head + 96 > avail) {
      if (taken_now) nxt = fresh;  // no read of a slot may be in flight when it refills
      taken_now = false;
      refresh(head, lane);
    }
    return tame && esc_staged && head + 96 <= avail;
  }
  // word `rr` of the stream (relative to base): the ring holds [head,
  // avail) of the current point
  __device__ __forceinline__ uint32_t word(int rr) const {
    const int si = ww.off + rr;
    return (unsigned)si < (unsigned)avail ? ring->word(si)
                                          : word_at(enc, n_enc, base + rr);
  }

  // A fast step: the table is tame, and every word and escape the point
  // can read is staged and has landed, so the step reads shared memory
  // with no bound check or branch.  With lengths in [-12, 12], cur_bits
  // stays in [1, 32], and a step that takes a word leaves cur_bits >= 21
  // and takes none the next step; so the word taken goes into `fresh`
  // and reaches nxt only after the next step's table load is issued (the
  // next window's top 12 bits come from cur alone): the shared load of
  // the word is off the symbol chain.
  __device__ __forceinline__ void fast_step(int k, const int2* tab, uint32_t below) {
    const uint32_t window = __funnelshift_l(nxt, cur, 32 - cur_bits);
    const int2 e = tab[window >> (32 - kMaxCwLen)];
    if (taken_now) nxt = fresh;
    cur_bits -= abs(e.y);
    const bool need = cur_bits <= 0;
    const uint32_t mask = __ballot_sync(0xffffffffu, need);
    // every lane loads (a slot of the ring), so that no move waits on it
    fresh = ring->word(ww.off + already + __popc(mask & below));
    if (need) {
      cur = nxt;
      cur_bits += 32;
    }
    taken_now = need;
    already += __popc(mask);
    int sym = e.x;
    if (e.y <= 0) sym = esc[erel + taken++];
    pos[k] += (uint32_t)sym;
    o[k * kLanes] = (int)pos[k];
  }
  // A checked step: the reference's step for any input; a read outside
  // what was staged and has landed goes to device memory.
  __device__ __forceinline__ void checked_step(int k, const int2* tab, uint32_t below) {
    const int cb = min(max(cur_bits, 1), 31);
    const uint32_t window = __funnelshift_l(nxt, cur, cur_bits == 32 ? 0 : 32 - cb);
    const int2 e = tab[window >> (32 - kMaxCwLen)];
    const uint32_t mag = e.y < 0 ? 0u - (uint32_t)e.y : (uint32_t)e.y;
    cur_bits = (int)((uint32_t)cur_bits - mag);
    const bool need = cur_bits <= 0;
    const uint32_t mask = __ballot_sync(0xffffffffu, need);
    if (need) {
      const uint32_t refill = word(already + __popc(mask & below));
      cur = nxt;
      nxt = refill;
      cur_bits = (int)((uint32_t)cur_bits + 32u);
    }
    already += __popc(mask);
    int sym = e.x;
    if (e.y <= 0) {
      const int r = erel + taken;
      sym = (unsigned)r < (unsigned)we.words ? esc[r] : sep_at(sep, n_sep, sp + taken);
      ++taken;
    }
    pos[k] += (uint32_t)sym;
    o[k * kLanes] = (int)pos[k];
  }
  __device__ __forceinline__ void point(bool fast, const int2* tab, uint32_t below) {
    if (fast) {
#pragma unroll
      for (int k = 0; k < 3; ++k) fast_step(k, tab, below);
    } else {
      if (taken_now) nxt = fresh;
      taken_now = false;
#pragma unroll
      for (int k = 0; k < 3; ++k) checked_step(k, tab, below);
    }
    o += 3 * kLanes;
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_huffman_kernel(const uint32_t* __restrict__ enc, long long n_enc,
                      const int* __restrict__ enc_offsets,
                      const int* __restrict__ cluster_sizes,
                      const int* __restrict__ sep, long long n_sep,
                      const int* __restrict__ sep_offsets,
                      const int* __restrict__ separate_sizes,
                      const int* __restrict__ table_values,
                      const int* __restrict__ table_cw_len,
                      const int* __restrict__ start_values,
                      int* __restrict__ out, int points) {
  constexpr int kLoads = kTable / 4 / kThreads;  // int4 of each table row per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / kBlocksPerBatch;
  const int2* s_tab = reinterpret_cast<const int2*>(smem);

  // the batch's table rows first: they head the queue to device memory
  int4 tv[kLoads], tl[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    tv[i] = __ldg(reinterpret_cast<const int4*>(table_values + (size_t)b * kTable) +
                  threadIdx.x + i * kThreads);
    tl[i] = __ldg(reinterpret_cast<const int4*>(table_cw_len + (size_t)b * kTable) +
                  threadIdx.x + i * kThreads);
  }

  // this warp's stream: warp bw of the batch
  Stream q;
  const int bw = (blockIdx.x % kBlocksPerBatch) * kWarps + warp;
  const int t = bw * 32 + lane;  // chain of the batch
  {
    const int* cs = cluster_sizes + b * kBatchWarps;
    const int* ss = separate_sizes + (size_t)b * kLanes;
    const long long enc0 = enc_offsets[b], sep0 = sep_offsets[b];
    q.enc = enc;
    q.n_enc = n_enc;
    q.base = enc0 + (bw ? cs[bw - 1] : 0);
    q.ww = stage_window(enc, n_enc, q.base, enc0 + cs[bw], kMaxStaged);
    q.ring = reinterpret_cast<WordRing*>(smem + kRingOff) + warp;
    q.esc_bar = reinterpret_cast<uint64_t*>(smem + kBarOff) + warp;
    q.nchunks = (q.ww.words + kChunk - 1) >> kChunkLog2;
    q.issued = min(q.nchunks, kStages);
    q.ready = 0;
    q.avail = 0;
    // the stream's escapes, and 3 x points more: a lane may read that far
    q.sep = sep;
    q.n_sep = n_sep;
    q.sp = sep0 + (t ? ss[t - 1] : 0);
    q.we = stage_window(sep, n_sep, sep0 + (bw ? ss[bw * 32 - 1] : 0),
                        sep0 + ss[bw * 32 + 31] + 3 * points, kEscCap);
    q.esc = reinterpret_cast<int*>(smem + kEscOff) + warp * kEscCap;
    const long long er = q.sp - q.we.lo;
    q.erel = er >= 0 && er <= kEscCap ? (int)er : 1 << 30;
    q.esc_staged = __all_sync(0xffffffffu, q.erel + 3 * points <= q.we.words);
    const int* sv = start_values + ((size_t)b * kLanes + t) * 3;
    q.pos[0] = (uint32_t)sv[0];
    q.pos[1] = (uint32_t)sv[1];
    q.pos[2] = (uint32_t)sv[2];
    q.o = out + (size_t)b * points * 3 * kLanes + t;
  }
  if (lane == 0) {
    for (int k = 0; k < kStages; ++k) ac::bar_init(&q.ring->full[k], 1);
    ac::bar_init(q.esc_bar, 1);
    ac::bar_init_fence();
  }
  __syncthreads();
  if (lane == 0) {
    for (int j = 0; j < q.issued; ++j) q.copy_chunk(j);
    if (q.we.words) {
      ac::expect_tx(q.esc_bar, 4u * q.we.words);
      ac::bulk_load(q.esc, sep + q.we.lo, 4u * q.we.words, q.esc_bar);
    }
  }
  // the table as (value, length) pairs: one 8-byte load per symbol; and
  // whether every length lies in [-12, 12], as the format's do
  int wild = 0;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    int4* tab = reinterpret_cast<int4*>(smem) + 2 * (threadIdx.x + i * kThreads);
    tab[0] = make_int4(tv[i].x, tl[i].x, tv[i].y, tl[i].y);
    tab[1] = make_int4(tv[i].z, tl[i].z, tv[i].w, tl[i].w);
    wild |= (uint32_t)(tl[i].x + kMaxCwLen) > 2u * kMaxCwLen ||
            (uint32_t)(tl[i].y + kMaxCwLen) > 2u * kMaxCwLen ||
            (uint32_t)(tl[i].z + kMaxCwLen) > 2u * kMaxCwLen ||
            (uint32_t)(tl[i].w + kMaxCwLen) > 2u * kMaxCwLen;
  }
  const bool tame = !__syncthreads_or(wild);

  q.refresh(q.ww.off, lane);  // the first two words of every lane
  if (q.we.words) ac::wait(q.esc_bar, 0);
  q.cur = q.word(lane);
  q.nxt = q.word(32 + lane);
  q.fresh = 0;
  q.taken_now = false;
  q.cur_bits = 32;
  q.already = 64;
  q.taken = 0;
  const uint32_t below = (1u << lane) - 1u;
  for (int i = 0; i < points; ++i) q.point(q.prepare(tame, lane), s_tab, below);
  // no copy may still write this block's shared memory when it exits
  while (q.ready < q.issued) q.ring->wait_full(q.ready++);
}

// The kernel's dynamic shared memory limit, set once.
cudaError_t size_kernel() {
  static cudaError_t err = cudaFuncSetAttribute(
      decode_huffman_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return err;
}

}  // namespace

extern "C" int pcr_decode_huffman(const void* encoding, long long n_enc,
                                  const void* enc_offsets, const void* cluster_sizes,
                                  const void* separate, long long n_sep,
                                  const void* sep_offsets, const void* separate_sizes,
                                  const void* table_values, const void* table_cw_len,
                                  const void* start_values, void* out, int batches,
                                  int points, void* stream) {
  const cudaError_t err = size_kernel();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_huffman_kernel<<<batches * kBlocksPerBatch, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(encoding), n_enc, static_cast<const int*>(enc_offsets),
      static_cast<const int*>(cluster_sizes), static_cast<const int*>(separate), n_sep,
      static_cast<const int*>(sep_offsets), static_cast<const int*>(separate_sizes),
      static_cast<const int*>(table_values), static_cast<const int*>(table_cw_len),
      static_cast<const int*>(start_values), static_cast<int*>(out), points);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources: out[0] registers per thread, out[1] shared
// bytes per block, out[2] blocks resident per SM (the occupancy API),
// out[3] threads per block, out[4] blocks per batch, out[5] the escapes
// a warp stages at most.
extern "C" int pcr_decode_huffman_info(int* out) {
  cudaError_t err = size_kernel();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, decode_huffman_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_huffman_kernel,
                                                        kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes) + kSmem;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = kBlocksPerBatch;
  out[5] = kEscCap;
  return 0;
}
