// Hopper bulk copies into shared memory and the mbarriers that track
// them, as inline PTX (sm_90), and the ring of stream chunks the two
// geometry decoders (B1, B5) stage their word streams in ahead of use.
//
// A barrier's phase completes when its pending arrivals reach zero and
// every byte announced with `expect_tx` has landed; `wait(bar, parity)`
// returns once the phase of that parity has completed.

#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(arrivals)
               : "memory");
}

// Makes barrier initialisation visible to the async proxy; the caller
// follows it with a block barrier before any thread uses the barriers.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` still to land.
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

// Global -> shared, completing on `bar`.  bytes: a multiple of 16; dst
// and src 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Orders the calling thread's (and, after a warp or block barrier, its
// peers') earlier shared-memory accesses before its later bulk copies:
// a slot that was read is refilled only after this.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// A thread's own 4-byte copy global -> shared (`cp.async`, sm_80+),
// grouped by `commit`; `wait_groups<N>` returns once at most N of the
// thread's groups are still in flight.  The copies are the thread's: it
// may read their words after the wait with no barrier.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Shared-memory accesses that the compiler may neither cache in registers
// nor merge: hand-over words that other warps of the block poll.
__device__ __forceinline__ void store_volatile(int* p, int v) {
  asm volatile("st.volatile.shared.s32 [%0], %1;" ::"r"(smem(p)), "r"(v));
}

__device__ __forceinline__ int load_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem(p)));
  return v;
}

// A device-memory load the compiler may not speculate, for fallbacks
// that must not be issued beside every shared-memory read.
__device__ __forceinline__ uint32_t load_global(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// A ring of kStages chunks of 2**kChunkLog2 words of a stream row in
// shared memory, with a full and an empty barrier per slot: one producer
// thread copies chunk j into slot j % kStages once every consumer thread
// has released chunk j - kStages (the usual TMA pipeline).  Chunk j
// completes phase j / kStages of its slot's barriers, so a wait needs no
// per-slot state beyond the chunk number.  A warp that copies its own
// chunks, and so knows when a slot is free (B12), uses the slots and the
// full barriers alone (`slot`, `full_of`, `wait_full`, `word`).
template <int kChunkLog2_, int kStages_>
struct Ring {
  static constexpr int kChunkLog2 = kChunkLog2_;
  static constexpr int kStages = kStages_;
  static constexpr int kChunk = 1 << kChunkLog2;  // words
  static constexpr int kWords = kChunk * kStages;
  static_assert((kStages & (kStages - 1)) == 0, "kStages: a power of 2");

  uint32_t buf[kWords];
  uint64_t full[kStages], empty[kStages];

  // One thread; `consumers` threads release each chunk.
  __device__ __forceinline__ void init(int consumers) {
    for (int k = 0; k < kStages; ++k) {
      bar_init(&full[k], 1);
      bar_init(&empty[k], consumers);
    }
  }

  // chunk j's slot, and the barrier its copy completes on
  __device__ __forceinline__ uint32_t* slot(int j) { return buf + (j & (kStages - 1)) * kChunk; }
  __device__ __forceinline__ uint64_t* full_of(int j) { return &full[j & (kStages - 1)]; }
  // Returns once chunk j has landed.
  __device__ __forceinline__ void wait_full(int j) { wait(full_of(j), (j / kStages) & 1); }

  // The producer thread: chunks [first, n) in order; copy(j, dst, bar)
  // announces chunk j's bytes on bar and issues its bulk copies into dst.
  template <class Copy>
  __device__ __forceinline__ void produce(int first, int n, Copy copy) {
    for (int j = first; j < n; ++j) {
      if (j >= kStages) wait(&empty[j & (kStages - 1)], (j / kStages - 1) & 1);
      copy(j, slot(j), full_of(j));
    }
  }

  __device__ __forceinline__ uint32_t word(int idx) const { return buf[idx & (kWords - 1)]; }
};

// A consumer warp's view of a Ring (warp-uniform state; every lane calls).
// The stream's round pointers only grow (they are cumulative word
// counts), so a warp releases a chunk once its rounds have passed it.
template <class R>
struct Reader {
  R& r;
  int ready = 0;     // chunks [0, ready) seen complete
  int released = 0;  // chunks [0, released) given back to the producer

  // Gives back chunk `released`, after seeing it land.
  __device__ __forceinline__ void release_one() {
    if (ready <= released) {
      r.wait_full(released);
      ready = released + 1;
    }
    arrive(&r.empty[released & (R::kStages - 1)]);
    ++released;
  }
  // Makes chunks [lo_c, hi_c] readable; false if lo_c lies below the
  // chunks still held or the span exceeds the ring (no encoder writes
  // such pointers; the caller then reads device memory).
  __device__ __forceinline__ bool enter(int lo_c, int hi_c) {
    if (lo_c < released || hi_c - lo_c >= R::kStages) return false;
    while (released < lo_c) release_one();
    while (ready <= hi_c) {
      r.wait_full(ready);
      ++ready;
    }
    return true;
  }
  // Gives back every chunk up to n, each after it landed: the producer
  // then ends, and no copy still writes the block's shared memory when it
  // exits.
  __device__ __forceinline__ void drain(int n) {
    while (released < n) release_one();
  }
};

}  // namespace async_copy
