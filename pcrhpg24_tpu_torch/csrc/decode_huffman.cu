// B12: `.huffman` (the reference's own scene format) stream decode for
// Hopper (sm_90a).
//
// No Pallas kernel: the reference decodes these streams in plain XLA
// (pcrhpg24_tpu/render/decode_jax.py:34, `decode_batches_core`), which
// vectorises the source system's CUDA warp decoder
// (modules/huffman_mem_iter_cuda/render.cu:398-451) over every batch and
// lane at once.  This kernel is that warp decoder again, computing the
// same bits as `decode_batches_core`.
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
// Bound on the H100: device-memory bytes in principle (per 64-batch
// chunk at 64 points: 50.3 MB of coordinates written, 2 MB of tables,
// 0.8 MB of start values and the chunk's encoded words read), in practice
// the latency of each lane's 192 dependent symbols: a table lookup in
// shared memory each, and a device-memory refill every few symbols that
// the next symbol waits for.  A 64-batch chunk gives 64 blocks, so half
// the SMs hold one block of 32 warps each.
//
// Design (the paper's kernel, simple first): one 1024-thread block per
// batch; the batch's two tables (2 x 16 KB) copied into shared memory
// with 16-byte loads; cur, nxt, cur_bits, the separate pointer and the
// three running coordinates in registers; `already` in a register of
// every lane of the warp (all lanes add the same popcount).  Each
// point's three output rows are 4 KB coalesced stores.
//
// Reference semantics kept exactly (`decode_jax.py:49-104`):
//  - shifts: the window is `cur` when cur_bits == 32, else
//    `cur << (32 - cb) | nxt >> cb` with cb = clamp(cur_bits, 1, 31), so
//    no shift is ever by 32 (undefined in C++);
//  - `lit = len > 0`; an escape (len <= 0, zero included) takes
//    separate[sep_ptr++]; cur_bits -= |len|; one refill adds 32;
//  - reads past a buffer's end: the reference pads `encoding` with zero
//    words and `separate` with one zero (an empty `separate` becomes one
//    zero) and clips every index into the padded array, so an index past
//    the end reads 0 and a negative one reads element 0;
//  - int32 arithmetic wraps: sums are done on unsigned values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // chains per batch
constexpr int kWarps = 32;
constexpr int kTable = 4096;
constexpr int kMaxCwLen = 12;

// `jnp.take(padded, i, mode="clip")` of a buffer of n words padded with
// zeros at its end
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ a,
                                            long long n, long long i) {
  if (i < 0) i = 0;
  return i < n ? __ldg(a + i) : 0u;
}

__device__ __forceinline__ int sep_at(const int* __restrict__ a, long long n,
                                      long long i) {
  if (i < 0) i = 0;
  return i < n ? __ldg(a + i) : 0;
}

__global__ void __launch_bounds__(kThreads)
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
  __shared__ int4 s_val4[kTable / 4];
  __shared__ int4 s_len4[kTable / 4];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  s_val4[t] = __ldg(reinterpret_cast<const int4*>(table_values + (size_t)b * kTable) + t);
  s_len4[t] = __ldg(reinterpret_cast<const int4*>(table_cw_len + (size_t)b * kTable) + t);

  const long long base =
      (long long)enc_offsets[b] + (warp ? cluster_sizes[b * kWarps + warp - 1] : 0);
  uint32_t cur = word_at(enc, n_enc, base + lane);
  uint32_t nxt = word_at(enc, n_enc, base + 32 + lane);
  int cur_bits = 32;
  long long already = 64;
  long long sp = (long long)sep_offsets[b] +
                 (t ? separate_sizes[(size_t)b * kThreads + t - 1] : 0);
  const int* sv = start_values + ((size_t)b * kThreads + t) * 3;
  uint32_t pos[3] = {(uint32_t)sv[0], (uint32_t)sv[1], (uint32_t)sv[2]};
  const uint32_t below = (1u << lane) - 1u;
  __syncthreads();
  const int* s_val = reinterpret_cast<const int*>(s_val4);
  const int* s_len = reinterpret_cast<const int*>(s_len4);

  int* o = out + (size_t)b * points * 3 * kThreads + t;
  for (int i = 0; i < points; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int cb = min(max(cur_bits, 1), 31);
      const uint32_t window =
          cur_bits == 32 ? cur : ((cur << (32 - cb)) | (nxt >> cb));
      const uint32_t key = window >> (32 - kMaxCwLen);
      const int len = s_len[key];
      int sym;
      if (len > 0) {
        sym = s_val[key];
      } else {
        sym = sep_at(sep, n_sep, sp);
        ++sp;
      }
      const uint32_t mag = len < 0 ? 0u - (uint32_t)len : (uint32_t)len;
      cur_bits = (int)((uint32_t)cur_bits - mag);
      const bool need = cur_bits <= 0;
      const uint32_t mask = __ballot_sync(0xffffffffu, need);
      if (need) {
        const uint32_t refill =
            word_at(enc, n_enc, base + already + __popc(mask & below));
        cur = nxt;
        nxt = refill;
        cur_bits = (int)((uint32_t)cur_bits + 32u);
      }
      already += __popc(mask);
      pos[k] += (uint32_t)sym;
      o[(size_t)(i * 3 + k) * kThreads] = (int)pos[k];
    }
  }
}

}  // namespace

extern "C" int pcr_decode_huffman(const void* encoding, long long n_enc,
                                  const void* enc_offsets, const void* cluster_sizes,
                                  const void* separate, long long n_sep,
                                  const void* sep_offsets, const void* separate_sizes,
                                  const void* table_values, const void* table_cw_len,
                                  const void* start_values, void* out, int batches,
                                  int points, void* stream) {
  decode_huffman_kernel<<<batches, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(encoding), n_enc,
      static_cast<const int*>(enc_offsets), static_cast<const int*>(cluster_sizes),
      static_cast<const int*>(separate), n_sep, static_cast<const int*>(sep_offsets),
      static_cast<const int*>(separate_sizes), static_cast<const int*>(table_values),
      static_cast<const int*>(table_cw_len), static_cast<const int*>(start_values),
      static_cast<int*>(out), points);
  return static_cast<int>(cudaGetLastError());
}
