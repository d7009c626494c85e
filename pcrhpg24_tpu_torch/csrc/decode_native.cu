// B5: tbatch (`.tpc` v1, canonical bucket-Huffman) geometry decode for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel_impl`
// (pcrhpg24_tpu/render/pallas_decode.py:55, launched by
// `decode_native_batches` at :169/:188).
//
// What it computes: each of a batch's 1024 chains (8 groups x 128 lanes)
// decodes 192 symbols (64 points x 3 components) from its group's word
// stream.  A chain holds a two-word window (cur, nxt) and a bit offset.
// Per symbol: the top 12 window bits go through an 11-step compare
// ladder against the batch's canonical length limits, which yields the
// code length L and the symbol-index offset dD[L]; the symbol index maps
// to a zigzag bit-length bucket through a 128-entry LUT; `bucket - 1`
// raw extra bits follow.  After each of the two consumes, lanes whose
// offset passed 32 shift nxt into cur and take a new word at
// ptrs[b, t, g] + rank, rank being the exclusive prefix of that need over
// the group's 128 lanes (the encoder interleaved the words in that
// order, codec/native.py:264-294).  Deltas are unzigzagged and summed
// onto the chain's start values.
//
// Bound on the H100: the serial dependency chain of the symbol loop
// (each symbol's length decides where the next one starts), not bytes:
// per point it reads ~5 stream bytes and writes 12 coordinate bytes.
// Design: one 128-thread block per (batch, group), one thread per chain;
// the limits and the LUT live in shared memory; the TPU's bf16 MXU
// triangular matmul for the rank becomes a warp ballot + popc with a
// 4-warp carry in shared memory, double-buffered so that each refill
// round costs one barrier; each point's 3 output rows are 512-byte
// coalesced stores.
//
// Shifts: the reference's guards are kept as written, since a C++ shift
// by 32 or more is undefined: `nxt >> min(32 - bitpos, 31)` used only
// where bitpos > 0, `(win2 >> (31 - e)) >> 1`, `win12 >> min(12 - L, 12)`
// and the clip of the symbol index to [0, 127].  e = max(bucket - 1, 0)
// lies in [0, 31] because buckets lie in [0, 33) (codec/native.py:200).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kMaxL = 12;
constexpr int kRounds = 384;  // 6 refill rounds per point x 64 points

__device__ __forceinline__ uint32_t window_hi(uint32_t cur, uint32_t nxt,
                                              int bitpos) {
  const uint32_t hi = cur << static_cast<uint32_t>(bitpos);
  const int s = 32 - bitpos < 31 ? 32 - bitpos : 31;
  const uint32_t lo = nxt >> static_cast<uint32_t>(s);
  return hi | (bitpos > 0 ? lo : 0u);
}

struct Chain {
  uint32_t cur, nxt;
  int bitpos;
};

// One refill round t: lanes with bitpos >= 32 take the next word of the
// group stream in lane order.  `cnt` is a [2][kWarps] shared buffer used
// alternately by consecutive rounds, so one barrier per round suffices.
__device__ __forceinline__ void refill(Chain& ch, int t,
                                       const uint32_t* __restrict__ gstream,
                                       const int* __restrict__ gptrs,
                                       int maxw, int (*cnt)[kWarps]) {
  const bool need = ch.bitpos >= 32;
  if (need) ch.bitpos -= 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  int* c = cnt[t & 1];
  if (lane == 0) c[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int k = 0; k < warp; ++k) rank += c[k];
  if (need) {
    int idx = gptrs[t * kGroups] + rank;
    idx = idx < 0 ? 0 : (idx >= maxw ? maxw - 1 : idx);
    ch.cur = ch.nxt;
    ch.nxt = gstream[idx];
  }
}

__device__ __forceinline__ int decode_symbol(Chain& ch, int t,
                                             const int* s_lj,
                                             const int* s_lut,
                                             const uint32_t* __restrict__ gstream,
                                             const int* __restrict__ gptrs,
                                             int maxw, int (*cnt)[kWarps]) {
  const int win12 = static_cast<int>(window_hi(ch.cur, ch.nxt, ch.bitpos) >>
                                     (32 - kMaxL));
  int L = 1;
  int dd = s_lj[28];
#pragma unroll
  for (int j = 1; j < kMaxL; ++j) {
    const int ge = win12 >= s_lj[j - 1] ? 1 : 0;
    L += ge;
    dd += ge * s_lj[16 + j - 1];
  }
  const int sh = kMaxL - L < kMaxL ? kMaxL - L : kMaxL;
  int sym_idx = (win12 >> sh) + dd;
  sym_idx = sym_idx < 0 ? 0 : (sym_idx > 127 ? 127 : sym_idx);
  const int bucket = s_lut[sym_idx];
  ch.bitpos += L;
  refill(ch, t, gstream, gptrs, maxw, cnt);

  const int e = bucket - 1 > 0 ? bucket - 1 : 0;
  const uint32_t eu = static_cast<uint32_t>(e);
  const uint32_t win2 = window_hi(ch.cur, ch.nxt, ch.bitpos);
  const uint32_t extra = ((win2 >> (31u - eu)) >> 1) & ((1u << eu) - 1u);
  ch.bitpos += e;
  refill(ch, t + 1, gstream, gptrs, maxw, cnt);

  const uint32_t z = bucket == 0 ? 0u : ((1u << eu) | extra);
  return static_cast<int>(z >> 1) ^ -static_cast<int>(z & 1u);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(kLanes)
decode_native_kernel(const int* __restrict__ lj,          // (B,1,32)
                     const uint32_t* __restrict__ streams,  // (B,8,maxw)
                     const int* __restrict__ ptrs,        // (B,384,8)
                     const int* __restrict__ lut,         // (B,1,128)
                     const int* __restrict__ starts,      // (B,3,8,128)
                     int* __restrict__ out,               // (B,points,3,8,128)
                     int maxw, int points) {
  __shared__ int s_lj[32];
  __shared__ int s_lut[kLanes];
  __shared__ int cnt[2][kWarps];
  const int b = blockIdx.x / kGroups;
  const int g = blockIdx.x % kGroups;
  const int l = threadIdx.x;
  if (l < 32) s_lj[l] = lj[b * 32 + l];
  s_lut[l] = lut[b * kLanes + l];
  __syncthreads();

  const long long chain_off = static_cast<long long>(g) * kLanes + l;
  const long long b3 = static_cast<long long>(b) * 3 * kGroups * kLanes;
  int px = starts[b3 + 0 * kGroups * kLanes + chain_off];
  int py = starts[b3 + 1 * kGroups * kLanes + chain_off];
  int pz = starts[b3 + 2 * kGroups * kLanes + chain_off];

  const uint32_t* gstream =
      streams + (static_cast<long long>(b) * kGroups + g) * maxw;
  const int* gptrs = ptrs + static_cast<long long>(b) * kRounds * kGroups + g;
  Chain ch{gstream[l], gstream[kLanes + l], 0};

  for (int i = 0; i < points; ++i) {
    const int t0 = 6 * i;
    px = wrap_add(px, decode_symbol(ch, t0, s_lj, s_lut, gstream, gptrs, maxw, cnt));
    py = wrap_add(py, decode_symbol(ch, t0 + 2, s_lj, s_lut, gstream, gptrs, maxw, cnt));
    pz = wrap_add(pz, decode_symbol(ch, t0 + 4, s_lj, s_lut, gstream, gptrs, maxw, cnt));
    int* o = out + (static_cast<long long>(b) * points + i) * 3 * kGroups * kLanes +
             chain_off;
    o[0 * kGroups * kLanes] = px;
    o[1 * kGroups * kLanes] = py;
    o[2 * kGroups * kLanes] = pz;
  }
}

}  // namespace

extern "C" int pcr_decode_native(const void* lj, const void* streams,
                                 const void* ptrs, const void* lut,
                                 const void* starts, void* out, int batches,
                                 int maxw, int points, void* stream) {
  decode_native_kernel<<<batches * kGroups, kLanes, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lj), static_cast<const uint32_t*>(streams),
      static_cast<const int*>(ptrs), static_cast<const int*>(lut),
      static_cast<const int*>(starts), static_cast<int*>(out), maxw, points);
  return static_cast<int>(cudaGetLastError());
}
