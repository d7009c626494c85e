// B1: fbatch (`.tpc` v2, fixed-width) geometry decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_fixed_kernel`
// (pcrhpg24_tpu/render/pallas_decode_fixed.py:52, launched by
// `decode_fixed_batches` at :162/:172).
//
// What it computes: each of a batch's 1024 chains (8 groups x 128 lanes)
// has three fixed zigzag widths; point i consumes Wb = wx+wy+wz bits.
// Before extracting point i a chain refills cnt_i = F(i+1) - F(i) words
// (F(i) = (i*Wb+31)>>5, closed form) from its group's stream, at linear
// word ptrs[b, i] + rank, where rank is the exclusive prefix of cnt_i
// over the group's 128 lanes (the encoder interleaves the lanes' words
// in that order).  Three fields come out of a 4-word window, are
// unzigzagged and summed onto the chain's start values.
//
// Bound on the H100: device-memory bytes.  Per point it reads ~Wb/8
// stream bytes and writes 12 coordinate bytes; the coordinate write
// dominates (50 MB per 64-batch chunk).  Design: one 128-thread block
// per (batch, group), one thread per chain, so each point's 3 output
// rows are 512-byte coalesced stores and the stream reads of a round
// hit a contiguous run of words.  The TPU's bf16 MXU triangular matmul
// for the rank becomes a warp-shuffle block scan (two barriers per
// point).  The window lives in four registers.
//
// Shifts: `extract` keeps the reference's `(hi >> 1) >> (31 - sh)`,
// `(32 - w) & 31` and `w > 0` guard, so no shift is ever by 32 (that is
// undefined behaviour in C++, and PTX would give another answer).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 8;
constexpr int kLanes = 128;
constexpr int kRounds = 64;  // POINTS_PER_THREAD: ptrs has 64 entries

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

// exclusive prefix sum of v over the block's 128 threads
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int base = 0;
  for (int k = 0; k < warp; ++k) base += warp_sums[k];
  __syncthreads();  // warp_sums is rewritten by the next call
  return base + x - v;
}

__global__ void __launch_bounds__(kLanes)
decode_fixed_kernel(const int* __restrict__ widths,     // (B,3,8,128)
                    const uint32_t* __restrict__ streams,  // (B,maxt,8,128)
                    const int* __restrict__ ptrs,       // (B,1,64)
                    const int* __restrict__ starts,     // (B,3,8,128)
                    int* __restrict__ out,              // (B,points,3,8,128)
                    int maxt, int points) {
  __shared__ int warp_sums[kLanes / 32];
  const int b = blockIdx.x / kGroups;
  const int g = blockIdx.x % kGroups;
  const int l = threadIdx.x;
  const long long chain_off = static_cast<long long>(g) * kLanes + l;
  const long long b3 = static_cast<long long>(b) * 3 * kGroups * kLanes;

  const int wx = widths[b3 + 0 * kGroups * kLanes + chain_off];
  const int wy = widths[b3 + 1 * kGroups * kLanes + chain_off];
  const int wz = widths[b3 + 2 * kGroups * kLanes + chain_off];
  const int wb = wx + wy + wz;  // <= 96 bits per point
  int px = starts[b3 + 0 * kGroups * kLanes + chain_off];
  int py = starts[b3 + 1 * kGroups * kLanes + chain_off];
  int pz = starts[b3 + 2 * kGroups * kLanes + chain_off];

  const uint32_t* gstream =
      streams + static_cast<long long>(b) * maxt * kGroups * kLanes +
      static_cast<long long>(g) * kLanes;
  const int nwords = maxt * kLanes;  // words in this group's stream
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;

  for (int i = 0; i < points; ++i) {
    const int bits = i * wb;
    const int bp = bits & 31;
    const int fi = (bits + 31) >> 5;
    const int ve = fi - (bits >> 5);           // window words valid now
    const int cnt = ((bits + wb + 31) >> 5) - fi;  // refill, 0..3
    const int rank = block_exclusive_scan(cnt, warp_sums);
    const int base = ptrs[b * kRounds + i] + rank;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (cnt > j) {
        int idx = base + j;
        idx = idx < 0 ? 0 : (idx >= nwords ? nwords - 1 : idx);
        const uint32_t v =
            gstream[static_cast<long long>(idx >> 7) * kGroups * kLanes +
                    (idx & (kLanes - 1))];
        const int slot = ve + j;
        if (slot == 0) w0 = v;
        else if (slot == 1) w1 = v;
        else if (slot == 2) w2 = v;
        else if (slot == 3) w3 = v;
      }
    }
    const uint32_t zx = extract(w0, w1, w2, w3, bp, wx);
    const uint32_t zy = extract(w0, w1, w2, w3, bp + wx, wy);
    const uint32_t zz = extract(w0, w1, w2, w3, bp + wx + wy, wz);
    px = wrap_add(px, unzigzag(zx));
    py = wrap_add(py, unzigzag(zy));
    pz = wrap_add(pz, unzigzag(zz));
    int* o = out + (static_cast<long long>(b) * points + i) * 3 * kGroups * kLanes +
             chain_off;
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
  }
}

}  // namespace

extern "C" int pcr_decode_fixed(const void* widths, const void* streams,
                                const void* ptrs, const void* starts,
                                void* out, int batches, int maxt, int points,
                                void* stream) {
  decode_fixed_kernel<<<batches * kGroups, kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(widths), static_cast<const uint32_t*>(streams),
      static_cast<const int*>(ptrs), static_cast<const int*>(starts),
      static_cast<int*>(out), maxt, points);
  return static_cast<int>(cudaGetLastError());
}
