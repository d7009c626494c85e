// The card's counterpart of the TPU probe `experiments/exp_mxu_perm.py`
// (its pallas_call at :52, `mk_kernel(mode, n_stages).kern`): what a
// partner exchange costs, the step of a sorting network such as the one
// B10 (`csrc/tile_sort.cu`) replaced.  On (tiles, 8, 128) int32 tiles,
// `stages` stages of
//
//   acc[r][l] = min(acc[r][l], p) + (acc[r][l] > p),  p = acc[r][l ^ d],
//
// with d = 1, 2, 4, ..., 64 for stage s % 7 = 0, 1, ..., 6: exactly the
// TPU probe's function, which found the partner by `pltpu.roll` and a
// select (`roll`) or by a permutation matmul (`mxu`).  Three forms:
//
//   kShfl       one warp a tile; lane l holds entries (r, 32k + l), r < 8,
//               k < 4, in 32 registers.  Strides 1-16 are __shfl_xor_sync;
//               strides 32 and 64 swap registers within the lane;
//   kSmemWarp   one warp a tile in shared memory (two buffers: a stage
//               writes one, __syncwarp, reads its partners from it), the
//               lanes as kShfl's.  Every access is 32 consecutive words
//               (lane-major order), so no pad is needed against bank
//               conflicts;
//   kSmemBlock  one thread an entry, 1024 threads a tile, two buffers
//               and a __syncthreads a stage: the TPU's whole-register
//               form.
//
// Bound: each tile read once and written once (8 KB); the stages' work
// stays on the SM, so a form's time over the bound says what its
// exchanges cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSub = 8, kLanes = 128, kTile = kSub * kLanes;
constexpr int kPerLane = kTile / 32;   // entries a lane in the warp forms
constexpr int kShflWarps = 8;          // warps a block, one tile each
constexpr int kSmemWarps = 4;          // 8 KB of shared memory each
enum Form { kShfl = 0, kSmemWarp = 1, kSmemBlock = 2 };

__device__ __forceinline__ int exchange(int a, int p) { return min(a, p) + (a > p ? 1 : 0); }

// `stages` calls of STAGE<d>(...), d = 1, 2, 4, ..., 64, 1, 2, ... known at
// compile time
#define PCR_PERM_STAGES(STAGE, ...)                                                \
  {                                                                                \
    int s7 = 0;                                                                    \
    _Pragma("unroll 1") for (; s7 + 7 <= stages; s7 += 7) {                       \
      STAGE<1>(__VA_ARGS__);                                                       \
      STAGE<2>(__VA_ARGS__);                                                       \
      STAGE<4>(__VA_ARGS__);                                                       \
      STAGE<8>(__VA_ARGS__);                                                       \
      STAGE<16>(__VA_ARGS__);                                                      \
      STAGE<32>(__VA_ARGS__);                                                      \
      STAGE<64>(__VA_ARGS__);                                                      \
    }                                                                              \
    const int rest = stages - s7;                                                  \
    if (rest > 0) STAGE<1>(__VA_ARGS__);                                           \
    if (rest > 1) STAGE<2>(__VA_ARGS__);                                           \
    if (rest > 2) STAGE<4>(__VA_ARGS__);                                           \
    if (rest > 3) STAGE<8>(__VA_ARGS__);                                           \
    if (rest > 4) STAGE<16>(__VA_ARGS__);                                          \
    if (rest > 5) STAGE<32>(__VA_ARGS__);                                          \
  }

// entry i = 4r + k of a lane is (r, 32k + lane): word r * 128 + 32k + lane
__device__ __forceinline__ int word_of(int i, int lane) {
  return (i >> 2) * kLanes + 32 * (i & 3) + lane;
}

template <int D>
__device__ __forceinline__ void shfl_stage(int (&v)[kPerLane]) {
  if constexpr (D < 32) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = exchange(v[i], __shfl_xor_sync(kFull, v[i], D));
  } else {
    // the partner of (r, 32k + l) is (r, 32 (k ^ D / 32) + l): entry i ^ D / 32
    int w[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) w[i] = exchange(v[i], v[i ^ (D / 32)]);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = w[i];
  }
}

template <int D>
__device__ __forceinline__ void smem_warp_stage(int (&v)[kPerLane], int* buf, int& s,
                                                int lane) {
  int* b = buf + (s & 1) * kTile;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) b[word_of(i, lane)] = v[i];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    v[i] = exchange(v[i], b[(i >> 2) * kLanes + ((32 * (i & 3) + lane) ^ D)]);
  ++s;
}

template <int D>
__device__ __forceinline__ void smem_block_stage(int& v, int (*buf)[kTile], int& s, int t) {
  int* b = buf[s & 1];
  b[t] = v;
  __syncthreads();
  v = exchange(v, b[t ^ D]);  // D < 128: the lane bits of t = r * 128 + l
  ++s;
}

__device__ __forceinline__ void load_lanes(const int* __restrict__ src, int lane,
                                           int (&v)[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = src[word_of(i, lane)];
}

__device__ __forceinline__ void store_lanes(int* __restrict__ dst, int lane,
                                            const int (&v)[kPerLane]) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) dst[word_of(i, lane)] = v[i];
}

__global__ void __launch_bounds__(kShflWarps * 32)
perm_shfl(const int* __restrict__ x, int* __restrict__ out, int tiles, int stages) {
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kShflWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // the whole warp
  int v[kPerLane];
  load_lanes(x + tile * kTile, lane, v);
  PCR_PERM_STAGES(shfl_stage, v);
  store_lanes(out + tile * kTile, lane, v);
}

__global__ void __launch_bounds__(kSmemWarps * 32)
perm_smem_warp(const int* __restrict__ x, int* __restrict__ out, int tiles, int stages) {
  __shared__ int buf[kSmemWarps][2 * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * kSmemWarps + warp;
  if (tile >= tiles) return;  // the whole warp; no block barrier
  int v[kPerLane];
  load_lanes(x + tile * kTile, lane, v);
  int s = 0;
  PCR_PERM_STAGES(smem_warp_stage, v, buf[warp], s, lane);
  store_lanes(out + tile * kTile, lane, v);
}

__global__ void __launch_bounds__(kTile)
perm_smem_block(const int* __restrict__ x, int* __restrict__ out, int stages) {
  __shared__ int buf[2][kTile];
  const int t = threadIdx.x;
  const long long at = static_cast<long long>(blockIdx.x) * kTile + t;
  int v = x[at];
  int s = 0;
  PCR_PERM_STAGES(smem_block_stage, v, buf, s, t);
  out[at] = v;
}

}  // namespace

// `stages` exchange stages of `form` on `tiles` (8, 128) int32 tiles of x
// into out (x and out may not overlap).
extern "C" int pcr_probe_perm(int form, const void* x, void* out, int tiles, int stages,
                              void* stream) {
  if (tiles < 0 || stages < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int*>(x);
  auto* o = static_cast<int*>(out);
  if (form == kShfl)
    perm_shfl<<<(tiles + kShflWarps - 1) / kShflWarps, kShflWarps * 32, 0, s>>>(in, o, tiles,
                                                                                 stages);
  else if (form == kSmemWarp)
    perm_smem_warp<<<(tiles + kSmemWarps - 1) / kSmemWarps, kSmemWarps * 32, 0, s>>>(
        in, o, tiles, stages);
  else if (form == kSmemBlock)
    perm_smem_block<<<tiles, kTile, 0, s>>>(in, o, stages);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
