// The card's counterpart of the TPU probe `experiments/exp_gather.py` (its
// pallas_call at :18, `kern`): a per-lane gather from a 4096-entry table,
// here the table B12 (`csrc/decode_huffman.cu`) reads once per symbol on
// each lane's dependent chain.  B12 stages each batch's table in shared
// memory as (value, length) `int2` pairs and reads one 8-byte entry a
// symbol.  Each lookup here reads entry i of its batch's table and yields
// value + length (u32 sum), so that both halves are used whatever the
// source:
//  - Source: kSmemInt2 (the shipped form: int2 pairs staged in shared
//    memory), kSmemSplit (two int tables staged, two loads), kLdg
//    (`__ldg` of the int2 pair from device memory, through L1);
//  - Pattern: kTpu (one lookup a lane at the given index: the TPU probe's
//    1024 lookups), kRandom (a fresh index a lane and step from a hash of
//    both), kBroadcast (one hashed index a warp and step), kChain (each
//    lane's next index is the low 12 bits of what it just read: B12's
//    dependent chain).  A lane writes the u32 sum of its lookups.
// Lanes are split evenly over the tables (`per_table` lanes each); a
// block's lanes share one table.
//
// Bound: the tables read once and a word a lane written, far below the
// lookups' latency on the chain and their issue elsewhere; the probe
// measures those.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTab = 4096;
enum Source : int { kSmemInt2 = 0, kSmemSplit = 1, kLdg = 2 };
enum Pattern : int { kTpu = 0, kRandom = 1, kBroadcast = 2, kChain = 3 };

// lowbias32, as `experiments/probes.py:mix`
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

template <int S, int P>
__global__ void __launch_bounds__(1024)
gather_kernel(const int2* __restrict__ pairs, const int* __restrict__ val,
              const int* __restrict__ len, const int* __restrict__ idx, int per_table,
              int lanes, int steps, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.x * blockDim.x / per_table;  // the block's table
  const int2* gtab = pairs + static_cast<long long>(t) * kTab;
  if constexpr (S == kSmemInt2) {
    int2* tab = reinterpret_cast<int2*>(smem);
    for (int i = threadIdx.x; i < kTab; i += blockDim.x) tab[i] = gtab[i];
  } else if constexpr (S == kSmemSplit) {
    for (int i = threadIdx.x; i < kTab; i += blockDim.x) {
      smem[i] = val[static_cast<long long>(t) * kTab + i];
      smem[kTab + i] = len[static_cast<long long>(t) * kTab + i];
    }
  }
  if constexpr (S != kLdg) __syncthreads();
  if (lane >= lanes) return;
  auto lookup = [&](uint32_t i) -> uint32_t {
    if constexpr (S == kSmemInt2) {
      const int2 e = reinterpret_cast<const int2*>(smem)[i];
      return static_cast<uint32_t>(e.x) + static_cast<uint32_t>(e.y);
    } else if constexpr (S == kSmemSplit) {
      return static_cast<uint32_t>(smem[i]) + static_cast<uint32_t>(smem[kTab + i]);
    } else {
      const int2 e = __ldg(gtab + i);
      return static_cast<uint32_t>(e.x) + static_cast<uint32_t>(e.y);
    }
  };
  uint32_t acc = 0;
  if constexpr (P == kTpu) {
    acc = lookup(static_cast<uint32_t>(idx[lane]) & (kTab - 1));
  } else if constexpr (P == kChain) {
    uint32_t i = mix(static_cast<uint32_t>(lane)) & (kTab - 1);
    for (int s = 0; s < steps; ++s) {
      const uint32_t r = lookup(i);
      acc += r;
      i = r & (kTab - 1);
    }
  } else {
    const uint32_t key = P == kRandom ? static_cast<uint32_t>(lane)
                                      : static_cast<uint32_t>(lane >> 5);
    for (int s = 0; s < steps; ++s) acc += lookup(mix(key * 256u + s) & (kTab - 1));
  }
  out[lane] = acc;
}

template <int S, int P>
int launch(const void* pairs, const void* val, const void* len, const void* idx,
           int per_table, int lanes, int steps, int threads, void* out, cudaStream_t s) {
  const int blocks = (lanes + threads - 1) / threads;
  const int bytes = S == kLdg ? 0 : kTab * 8;
  gather_kernel<S, P><<<blocks, threads, bytes, s>>>(
      static_cast<const int2*>(pairs), static_cast<const int*>(val),
      static_cast<const int*>(len), static_cast<const int*>(idx), per_table, lanes, steps,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PCR_GATHER_CASE(S, P) \
  if (source == (S) && pattern == (P)) \
    return launch<(S), (P)>(pairs, val, len, idx, per_table, lanes, steps, threads, out, s);

// lanes lookups chains of `steps` (kTpu: 1) over lanes / per_table tables
// of kTab (value, length) entries, as `pairs` (int2) and as `val` and
// `len` (int each); blocks of `threads`, each inside one table's lanes.
extern "C" int pcr_probe_gather(int source, int pattern, const void* pairs, const void* val,
                                const void* len, const void* idx, int per_table, int lanes,
                                int steps, int threads, void* out, void* stream) {
  if (threads < 32 || threads > 1024 || per_table % threads || lanes % per_table)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  PCR_GATHER_CASE(kSmemInt2, kTpu);
  PCR_GATHER_CASE(kSmemInt2, kRandom);
  PCR_GATHER_CASE(kSmemInt2, kBroadcast);
  PCR_GATHER_CASE(kSmemInt2, kChain);
  PCR_GATHER_CASE(kSmemSplit, kTpu);
  PCR_GATHER_CASE(kSmemSplit, kRandom);
  PCR_GATHER_CASE(kSmemSplit, kBroadcast);
  PCR_GATHER_CASE(kSmemSplit, kChain);
  PCR_GATHER_CASE(kLdg, kTpu);
  PCR_GATHER_CASE(kLdg, kRandom);
  PCR_GATHER_CASE(kLdg, kBroadcast);
  PCR_GATHER_CASE(kLdg, kChain);
  return static_cast<int>(cudaErrorInvalidValue);
}
