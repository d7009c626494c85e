// The card's counterpart of the TPU probe `experiments/r3_rows_prefix.py`
// (its pallas_call at :146: B6's merge after a sort in 64 rows, and after
// table builds over each row's live prefix): what to sort in front of B6.
// `pcr_probe_compact` writes the live entries (pid < size) of a stream to
// a dense prefix in one pass, so that the sort takes those alone.  One
// thread per entry: a warp's `__ballot_sync` of its live lanes, one
// `atomicAdd` a warp on the running count for its output offset, then
// each live lane stores its entry at that offset plus its rank among the
// warp's live lanes.  Order is not kept (a sort follows).  Bound:
// device-memory bytes, 12 B read an entry and 12 B written a live one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void compact_kernel(const uint32_t* __restrict__ pid,
                               const uint32_t* __restrict__ dep,
                               const uint32_t* __restrict__ pay, uint32_t* __restrict__ out_pid,
                               uint32_t* __restrict__ out_dep, uint32_t* __restrict__ out_pay,
                               unsigned long long* __restrict__ count, long long n,
                               uint32_t size) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t q = i < n ? pid[i] : 0xffffffffu;
  const bool live = q < size;
  const unsigned mask = __ballot_sync(kFull, live);
  unsigned long long base = 0;
  if (lane == 0 && mask) base = atomicAdd(count, static_cast<unsigned long long>(__popc(mask)));
  base = __shfl_sync(kFull, base, 0);
  if (live) {
    const unsigned long long at = base + __popc(mask & ((1u << lane) - 1u));
    out_pid[at] = q;
    out_dep[at] = dep[i];
    out_pay[at] = pay[i];
  }
}

}  // namespace

// count: one u64, zeroed by the caller; the outputs hold n entries.
extern "C" int pcr_probe_compact(const void* pid, const void* dep, const void* pay,
                                 void* out_pid, void* out_dep, void* out_pay, void* count,
                                 long long n, int size, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks == 0) return 0;
  compact_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pid), static_cast<const uint32_t*>(dep),
      static_cast<const uint32_t*>(pay), static_cast<uint32_t*>(out_pid),
      static_cast<uint32_t*>(out_dep), static_cast<uint32_t*>(out_pay),
      static_cast<unsigned long long*>(count), n, static_cast<uint32_t>(size));
  return static_cast<int>(cudaGetLastError());
}
