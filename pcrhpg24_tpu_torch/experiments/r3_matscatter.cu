// The card's counterpart of the TPU probe `experiments/r3_matscatter.py`
// (its pallas_calls at :237, the matscatter merge over rows sorted by the
// full key, and :294, B6 with no suffix-min on the same rows): after a
// sort by (pid, dep, pay), each run's first entry is its pixel's minimum.
// The instances of `csrc/merge.cuh`'s merge_nk1 that `r3_matscatter.py`
// launches: atomic-head (B6 with no scan: each warp-local head's own key,
// one atomicMin) and store-head (each head of a run of the whole stream,
// one plain u64 store).

#include "probes.cuh"

extern "C" int pcr_probe_heads(int lesion, int steps, int groups, int stages, int load,
                               int cut, int head, const void* pid, const void* dep,
                               const void* pay, void* plane, long long n, int size,
                               void* sums, void* stream) {
  using namespace b6;
  PCR_B6_CASE(kWhole, 0, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 0, 1, 0, kArrays, 0, kRunHeads);
  return static_cast<int>(cudaErrorInvalidValue);
}
