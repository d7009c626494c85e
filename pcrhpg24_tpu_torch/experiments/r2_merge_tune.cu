// The card's counterpart of the TPU probes of B6's merge: what each of its
// stages costs when it alone is cut (`experiments/r2_merge_tune.py`, its
// pallas_call at :124), its cost built up (`r3_kernel_floor.py`, :169),
// its scan depth (`r3_build_v2.py`, :118), its work a loop body and its
// DMA ring (`r3_merge_micro.py`, :95) and its op cuts
// (`r3_merge_micro2.py`, :289).  Every instance of `csrc/merge.cuh`'s
// merge_nk1 that those five modules launch, under one C symbol
// (`experiments/probes.py:B6` names the template values):
//  - r2_merge_tune, r3_kernel_floor: full (the shipped kernel), no-scan
//    (0 doubling steps), no-atomic, read-only, the grid alone, and full
//    on interleaved (pid, dep, pay, 0) rows;
//  - r3_build_v2: 0 to 5 doubling steps;
//  - r3_merge_micro: 1, 2, 4 and 8 groups a warp with direct loads;
//    rings of 2, 4 and 8 stages at 1 and 4 groups;
//  - r3_merge_micro2: uniform, distinct, early, gather-first, all four
//    at 5 steps and at 4, and the count lesion with no cut and with
//    gather-first (the atomics it saves).

#include "probes.cuh"

extern "C" int pcr_probe_b6(int lesion, int steps, int groups, int stages, int load, int cut,
                            int head, const void* pid, const void* dep, const void* pay,
                            void* plane, long long n, int size, void* sums, void* stream) {
  using namespace b6;
  constexpr int kAll = kUniform | kDistinct | kEarly | kGatherFirst;
  // stage lesions, anatomy and loads
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kNoAtomic, 5, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kReadOnly, 5, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kGrid, 5, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 0, kInterleaved, 0, kWarpHeads);
  // scan depth (0: no-scan)
  PCR_B6_CASE(kWhole, 0, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 1, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 2, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 3, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 4, 1, 0, kArrays, 0, kWarpHeads);
  // groups a warp x cp.async ring stages
  PCR_B6_CASE(kWhole, 5, 2, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 4, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 8, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 2, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 4, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 8, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 4, 2, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 4, 4, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 4, 8, kArrays, 0, kWarpHeads);
  // instruction cuts, and the atomics counted
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, kUniform, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, kDistinct, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, kEarly, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, kGatherFirst, kWarpHeads);
  PCR_B6_CASE(kWhole, 5, 1, 0, kArrays, kAll, kWarpHeads);
  PCR_B6_CASE(kWhole, 4, 1, 0, kArrays, kAll, kWarpHeads);
  PCR_B6_CASE(kCount, 5, 1, 0, kArrays, 0, kWarpHeads);
  PCR_B6_CASE(kCount, 5, 1, 0, kArrays, kGatherFirst, kWarpHeads);
  return static_cast<int>(cudaErrorInvalidValue);
}
