// The card's counterpart of the TPU probes `experiments/r3_i8dot.py` (its
// pallas_call at :240) and `r3_p4dot.py` (:238): the TPU probes scattered
// the (depth, payload) key through narrower planes (int8 nibbles, 16-bit
// f32 planes) in their matmuls; here B3's key is narrowed in what it
// gathers and in the width of its atomic.  The instances of `probes.cuh`'s
// b3_probe that both modules launch, in both layouts at the shipped
// widths: u64 (the full kernel), the two passes of two-pass (a u32 depth
// atomicMin, then a payload atomicMin for the entries at their pixel's
// depth, `r3_i8dot.py`) and half-gather (a 4-byte depth gather before the
// u64 atomicMin, `r3_p4dot.py`).

#include "probes.cuh"

extern "C" int pcr_probe_narrow(int layout, int lesion, int width, int form,
                                const void* const* pid, const void* const* dep,
                                const void* const* pay, const long long* n, int count,
                                void* plane, int size, void* sums, void* stream) {
  using namespace probes;
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kDepthPass, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kPayPass, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kHalfGather, 16, kStaged);
  PCR_B3_FORM(tiles::kFlat, kFullB3, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kDepthPass, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kPayPass, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kHalfGather, 8, kStaged);
  return static_cast<int>(cudaErrorInvalidValue);
}
