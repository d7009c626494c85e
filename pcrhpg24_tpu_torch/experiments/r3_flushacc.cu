// The card's counterpart of the TPU probe `experiments/r3_flushacc.py`
// (its pallas_call at :263): the TPU probe folded a window's results into
// one accumulator pair before flushing them, instead of updating every
// tile's; here a warp's same-pixel keys are combined before one
// atomicMin.  The instances of `probes.cuh`'s b3_probe that
// `r3_flushacc.py` launches, in both layouts at the shipped widths: full,
// no-atomic and count (the shipped compare-then-atomicMin and its
// counts), combine, combine-count and combine-would-be.

#include "probes.cuh"

extern "C" int pcr_probe_combine(int layout, int lesion, int width, int form,
                                 const void* const* pid, const void* const* dep,
                                 const void* const* pay, const long long* n, int count,
                                 void* plane, int size, void* sums, void* stream) {
  using namespace probes;
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kNoAtomic, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kCount, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kCombine, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kCombineCount, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kCombineWouldBe, 16, kStaged);
  PCR_B3_FORM(tiles::kFlat, kFullB3, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kNoAtomic, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kCount, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kCombine, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kCombineCount, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kCombineWouldBe, 8, kStaged);
  return static_cast<int>(cudaErrorInvalidValue);
}
