// The card's counterpart of the TPU probe `experiments/r3_mat_lesion.py`
// (its pallas_call at :255): which stage of B3 (`csrc/raster.cu`) takes
// the time.  The instances of `probes.cuh`'s b3_probe that
// `r3_mat_lesion.py` launches: every lesion in both layouts, each at the
// shipped width (chain tiles of 16 columns, flat passes of 8).

#include "probes.cuh"

extern "C" int pcr_probe_lesion(int layout, int lesion, int width, const void* const* pid,
                                const void* const* dep, const void* const* pay,
                                const long long* n, int count, void* plane, int size,
                                void* sums, void* stream) {
  using namespace probes;
  PCR_B3_CASE(tiles::kChain, kFullB3, 16);
  PCR_B3_CASE(tiles::kChain, kAtomicAll, 16);
  PCR_B3_CASE(tiles::kChain, kNoAtomic, 16);
  PCR_B3_CASE(tiles::kChain, kFloor, 16);
  PCR_B3_CASE(tiles::kChain, kNoLoad, 16);
  PCR_B3_CASE(tiles::kChain, kCount, 16);
  PCR_B3_CASE(tiles::kFlat, kFullB3, 8);
  PCR_B3_CASE(tiles::kFlat, kAtomicAll, 8);
  PCR_B3_CASE(tiles::kFlat, kNoAtomic, 8);
  PCR_B3_CASE(tiles::kFlat, kFloor, 8);
  PCR_B3_CASE(tiles::kFlat, kNoLoad, 8);
  PCR_B3_CASE(tiles::kFlat, kCount, 8);
  return static_cast<int>(cudaErrorInvalidValue);
}
