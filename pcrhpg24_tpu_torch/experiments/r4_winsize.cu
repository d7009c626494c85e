// The card's counterpart of the TPU probe `experiments/r4_winsize.py`
// (its pallas_call at :214): B3 (`csrc/raster.cu`) at other tile widths.
// The instances of `probes.cuh`'s b3_probe that `r4_winsize.py`
// launches, all of them the full kernel: chain tiles of 16 (shipped), 8
// and 4 columns; flat passes of 8 (shipped) and 4 columns.

#include "probes.cuh"

extern "C" int pcr_probe_winsize(int layout, int lesion, int width, const void* const* pid,
                                 const void* const* dep, const void* const* pay,
                                 const long long* n, int count, void* plane, int size,
                                 void* sums, void* stream) {
  using namespace probes;
  PCR_B3_CASE(tiles::kChain, kFullB3, 16);
  PCR_B3_CASE(tiles::kChain, kFullB3, 8);
  PCR_B3_CASE(tiles::kChain, kFullB3, 4);
  PCR_B3_CASE(tiles::kFlat, kFullB3, 8);
  PCR_B3_CASE(tiles::kFlat, kFullB3, 4);
  return static_cast<int>(cudaErrorInvalidValue);
}
