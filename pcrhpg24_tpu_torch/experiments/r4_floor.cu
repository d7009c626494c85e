// The card's counterpart of the TPU probe `experiments/r4_floor.py` (its
// pallas_call at :222): what one chain tile of B3 (`csrc/raster.cu`)
// costs.  The instances of `probes.cuh`'s b3_probe that `r4_floor.py`
// launches, in the chain layout at its 16 columns: noop (the grid and
// the tile's part lookup), prep (+ `tiles::load_tile`'s staging and
// transpose: the floor lesion), full, nodma (full on tiles made in
// registers: the no-load lesion).

#include "probes.cuh"

extern "C" int pcr_probe_floor(int layout, int lesion, int width, const void* const* pid,
                               const void* const* dep, const void* const* pay,
                               const long long* n, int count, void* plane, int size,
                               void* sums, void* stream) {
  using namespace probes;
  PCR_B3_CASE(tiles::kChain, kNoop, 16);
  PCR_B3_CASE(tiles::kChain, kFloor, 16);
  PCR_B3_CASE(tiles::kChain, kFullB3, 16);
  PCR_B3_CASE(tiles::kChain, kNoLoad, 16);
  return static_cast<int>(cudaErrorInvalidValue);
}
