// The card's counterpart of the TPU probe `experiments/r3_corient.py` (its
// pallas_call at :254): the chain tile of B3 (`csrc/raster.cu`) read
// without the shared-memory staging and transpose of `tiles::load_tile`.
// The TPU probe built its one-hot in the orientation that needs no
// (8,128)->(128,8) transpose; here the transpose is the staging itself.
// The instances of `probes.cuh`'s b3_probe that `r3_corient.py` launches,
// all of them the full kernel in the chain layout at 16 columns: staged
// (the shipped loads), rowload (lane l reads its own row, 16-byte
// loads) and shfl (the shipped coalesced loads, then a register
// transpose by shuffles), and the last two 8 columns a pass.

#include "probes.cuh"

extern "C" int pcr_probe_corient(int layout, int lesion, int width, int form,
                                 const void* const* pid, const void* const* dep,
                                 const void* const* pay, const long long* n, int count,
                                 void* plane, int size, void* sums, void* stream) {
  using namespace probes;
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kRowLoad);
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kShflLoad);
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kRowLoad8);
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kShflLoad8);
  return static_cast<int>(cudaErrorInvalidValue);
}
