// The card's counterpart of the TPU probe `experiments/r4_pwin.py` (its
// pallas_calls at :322, the production merge on its window table, and
// :373, fixed 1024-entry position windows): B3 (`csrc/raster.cu`) with
// tiles cut per part (shipped) against tiles cut at fixed positions of a
// launch's parts laid end to end.  The instances of `probes.cuh`'s
// b3_probe that `r4_pwin.py` launches, all of them the full kernel at the
// shipped widths: per-part (kStaged) and position (kPosition), in both
// layouts.  The card builds no window table: the tiles are counted on
// the host (`make_parts`), which `pcr_probe_pwin_tiles` reports.

#include "probes.cuh"

extern "C" int pcr_probe_pwin(int layout, int lesion, int width, int form,
                              const void* const* pid, const void* const* dep,
                              const void* const* pay, const long long* n, int count,
                              void* plane, int size, void* sums, void* stream) {
  using namespace probes;
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kStaged);
  PCR_B3_FORM(tiles::kChain, kFullB3, 16, kPosition);
  PCR_B3_FORM(tiles::kFlat, kFullB3, 8, kStaged);
  PCR_B3_FORM(tiles::kFlat, kFullB3, 8, kPosition);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tiles one launch of pcr_probe_pwin reads over `count` (1..64) parts
// of n entries at the shipped widths, as `make_parts` counts them; -1 if
// out of range.
extern "C" long long pcr_probe_pwin_tiles(int layout, int form, const long long* n, int count) {
  if (count < 1 || count > tiles::kMaxParts || (layout != tiles::kChain && layout != tiles::kFlat))
    return -1;
  if (form == probes::kPosition)
    return layout == tiles::kChain ? probes::position_tiles<tiles::kChain>(n, count)
                                   : probes::position_tiles<tiles::kFlat>(n, count);
  long long total = 0;
  for (int p = 0; p < count; ++p) total += tiles::part_tiles(n[p], layout);
  return total;
}
