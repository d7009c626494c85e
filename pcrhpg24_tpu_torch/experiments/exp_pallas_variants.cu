// The card's counterpart of the TPU probe `experiments/exp_pallas_variants.py`
// (its pallas_call at :118, `mk_kernel(variant).kern`; chained by slope in
// `experiments/exp_variant_slope.py:30`): which stage of B5 takes the time.
// B5's kernel (`csrc/decode_native.cuh`) at each variant of `b5::Variant`:
// `kFull` is the shipped instance, the others cut a stage out or do it
// another way.  Bound and design: the header's notes.

#include "decode_native.cuh"

extern "C" int pcr_probe_b5(int variant, const void* lj, const void* streams,
                            const void* ptrs, const void* lut, const void* starts,
                            void* out, int batches, int maxw, int points, void* stream) {
  switch (variant) {
    case b5::kFull:
      return b5::launch<b5::kFull>(lj, streams, ptrs, lut, starts, out, batches, maxw, points,
                                   stream);
    case b5::kLadder:
      return b5::launch<b5::kLadder>(lj, streams, ptrs, lut, starts, out, batches, maxw,
                                     points, stream);
    case b5::kRankScan:
      return b5::launch<b5::kRankScan>(lj, streams, ptrs, lut, starts, out, batches, maxw,
                                       points, stream);
    case b5::kNoTable:
      return b5::launch<b5::kNoTable>(lj, streams, ptrs, lut, starts, out, batches, maxw,
                                      points, stream);
    case b5::kNoWindow:
      return b5::launch<b5::kNoWindow>(lj, streams, ptrs, lut, starts, out, batches, maxw,
                                       points, stream);
    case b5::kNoRefill:
      return b5::launch<b5::kNoRefill>(lj, streams, ptrs, lut, starts, out, batches, maxw,
                                       points, stream);
    case b5::kNoRefillNoTable:
      return b5::launch<b5::kNoRefillNoTable>(lj, streams, ptrs, lut, starts, out, batches,
                                              maxw, points, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
