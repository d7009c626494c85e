// The card's counterpart of the TPU probe `experiments/r3_decode_ilp.py` (its
// pallas_call at :141, `_kernel_v2`): does B1 gain from unrolling its point
// loop, or from computing its ranks before the loop?  B1's kernel
// (`csrc/decode_fixed.cuh`) at each (unroll, ahead) pair: (0, false) is the
// shipped instance (a run-time trip count, not unrolled, three ballots a
// round for the rank); unroll N > 0 runs the 64 rounds as a loop of known
// trip count under `#pragma unroll N`; ahead takes each chain's own-lane
// ranks of all 64 rounds from shared memory, computed before the loop.
// Bound and design: the header's notes.

#include "decode_fixed.cuh"

#define PCR_B1_CASE(U, A)                                                                  \
  if (unroll == (U) && (ahead != 0) == (A))                                                \
    return b1::launch<(U), (A)>(widths, streams, ptrs, starts, out, batches, maxt, points, \
                                stream);

extern "C" int pcr_probe_b1(int unroll, int ahead, const void* widths, const void* streams,
                            const void* ptrs, const void* starts, void* out, int batches,
                            int maxt, int points, void* stream) {
  if (unroll != 0 && points != b1::kRounds) return static_cast<int>(cudaErrorInvalidValue);
  PCR_B1_CASE(0, false);
  PCR_B1_CASE(2, false);
  PCR_B1_CASE(4, false);
  PCR_B1_CASE(8, false);
  PCR_B1_CASE(64, false);
  PCR_B1_CASE(0, true);
  PCR_B1_CASE(2, true);
  PCR_B1_CASE(4, true);
  PCR_B1_CASE(8, true);
  PCR_B1_CASE(64, true);
  return static_cast<int>(cudaErrorInvalidValue);
}
