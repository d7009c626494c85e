// B1: fbatch (`.tpc` v2, fixed-width) geometry decode for Hopper (sm_90a):
// the shipped instance of the kernel in `decode_fixed.cuh` (which holds
// its design notes and its variants).
//
// Replaces the Pallas TPU kernel `_decode_fixed_kernel`
// (pcrhpg24_tpu/render/pallas_decode_fixed.py:52, launched by
// `decode_fixed_batches` at :162/:172).

#include "decode_fixed.cuh"

extern "C" int pcr_decode_fixed(const void* widths, const void* streams,
                                const void* ptrs, const void* starts,
                                void* out, int batches, int maxt, int points,
                                void* stream) {
  return b1::launch<0, false>(widths, streams, ptrs, starts, out, batches, maxt, points,
                              stream);
}
