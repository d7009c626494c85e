// B5: tbatch (`.tpc` v1, canonical bucket-Huffman) geometry decode for
// Hopper (sm_90a): the shipped instance of the kernel in
// `decode_native.cuh` (which holds its design notes and its variants).
//
// Replaces the Pallas TPU kernel `_decode_kernel_impl`
// (pcrhpg24_tpu/render/pallas_decode.py:55, launched by
// `decode_native_batches` at :169/:188).

#include "decode_native.cuh"

extern "C" int pcr_decode_native(const void* lj, const void* streams,
                                 const void* ptrs, const void* lut,
                                 const void* starts, void* out, int batches,
                                 int maxw, int points, void* stream) {
  return b5::launch<b5::kFull>(lj, streams, ptrs, lut, starts, out, batches, maxw, points,
                               stream);
}
