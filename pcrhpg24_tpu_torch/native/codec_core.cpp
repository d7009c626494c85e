// Native preprocessor core: per-batch bitstream packing + stream interleave
// for the reference `.huffman` layout (the 32-lane warp interleave,
// phantom-exact) and the two `.tpc` layouts (the 128-lane group interleave
// of the tbatch codec, with per-round pointers, and the fixed-width fbatch
// codec); the `.huffman` batch decoder; and the fused `.huffman` -> fbatch
// transcode of the load-time path.  The port's copy of
// pcrhpg24_tpu/native/codec_core.cpp; the NumPy implementations in
// pcrhpg24_tpu_torch/codec/ are the specification, and this library
// produces byte-identical streams.
//
// Built with g++ at first use by pcrhpg24_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int kLanesPerWarp = 32;
constexpr int kWarpsPerBatch = 32;
constexpr int kLanesPerGroup = 128;
constexpr int kGroupsPerBatch = 8;
constexpr int kSymsPerLane = 192;
constexpr int kLanes = 1024;

// MSB-first packing of (value,nbits) pairs; values may span 3 words.
struct BitPacker {
  std::vector<uint32_t> words;
  int64_t pos = 0;

  void reserve_bits(int64_t total) { words.assign((total + 31) / 32 + 2, 0); }

  inline void push(uint64_t value, int nbits) {
    int w0 = int(pos >> 5);
    int off = int(pos & 31);
    // place value's msb at bit (95 - off) of a 96-bit window
    unsigned __int128 chunk = (unsigned __int128)value << (96 - off - nbits);
    words[w0] |= uint32_t(chunk >> 64);
    words[w0 + 1] |= uint32_t(chunk >> 32);
    words[w0 + 2] |= uint32_t(chunk);
    pos += nbits;
  }

  void finish() { words.resize((pos + 31) / 32); }
};

inline int bitlen_u64(uint64_t z) {
  return z == 0 ? 0 : 64 - __builtin_clzll(z);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// TPU-native (tbatch) encoder
// ---------------------------------------------------------------------------
// deltas:        1024*192 int32 (lane-major interleaved x y z)
// bucket_codes:  33 uint32 canonical codes (index = bucket)
// bucket_lens:   33 int32 code lengths
// out_stream:    kGroupsPerBatch * maxw uint32 (zero-filled by callee)
// out_group_len: 8 int32
// out_ptrs:      384*8 int32 round pointers
// returns 0 on success, -1 if a group stream exceeds maxw.
int encode_native_batch(const int32_t* deltas, const uint32_t* bucket_codes,
                        const int32_t* bucket_lens, uint32_t* out_stream,
                        int32_t* out_group_len, int32_t* out_ptrs,
                        int64_t maxw) {
  for (int g = 0; g < kGroupsPerBatch; ++g) {
    // 1) per-lane bitstreams
    std::vector<BitPacker> lanes(kLanesPerGroup);
    std::vector<std::vector<int>> consume(kLanesPerGroup);
    for (int l = 0; l < kLanesPerGroup; ++l) {
      int lane = g * kLanesPerGroup + l;
      const int32_t* d = deltas + (int64_t)lane * kSymsPerLane;
      int64_t total = 0;
      consume[l].resize(2 * kSymsPerLane);
      for (int i = 0; i < kSymsPerLane; ++i) {
        uint64_t z = (uint64_t)((int64_t(d[i]) << 1) ^ (int64_t(d[i]) >> 63));
        int b = bitlen_u64(z);
        int e = b > 0 ? b - 1 : 0;
        consume[l][2 * i] = bucket_lens[b];
        consume[l][2 * i + 1] = e;
        total += bucket_lens[b] + e;
      }
      lanes[l].reserve_bits(total);
      for (int i = 0; i < kSymsPerLane; ++i) {
        uint64_t z = (uint64_t)((int64_t(d[i]) << 1) ^ (int64_t(d[i]) >> 63));
        int b = bitlen_u64(z);
        int e = b > 0 ? b - 1 : 0;
        uint64_t extra = b > 0 ? z - (1ULL << (b - 1)) : 0;
        uint64_t val = ((uint64_t)bucket_codes[b] << e) | extra;
        lanes[l].push(val, bucket_lens[b] + e);
      }
      lanes[l].finish();
    }
    // 2) protocol simulation: allocate words in request order
    std::vector<uint32_t> out;
    out.reserve(maxw);
    for (int l = 0; l < kLanesPerGroup; ++l)
      out.push_back(lanes[l].words.size() > 0 ? lanes[l].words[0] : 0);
    for (int l = 0; l < kLanesPerGroup; ++l)
      out.push_back(lanes[l].words.size() > 1 ? lanes[l].words[1] : 0);

    std::vector<int> bitpos(kLanesPerGroup, 0), widx(kLanesPerGroup, 2);
    for (int i = 0; i < kSymsPerLane; ++i) {
      for (int r = 0; r < 2; ++r) {
        int t = 2 * i + r;
        out_ptrs[(int64_t)t * kGroupsPerBatch + g] = (int32_t)out.size();
        for (int l = 0; l < kLanesPerGroup; ++l) {
          bitpos[l] += consume[l][t];
          if (bitpos[l] >= 32) {
            bitpos[l] -= 32;
            int w = widx[l]++;
            out.push_back(w < (int)lanes[l].words.size() ? lanes[l].words[w]
                                                        : 0);
          }
        }
      }
    }
    if ((int64_t)out.size() > maxw) return -1;
    out_group_len[g] = (int32_t)out.size();
    std::memcpy(out_stream + (int64_t)g * maxw, out.data(),
                out.size() * sizeof(uint32_t));
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Reference-format (.huffman) encoder
// ---------------------------------------------------------------------------
// deltas:      1024*192 int32
// sym_keys:    nsym int32 sorted distinct symbols
// sym_codes:   nsym uint32 codewords
// sym_lens:    nsym int32 signed lengths (negative = escape)
// outputs (caller-allocated, sizes returned):
//   out_encoding   (cap_enc u32), returns total via *enc_len
//   out_separate   (cap_sep i32), *sep_len
//   out_sep_sizes  1024 i32 inclusive prefix
//   out_cluster    32 i32 inclusive prefix word counts
int encode_ref_batch(const int32_t* deltas, const int32_t* sym_keys,
                     const uint32_t* sym_codes, const int32_t* sym_lens,
                     int64_t nsym, uint32_t* out_encoding, int64_t cap_enc,
                     int64_t* enc_len, int32_t* out_separate, int64_t cap_sep,
                     int64_t* sep_len, int32_t* out_sep_sizes,
                     int32_t* out_cluster) {
  int64_t enc_cursor = 0, sep_cursor = 0;
  for (int warp = 0; warp < kWarpsPerBatch; ++warp) {
    std::vector<std::vector<uint32_t>> words(kLanesPerWarp);
    std::vector<std::vector<int64_t>> bitcsum(kLanesPerWarp);
    for (int l = 0; l < kLanesPerWarp; ++l) {
      int lane = warp * kLanesPerWarp + l;
      const int32_t* d = deltas + (int64_t)lane * kSymsPerLane;
      BitPacker bp;
      int64_t total = 0;
      bitcsum[l].resize(kSymsPerLane);
      std::vector<int> lens(kSymsPerLane);
      for (int i = 0; i < kSymsPerLane; ++i) {
        // binary search symbol
        const int32_t* it =
            std::lower_bound(sym_keys, sym_keys + nsym, d[i]);
        int64_t idx = it - sym_keys;
        int sl = sym_lens[idx];
        lens[i] = sl < 0 ? -sl : sl;
        total += lens[i];
        bitcsum[l][i] = total;
      }
      bp.reserve_bits(total);
      int64_t sep_here = 0;
      for (int i = 0; i < kSymsPerLane; ++i) {
        const int32_t* it =
            std::lower_bound(sym_keys, sym_keys + nsym, d[i]);
        int64_t idx = it - sym_keys;
        if (sym_lens[idx] < 0) {
          if (sep_cursor + sep_here >= cap_sep) return -2;
          out_separate[sep_cursor + sep_here] = d[i];
          sep_here++;
        }
        bp.push(sym_codes[idx], lens[i]);
      }
      bp.finish();
      words[l] = std::move(bp.words);
      sep_cursor += sep_here;
      out_sep_sizes[lane] = (int32_t)sep_cursor;
    }
    // phantom-exact interleave (warp_interleave.py semantics)
    struct Req {
      int key, tid, widx;
    };
    std::vector<Req> reqs;
    for (int l = 0; l < kLanesPerWarp; ++l) {
      int64_t total = bitcsum[l].back();
      int64_t n_req = total / 32;
      int64_t j = 1;
      int sym = 0;
      for (; j <= n_req; ++j) {
        // first symbol index with cumulative bits >= 32*j
        while (sym < kSymsPerLane && bitcsum[l][sym] < 32 * j) ++sym;
        reqs.push_back({sym + 1, l, (int)(j + 1)});
      }
    }
    std::stable_sort(reqs.begin(), reqs.end(), [](const Req& a, const Req& b) {
      if (a.key != b.key) return a.key < b.key;
      if (a.tid != b.tid) return a.tid < b.tid;
      return a.widx < b.widx;
    });
    // emit: head (w0 per lane, w1 per lane) then requests
    int64_t warp_words = 0;
    auto emit = [&](uint32_t w) -> int {
      if (enc_cursor >= cap_enc) return -1;
      out_encoding[enc_cursor++] = w;
      warp_words++;
      return 0;
    };
    for (int l = 0; l < kLanesPerWarp; ++l)
      if (emit(words[l].size() > 0 ? words[l][0] : 0)) return -3;
    for (int l = 0; l < kLanesPerWarp; ++l)
      if (emit(words[l].size() > 1 ? words[l][1] : 0)) return -3;
    for (auto& r : reqs) {
      uint32_t w =
          r.widx < (int)words[r.tid].size() ? words[r.tid][r.widx] : 0;
      if (emit(w)) return -3;
    }
    out_cluster[warp] =
        (int32_t)(warp == 0 ? warp_words : out_cluster[warp - 1] + warp_words);
  }
  *enc_len = enc_cursor;
  *sep_len = sep_cursor;
  return 0;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Reference-format (.huffman) batch DECODER
// ---------------------------------------------------------------------------
// Mirror of the GPU warp decoder semantics (the same protocol the Python
// codec/batch_codec.py decode_batch implements): two-word lookahead per
// lane, ballot-ordered refills, 4096-entry table with negative-length
// escape entries.
// encoding:    E u32 warp-interleaved words (batch-local)
// cluster:     32 i32 inclusive prefix word counts (warp stream ends)
// separate:    S i32 escape values
// sep_sizes:   1024 i32 inclusive prefix escape counts
// tval/tlen:   4096 i32 decoder table
// out_deltas:  1024*192 i32
int decode_ref_batch(const uint32_t* encoding, int64_t e_len,
                     const int32_t* cluster, const int32_t* separate,
                     const int32_t* sep_sizes, const int32_t* tval,
                     const int32_t* tlen, int32_t* out_deltas) {
  const int kMaxCw = 12;
  for (int warp = 0; warp < kWarpsPerBatch; ++warp) {
    int64_t base = warp == 0 ? 0 : cluster[warp - 1];
    auto word = [&](int64_t i) -> uint32_t {
      int64_t idx = base + i;
      return idx < e_len ? encoding[idx] : 0u;
    };
    uint32_t cur[kLanesPerWarp], nxt[kLanesPerWarp];
    int cur_bits[kLanesPerWarp];
    int64_t sep_ptr[kLanesPerWarp];
    for (int l = 0; l < kLanesPerWarp; ++l) {
      cur[l] = word(l);
      nxt[l] = word(kLanesPerWarp + l);
      cur_bits[l] = 32;
      int lane = warp * kLanesPerWarp + l;
      sep_ptr[l] = lane == 0 ? 0 : sep_sizes[lane - 1];
    }
    int64_t already = 2 * kLanesPerWarp;
    for (int i = 0; i < kSymsPerLane; ++i) {
      bool need[kLanesPerWarp];
      for (int l = 0; l < kLanesPerWarp; ++l) {
        uint32_t L = cur_bits[l] == 32 ? cur[l]
                                       : (cur[l] << (32 - cur_bits[l]));
        uint32_t R = cur_bits[l] == 32 ? 0u : (nxt[l] >> cur_bits[l]);
        uint32_t key = (L | R) >> (32 - kMaxCw);
        int sl = tlen[key];
        int lane = warp * kLanesPerWarp + l;
        int32_t sym = sl > 0 ? tval[key] : separate[sep_ptr[l]++];
        out_deltas[(int64_t)lane * kSymsPerLane + i] = sym;
        cur_bits[l] -= sl < 0 ? -sl : sl;
        need[l] = cur_bits[l] <= 0;
      }
      int64_t offs = 0;
      for (int l = 0; l < kLanesPerWarp; ++l) {
        if (need[l]) {
          cur[l] = nxt[l];
          nxt[l] = word(already + offs);
          cur_bits[l] += 32;
          offs++;
        }
      }
      already += offs;
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// TPU-native fixed-width (fbatch, .tpc v2) encoder — codec/fixed.py mirror
// ---------------------------------------------------------------------------
// deltas:      1024*192 int32 (lane-major interleaved x y z)
// out_widths:  1024*3 uint8 per-chain component bit widths
// out_stream:  kGroupsPerBatch * maxw uint32 (zero-filled by callee)
// out_nwords:  int64 (per-group padded stream length)
// out_ptrs:    64 int32 uniform round base word index
// returns 0 on success, -1 if the stream exceeds maxw.
int encode_fixed_batch(const int32_t* deltas, uint8_t* out_widths,
                       uint32_t* out_stream, int64_t* out_nwords,
                       int32_t* out_ptrs, int64_t maxw) {
  constexpr int kPts = 64;
  static_assert(kSymsPerLane == kPts * 3, "layout");

  std::vector<int> W(kLanes);
  std::vector<std::vector<uint32_t>> lane_words(kLanes);
  std::vector<uint32_t> zz(kSymsPerLane);
  for (int l = 0; l < kLanes; ++l) {
    const int32_t* d = deltas + int64_t(l) * kSymsPerLane;
    int w[3] = {0, 0, 0};
    for (int i = 0; i < kSymsPerLane; ++i) {
      uint32_t z = (uint32_t(d[i]) << 1) ^ uint32_t(d[i] >> 31);
      zz[i] = z;
      int bl = z == 0 ? 0 : 32 - __builtin_clz(z);
      int c = i % 3;
      if (bl > w[c]) w[c] = bl;
    }
    out_widths[l * 3 + 0] = uint8_t(w[0]);
    out_widths[l * 3 + 1] = uint8_t(w[1]);
    out_widths[l * 3 + 2] = uint8_t(w[2]);
    W[l] = w[0] + w[1] + w[2];
    BitPacker pk;
    pk.reserve_bits(int64_t(kPts) * W[l]);
    for (int i = 0; i < kPts; ++i)
      for (int c = 0; c < 3; ++c)
        if (w[c]) pk.push(zz[i * 3 + c], w[c]);
    pk.finish();
    lane_words[l] = std::move(pk.words);
  }

  // lazy-refill counts: count[l][i] = ceil((i+1)W/32) - ceil(iW/32);
  // uniform round width = max over groups of the group's count sum
  int32_t ptr = 0;
  std::vector<int64_t> prev_ce(kLanes, 0);
  std::vector<int64_t> widx(kLanes, 0);
  for (int i = 0; i < kPts; ++i) {
    out_ptrs[i] = ptr;
    int round_words = 0;
    for (int g = 0; g < kGroupsPerBatch; ++g) {
      int sum = 0;
      for (int l = g * kLanesPerGroup; l < (g + 1) * kLanesPerGroup; ++l) {
        int64_t ce = (int64_t(i + 1) * W[l] + 31) >> 5;
        sum += int(ce - prev_ce[l]);
      }
      if (sum > round_words) round_words = sum;
    }
    // emit: per group, lanes in order take their words; pad to round_words
    if (int64_t(ptr) + round_words > maxw) return -1;
    for (int g = 0; g < kGroupsPerBatch; ++g) {
      uint32_t* gs = out_stream + int64_t(g) * maxw;
      int o = ptr;
      for (int l = g * kLanesPerGroup; l < (g + 1) * kLanesPerGroup; ++l) {
        int64_t ce = (int64_t(i + 1) * W[l] + 31) >> 5;
        for (int64_t k = prev_ce[l]; k < ce; ++k) {
          gs[o++] = widx[l] < int64_t(lane_words[l].size())
                        ? lane_words[l][widx[l]]
                        : 0u;
          ++widx[l];
        }
      }
    }
    for (int l = 0; l < kLanes; ++l)
      prev_ce[l] = (int64_t(i + 1) * W[l] + 31) >> 5;
    ptr += round_words;
  }
  *out_nwords = ptr;
  return 0;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Fused reference-batch -> fbatch transcode (the load-time fast path)
// ---------------------------------------------------------------------------
// Decodes one reference `.huffman` batch, computes the integer bbox, and
// re-encodes in the fixed-width TPU layout, all in one call — one
// thread-pool task per batch at load time, no intermediate NumPy passes
// (reference ingest analogue: modules/compute/HuffmanLasLoader.cpp:176-299
// uploads its format directly; the TPU path re-lays the bits out for the
// Pallas decoder's uniform refill rounds instead).
// start_values: 1024*3 int32; out_bbox: 6 int32 (min xyz, max xyz).
int transcode_ref_batch(const uint32_t* encoding, int64_t e_len,
                        const int32_t* cluster, const int32_t* separate,
                        const int32_t* sep_sizes, const int32_t* tval,
                        const int32_t* tlen, const int32_t* start_values,
                        uint8_t* out_widths, uint32_t* out_stream,
                        int64_t* out_nwords, int32_t* out_ptrs,
                        int32_t* out_bbox, int64_t maxw) {
  std::vector<int32_t> deltas((size_t)kLanes * kSymsPerLane);
  int rc = decode_ref_batch(encoding, e_len, cluster, separate, sep_sizes,
                            tval, tlen, deltas.data());
  if (rc) return rc;
  int32_t mn[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  int32_t mx[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  for (int l = 0; l < kLanes; ++l) {
    // delta[0] == 0, so the start value itself enters the minmax
    int32_t cur[3] = {start_values[l * 3], start_values[l * 3 + 1],
                      start_values[l * 3 + 2]};
    const int32_t* d = deltas.data() + (size_t)l * kSymsPerLane;
    for (int i = 0; i < kSymsPerLane; i += 3) {
      for (int c = 0; c < 3; ++c) {
        cur[c] = int32_t(uint32_t(cur[c]) + uint32_t(d[i + c]));
        if (cur[c] < mn[c]) mn[c] = cur[c];
        if (cur[c] > mx[c]) mx[c] = cur[c];
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    out_bbox[c] = mn[c];
    out_bbox[3 + c] = mx[c];
  }
  return encode_fixed_batch(deltas.data(), out_widths, out_stream,
                            out_nwords, out_ptrs, maxw);
}

}  // extern "C"
