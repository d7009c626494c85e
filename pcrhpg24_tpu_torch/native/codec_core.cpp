// Native preprocessor core: per-batch bitstream packing + stream interleave
// for the two `.tpc` stream layouts (the 128-lane group interleave of the
// tbatch codec, with per-round pointers, and the fixed-width fbatch
// codec).  The port's copy of the two encoders of
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
