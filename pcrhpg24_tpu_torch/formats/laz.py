"""LAZ (LASzip) reader/writer — pure-Python re-implementation.

Implements the LASzip 2.x compressed LAS format for point formats 0-3
(items POINT10 v2, GPSTIME11 v2, RGB12 v2, chunked compressor), the
format the reference ingests through the vendored laszip library
(reference: libs/laszip/src/lasreaditemcompressed_v2.cpp,
arithmeticdecoder.cpp, integercompressor.cpp, lasreadpoint.cpp:588-712
chunk table; behavior re-implemented here from scratch in Python).

Components:
  * the Said/Pearlman "FastAC" arithmetic coder (32-bit, periodic
    adaptive models, table-accelerated decode),
  * the laszip IntegerCompressor (k-interval corrector coding),
  * POINT10: changed-values model, streaming-median-of-5 x/y
    prediction with return-number contexts, last-height z prediction,
  * GPSTIME11: multi-sequence double-as-i64 delta coding,
  * RGB12: per-byte difference models,
  * chunk table (fixed 50 000-point chunks, first point of each chunk
    stored raw).

The port's copy of `pcrhpg24_tpu/formats/laz.py` (jax-free NumPy and
Python), held byte for byte to it by `tests/test_torch_laz.py`.  The
implementation follows the published LASzip algorithm; no external
laszip binary cross-validates it.
"""

from __future__ import annotations

import struct

import numpy as np

AC_MIN_LENGTH = 0x01000000
AC_MAX_LENGTH = 0xFFFFFFFF
BM_LENGTH_SHIFT = 13
BM_MAX_COUNT = 1 << BM_LENGTH_SHIFT
DM_LENGTH_SHIFT = 15
DM_MAX_COUNT = 1 << DM_LENGTH_SHIFT
U32 = 0xFFFFFFFF

CHUNK_SIZE = 50_000


# ---------------------------------------------------------------------------
# adaptive models
# ---------------------------------------------------------------------------


class SymbolModel:
    __slots__ = ("symbols", "compress", "last_symbol", "table_size",
                 "table_shift", "distribution", "decoder_table",
                 "symbol_count", "total_count", "update_cycle",
                 "symbols_until_update")

    def __init__(self, symbols: int, compress: bool):
        self.symbols = symbols
        self.compress = compress
        self.last_symbol = symbols - 1
        if (not compress) and symbols > 16:
            table_bits = 3
            while symbols > (1 << (table_bits + 2)):
                table_bits += 1
            self.table_size = 1 << table_bits
            self.table_shift = DM_LENGTH_SHIFT - table_bits
            self.decoder_table = [0] * (self.table_size + 2)
        else:
            self.table_size = self.table_shift = 0
            self.decoder_table = None
        self.distribution = [0] * symbols
        self.symbol_count = [1] * symbols
        self.total_count = 0
        self.update_cycle = symbols
        self.update()
        self.symbols_until_update = self.update_cycle = (symbols + 6) >> 1

    def update(self):
        self.total_count += self.update_cycle
        if self.total_count > DM_MAX_COUNT:
            self.total_count = 0
            for n in range(self.symbols):
                self.symbol_count[n] = (self.symbol_count[n] + 1) >> 1
                self.total_count += self.symbol_count[n]
        scale = 0x80000000 // self.total_count
        sum_ = 0
        if self.compress or self.table_size == 0:
            for k in range(self.symbols):
                self.distribution[k] = (scale * sum_) >> (31 - DM_LENGTH_SHIFT)
                sum_ += self.symbol_count[k]
        else:
            s = 0
            dt = self.decoder_table
            for k in range(self.symbols):
                self.distribution[k] = (scale * sum_) >> (31 - DM_LENGTH_SHIFT)
                sum_ += self.symbol_count[k]
                w = self.distribution[k] >> self.table_shift
                while s < w:
                    s += 1
                    dt[s] = k - 1
            dt[0] = 0
            while s <= self.table_size:
                s += 1
                dt[s] = self.symbols - 1
        self.update_cycle = (5 * self.update_cycle) >> 2
        max_cycle = (self.symbols + 6) << 3
        if self.update_cycle > max_cycle:
            self.update_cycle = max_cycle
        self.symbols_until_update = self.update_cycle


class BitModel:
    __slots__ = ("bit_0_prob", "bit_0_count", "bit_count", "update_cycle",
                 "bits_until_update")

    def __init__(self):
        self.bit_0_count = 1
        self.bit_count = 2
        self.bit_0_prob = 1 << (BM_LENGTH_SHIFT - 1)
        self.update_cycle = self.bits_until_update = 4

    def update(self):
        self.bit_count += self.update_cycle
        if self.bit_count > BM_MAX_COUNT:
            self.bit_count = (self.bit_count + 1) >> 1
            self.bit_0_count = (self.bit_0_count + 1) >> 1
            if self.bit_0_count == self.bit_count:
                self.bit_count += 1
        scale = 0x80000000 // self.bit_count
        self.bit_0_prob = (self.bit_0_count * scale) >> (31 - BM_LENGTH_SHIFT)
        self.update_cycle = (5 * self.update_cycle) >> 2
        if self.update_cycle > 64:
            self.update_cycle = 64
        self.bits_until_update = self.update_cycle


# ---------------------------------------------------------------------------
# arithmetic coder
# ---------------------------------------------------------------------------


class Decoder:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.value = (data[pos] << 24) | (data[pos + 1] << 16) | \
            (data[pos + 2] << 8) | data[pos + 3]
        self.pos += 4
        self.length = AC_MAX_LENGTH

    def _getbyte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.pos += 1
        return 0

    def _renorm(self):
        while True:
            self.value = ((self.value << 8) & U32) | self._getbyte()
            self.length = (self.length << 8) & U32
            if self.length >= AC_MIN_LENGTH:
                break

    def decode_bit(self, m: BitModel) -> int:
        x = m.bit_0_prob * (self.length >> BM_LENGTH_SHIFT)
        sym = 1 if self.value >= x else 0
        if sym == 0:
            self.length = x
            m.bit_0_count += 1
        else:
            self.value -= x
            self.length -= x
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.bits_until_update -= 1
        if m.bits_until_update == 0:
            m.update()
        return sym

    def decode_symbol(self, m: SymbolModel) -> int:
        y = self.length
        dist = m.distribution
        if m.decoder_table is not None:
            self.length >>= DM_LENGTH_SHIFT
            dv = self.value // self.length
            t = dv >> m.table_shift
            sym = m.decoder_table[t]
            n = m.decoder_table[t + 1] + 1
            while n > sym + 1:
                k = (sym + n) >> 1
                if dist[k] > dv:
                    n = k
                else:
                    sym = k
            x = dist[sym] * self.length
            if sym != m.last_symbol:
                y = dist[sym + 1] * self.length
        else:
            x = sym = 0
            self.length >>= DM_LENGTH_SHIFT
            n = m.symbols
            k = n >> 1
            while True:
                z = self.length * dist[k]
                if z > self.value:
                    n = k
                    y = z
                else:
                    sym = k
                    x = z
                k = (sym + n) >> 1
                if k == sym:
                    break
        self.value -= x
        self.length = y - x
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.symbol_count[sym] += 1
        m.symbols_until_update -= 1
        if m.symbols_until_update == 0:
            m.update()
        return sym

    def read_bit(self) -> int:
        self.length >>= 1
        sym = self.value // self.length
        self.value -= self.length * sym
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        return sym

    def read_bits(self, bits: int) -> int:
        if bits > 19:
            tmp = self.read_bits(16)
            tmp1 = self.read_bits(bits - 16) << 16
            return tmp1 | tmp
        self.length >>= bits
        sym = self.value // self.length
        self.value -= self.length * sym
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        return sym

    def read_int(self) -> int:
        lower = self.read_bits(16)
        upper = self.read_bits(16)
        return (upper << 16) | lower


class Encoder:
    def __init__(self):
        self.out = bytearray()
        self.base = 0
        self.length = AC_MAX_LENGTH

    def _propagate_carry(self):
        p = len(self.out) - 1
        while self.out[p] == 0xFF:
            self.out[p] = 0
            p -= 1
        self.out[p] += 1

    def _renorm(self):
        while True:
            self.out.append((self.base >> 24) & 0xFF)
            self.base = (self.base << 8) & U32
            self.length = (self.length << 8) & U32
            if self.length >= AC_MIN_LENGTH:
                break

    def encode_bit(self, m: BitModel, sym: int):
        x = m.bit_0_prob * (self.length >> BM_LENGTH_SHIFT)
        if sym == 0:
            self.length = x
            m.bit_0_count += 1
        else:
            init_base = self.base
            self.base = (self.base + x) & U32
            self.length -= x
            if init_base > self.base:
                self._propagate_carry()
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.bits_until_update -= 1
        if m.bits_until_update == 0:
            m.update()

    def encode_symbol(self, m: SymbolModel, sym: int):
        init_base = self.base
        if sym == m.last_symbol:
            x = m.distribution[sym] * (self.length >> DM_LENGTH_SHIFT)
            self.base = (self.base + x) & U32
            self.length -= x
        else:
            self.length >>= DM_LENGTH_SHIFT
            x = m.distribution[sym] * self.length
            self.base = (self.base + x) & U32
            self.length = m.distribution[sym + 1] * self.length - x
        if init_base > self.base:
            self._propagate_carry()
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.symbol_count[sym] += 1
        m.symbols_until_update -= 1
        if m.symbols_until_update == 0:
            m.update()

    def write_bit(self, sym: int):
        init_base = self.base
        self.length >>= 1
        self.base = (self.base + sym * self.length) & U32
        if init_base > self.base:
            self._propagate_carry()
        if self.length < AC_MIN_LENGTH:
            self._renorm()

    def write_bits(self, bits: int, sym: int):
        if bits > 19:
            self.write_bits(16, sym & 0xFFFF)
            sym >>= 16
            bits -= 16
        init_base = self.base
        self.length >>= bits
        self.base = (self.base + sym * self.length) & U32
        if init_base > self.base:
            self._propagate_carry()
        if self.length < AC_MIN_LENGTH:
            self._renorm()

    def write_int(self, v: int):
        self.write_bits(16, v & 0xFFFF)
        self.write_bits(16, (v >> 16) & 0xFFFF)

    def done(self) -> bytes:
        init_base = self.base
        another = True
        if self.length > 2 * AC_MIN_LENGTH:
            self.base = (self.base + AC_MIN_LENGTH) & U32
            self.length = AC_MIN_LENGTH >> 1
        else:
            self.base = (self.base + (AC_MIN_LENGTH >> 1)) & U32
            self.length = AC_MIN_LENGTH >> 9
            another = False
        if init_base > self.base:
            self._propagate_carry()
        self._renorm()
        self.out.append(0)
        self.out.append(0)
        if another:
            self.out.append(0)
        return bytes(self.out)


# ---------------------------------------------------------------------------
# integer compressor
# ---------------------------------------------------------------------------


def _i32(v):
    v &= U32
    return v - (1 << 32) if v >= (1 << 31) else v


class IntegerCompressor:
    def __init__(self, coder, bits=16, contexts=1, bits_high=8, compress=False):
        self.coder = coder
        self.bits = bits
        self.contexts = contexts
        self.bits_high = bits_high
        if bits and bits < 32:
            self.corr_bits = bits
            self.corr_range = 1 << bits
            self.corr_min = -(self.corr_range // 2)
            self.corr_max = self.corr_min + self.corr_range - 1
        else:
            self.corr_bits = 32
            self.corr_range = 0
            self.corr_min = -(1 << 31)
            self.corr_max = (1 << 31) - 1
        self.k = 0
        self.m_bits = [SymbolModel(self.corr_bits + 1, compress)
                       for _ in range(contexts)]
        self.m_corr = [BitModel()]
        for i in range(1, self.corr_bits + 1):
            self.m_corr.append(
                SymbolModel(1 << min(i, bits_high), compress)
            )

    # -- decode -----------------------------------------------------------
    def decompress(self, pred: int, context: int = 0) -> int:
        real = _i32(pred + self._read_corrector(self.m_bits[context]))
        if real < 0:
            real += self.corr_range
        elif self.corr_range and real >= self.corr_range:
            real -= self.corr_range
        return _i32(real)

    def _read_corrector(self, m) -> int:
        dec = self.coder
        self.k = k = dec.decode_symbol(m)
        if k:
            if k < 32:
                if k <= self.bits_high:
                    c = dec.decode_symbol(self.m_corr[k])
                else:
                    k1 = k - self.bits_high
                    c = dec.decode_symbol(self.m_corr[k])
                    c1 = dec.read_bits(k1)
                    c = (c << k1) | c1
                if c >= (1 << (k - 1)):
                    c += 1
                else:
                    c -= (1 << k) - 1
            else:
                c = self.corr_min
        else:
            c = dec.decode_bit(self.m_corr[0])
        return c

    # -- encode -----------------------------------------------------------
    def compress(self, pred: int, real: int, context: int = 0):
        corr = _i32(real - pred)  # I32 wraparound, as in the C original
        if corr < self.corr_min:
            corr += self.corr_range
        elif corr > self.corr_max:
            corr -= self.corr_range
        self._write_corrector(corr, self.m_bits[context])

    def _write_corrector(self, c: int, m):
        enc = self.coder
        k = 0
        c1 = -c if c <= 0 else c - 1
        while c1:
            c1 >>= 1
            k += 1
        self.k = k
        enc.encode_symbol(m, k)
        if k:
            if k < 32:
                if c < 0:
                    c += (1 << k) - 1
                else:
                    c -= 1
                if k <= self.bits_high:
                    enc.encode_symbol(self.m_corr[k], c)
                else:
                    k1 = k - self.bits_high
                    enc.encode_symbol(self.m_corr[k], c >> k1)
                    enc.write_bits(k1, c & ((1 << k1) - 1))
        else:
            enc.encode_bit(self.m_corr[0], c)


# ---------------------------------------------------------------------------
# POINT10 / GPSTIME11 / RGB12 (version 2) item codecs
# ---------------------------------------------------------------------------

# context tables (laszip_common_v2.hpp:146-186)
NUMBER_RETURN_MAP = [
    [15, 14, 13, 12, 11, 10, 9, 8],
    [14, 0, 1, 3, 6, 10, 10, 9],
    [13, 1, 2, 4, 7, 11, 11, 10],
    [12, 3, 4, 5, 8, 12, 12, 11],
    [11, 6, 7, 8, 9, 13, 13, 12],
    [10, 10, 11, 12, 13, 14, 14, 13],
    [9, 10, 11, 12, 13, 14, 15, 14],
    [8, 9, 10, 11, 12, 13, 14, 15],
]
NUMBER_RETURN_LEVEL = [
    [abs(n - r) if max(n, r) < 8 else 7 for r in range(8)] for n in range(8)
]


class Median5:
    __slots__ = ("v", "high")

    def __init__(self):
        self.v = [0, 0, 0, 0, 0]
        self.high = True

    def add(self, x):
        v = self.v
        if self.high:
            if x < v[2]:
                v[4] = v[3]
                v[3] = v[2]
                if x < v[0]:
                    v[2] = v[1]
                    v[1] = v[0]
                    v[0] = x
                elif x < v[1]:
                    v[2] = v[1]
                    v[1] = x
                else:
                    v[2] = x
            else:
                if x < v[3]:
                    v[4] = v[3]
                    v[3] = x
                else:
                    v[4] = x
                self.high = False
        else:
            if v[2] < x:
                v[0] = v[1]
                v[1] = v[2]
                if v[4] < x:
                    v[2] = v[3]
                    v[3] = v[4]
                    v[4] = x
                elif v[3] < x:
                    v[2] = v[3]
                    v[3] = x
                else:
                    v[2] = x
            else:
                if v[1] < x:
                    v[0] = v[1]
                    v[1] = x
                else:
                    v[0] = x
                self.high = True

    def get(self):
        return self.v[2]


def _u8_fold(n):
    return n & 0xFF


def _u8_clamp(n):
    return 0 if n <= 0 else (255 if n >= 255 else n)


def _div2(n):
    """C-style truncating division by 2 (negative values round to 0)."""
    return -((-n) >> 1) if n < 0 else n >> 1


class Point10:
    """POINT10 v2 codec state.  Point = dict with keys x,y,z,intensity,
    bitbyte,classification,scan_angle,user_data,point_source."""

    def __init__(self, coder, compress: bool):
        self.coder = coder
        self.compress = compress
        self.m_changed = SymbolModel(64, compress)
        self.ic_intensity = IntegerCompressor(coder, 16, 4, compress=compress)
        self.m_scan_angle = [SymbolModel(256, compress) for _ in range(2)]
        self.ic_point_source = IntegerCompressor(coder, 16, compress=compress)
        self.m_bit_byte = [None] * 256
        self.m_classification = [None] * 256
        self.m_user_data = [None] * 256
        self.ic_dx = IntegerCompressor(coder, 32, 2, compress=compress)
        self.ic_dy = IntegerCompressor(coder, 32, 22, compress=compress)
        self.ic_z = IntegerCompressor(coder, 32, 20, compress=compress)
        self.x_diff_median = [Median5() for _ in range(16)]
        self.y_diff_median = [Median5() for _ in range(16)]
        self.last_intensity = [0] * 16
        self.last_height = [0] * 8
        self.last = None  # dict

    def init(self, pt):
        self.last = dict(pt)
        self.last["intensity"] = 0

    def _ctx(self):
        bb = self.last["bitbyte"]
        r = bb & 7
        n = (bb >> 3) & 7
        return r, n, NUMBER_RETURN_MAP[n][r], NUMBER_RETURN_LEVEL[n][r]

    def read(self):
        dec = self.coder
        last = self.last
        changed = dec.decode_symbol(self.m_changed)
        if changed:
            if changed & 32:
                i = last["bitbyte"]
                if self.m_bit_byte[i] is None:
                    self.m_bit_byte[i] = SymbolModel(256, False)
                last["bitbyte"] = dec.decode_symbol(self.m_bit_byte[i])
            r, n, m, l = self._ctx()
            if changed & 16:
                last["intensity"] = self.ic_intensity.decompress(
                    self.last_intensity[m], m if m < 3 else 3)
                self.last_intensity[m] = last["intensity"]
            else:
                last["intensity"] = self.last_intensity[m]
            if changed & 8:
                i = last["classification"]
                if self.m_classification[i] is None:
                    self.m_classification[i] = SymbolModel(256, False)
                last["classification"] = dec.decode_symbol(self.m_classification[i])
            if changed & 4:
                sd = (last["bitbyte"] >> 6) & 1
                val = dec.decode_symbol(self.m_scan_angle[sd])
                last["scan_angle"] = _u8_fold(val + last["scan_angle"])
            if changed & 2:
                i = last["user_data"]
                if self.m_user_data[i] is None:
                    self.m_user_data[i] = SymbolModel(256, False)
                last["user_data"] = dec.decode_symbol(self.m_user_data[i])
            if changed & 1:
                last["point_source"] = self.ic_point_source.decompress(
                    last["point_source"]) & 0xFFFF
        else:
            r, n, m, l = self._ctx()
        median = self.x_diff_median[m].get()
        diff = self.ic_dx.decompress(median, 1 if n == 1 else 0)
        last["x"] = _i32(last["x"] + diff)
        self.x_diff_median[m].add(diff)

        median = self.y_diff_median[m].get()
        k_bits = self.ic_dx.k
        ctx = (1 if n == 1 else 0) + ((k_bits & ~1) if k_bits < 20 else 20)
        diff = self.ic_dy.decompress(median, ctx)
        last["y"] = _i32(last["y"] + diff)
        self.y_diff_median[m].add(diff)

        k_bits = (self.ic_dx.k + self.ic_dy.k) // 2
        ctx = (1 if n == 1 else 0) + ((k_bits & ~1) if k_bits < 18 else 18)
        last["z"] = self.ic_z.decompress(self.last_height[l], ctx)
        self.last_height[l] = last["z"]
        return dict(last)

    def write(self, pt):
        enc = self.coder
        last = self.last
        bb = pt["bitbyte"]
        r = bb & 7
        n = (bb >> 3) & 7
        m = NUMBER_RETURN_MAP[n][r]
        l = NUMBER_RETURN_LEVEL[n][r]
        changed = (
            ((last["bitbyte"] != bb) << 5)
            | ((self.last_intensity[m] != pt["intensity"]) << 4)
            | ((last["classification"] != pt["classification"]) << 3)
            | ((last["scan_angle"] != pt["scan_angle"]) << 2)
            | ((last["user_data"] != pt["user_data"]) << 1)
            | (last["point_source"] != pt["point_source"])
        )
        enc.encode_symbol(self.m_changed, changed)
        if changed & 32:
            i = last["bitbyte"]
            if self.m_bit_byte[i] is None:
                self.m_bit_byte[i] = SymbolModel(256, True)
            enc.encode_symbol(self.m_bit_byte[i], bb)
        if changed & 16:
            self.ic_intensity.compress(
                self.last_intensity[m], pt["intensity"], m if m < 3 else 3)
            self.last_intensity[m] = pt["intensity"]
        if changed & 8:
            i = last["classification"]
            if self.m_classification[i] is None:
                self.m_classification[i] = SymbolModel(256, True)
            enc.encode_symbol(self.m_classification[i], pt["classification"])
        if changed & 4:
            sd = (bb >> 6) & 1
            enc.encode_symbol(
                self.m_scan_angle[sd],
                _u8_fold(pt["scan_angle"] - last["scan_angle"]))
        if changed & 2:
            i = last["user_data"]
            if self.m_user_data[i] is None:
                self.m_user_data[i] = SymbolModel(256, True)
            enc.encode_symbol(self.m_user_data[i], pt["user_data"])
        if changed & 1:
            self.ic_point_source.compress(
                last["point_source"], pt["point_source"])

        median = self.x_diff_median[m].get()
        diff = _i32(pt["x"] - last["x"])
        self.ic_dx.compress(median, diff, 1 if n == 1 else 0)
        self.x_diff_median[m].add(diff)

        median = self.y_diff_median[m].get()
        k_bits = self.ic_dx.k
        ctx = (1 if n == 1 else 0) + ((k_bits & ~1) if k_bits < 20 else 20)
        diff = _i32(pt["y"] - last["y"])
        self.ic_dy.compress(median, diff, ctx)
        self.y_diff_median[m].add(diff)

        k_bits = (self.ic_dx.k + self.ic_dy.k) // 2
        ctx = (1 if n == 1 else 0) + ((k_bits & ~1) if k_bits < 18 else 18)
        self.ic_z.compress(self.last_height[l], pt["z"], ctx)
        self.last_height[l] = pt["z"]
        self.last = dict(pt)


GPSTIME_MULTI = 500
GPSTIME_MULTI_MINUS = -10
GPSTIME_MULTI_UNCHANGED = GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 1
GPSTIME_MULTI_CODE_FULL = GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 2
GPSTIME_MULTI_TOTAL = GPSTIME_MULTI - GPSTIME_MULTI_MINUS + 6


def _i64(v):
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


class GpsTime11:
    def __init__(self, coder, compress: bool):
        self.coder = coder
        self.m_multi = SymbolModel(GPSTIME_MULTI_TOTAL, compress)
        self.m_0diff = SymbolModel(6, compress)
        self.ic = IntegerCompressor(coder, 32, 9, compress=compress)
        self.last = 0
        self.next = 0
        self.last_diff = [0, 0, 0, 0]
        self.extreme = [0, 0, 0, 0]
        self.last_gps = [0, 0, 0, 0]  # i64 views of the f64 bits

    def init(self, gps_i64: int):
        self.last_gps[0] = gps_i64

    def read(self) -> int:
        dec = self.coder
        if self.last_diff[self.last] == 0:
            multi = dec.decode_symbol(self.m_0diff)
            if multi == 1:
                d = self.ic.decompress(0, 0)
                self.last_diff[self.last] = d
                self.last_gps[self.last] = _i64(self.last_gps[self.last] + d)
                self.extreme[self.last] = 0
            elif multi == 2:
                self.next = (self.next + 1) & 3
                hi = self.ic.decompress(
                    _i32((self.last_gps[self.last] >> 32) & U32), 8)
                v = ((hi & U32) << 32) | dec.read_int()
                self.last_gps[self.next] = _i64(v)
                self.last = self.next
                self.last_diff[self.last] = 0
                self.extreme[self.last] = 0
            elif multi > 2:
                self.last = (self.last + multi - 2) & 3
                return self.read()
        else:
            multi = dec.decode_symbol(self.m_multi)
            if multi == 1:
                d = self.ic.decompress(self.last_diff[self.last], 1)
                self.last_gps[self.last] = _i64(self.last_gps[self.last] + d)
                self.extreme[self.last] = 0
            elif multi < GPSTIME_MULTI_UNCHANGED:
                if multi == 0:
                    d = self.ic.decompress(0, 7)
                    self.extreme[self.last] += 1
                    if self.extreme[self.last] > 3:
                        self.last_diff[self.last] = d
                        self.extreme[self.last] = 0
                elif multi < GPSTIME_MULTI:
                    ctx = 2 if multi < 10 else 3
                    d = self.ic.decompress(
                        _i32(multi * self.last_diff[self.last]), ctx)
                elif multi == GPSTIME_MULTI:
                    d = self.ic.decompress(
                        _i32(GPSTIME_MULTI * self.last_diff[self.last]), 4)
                    self.extreme[self.last] += 1
                    if self.extreme[self.last] > 3:
                        self.last_diff[self.last] = d
                        self.extreme[self.last] = 0
                else:
                    mm = GPSTIME_MULTI - multi
                    if mm > GPSTIME_MULTI_MINUS:
                        d = self.ic.decompress(
                            _i32(mm * self.last_diff[self.last]), 5)
                    else:
                        d = self.ic.decompress(
                            _i32(GPSTIME_MULTI_MINUS * self.last_diff[self.last]), 6)
                        self.extreme[self.last] += 1
                        if self.extreme[self.last] > 3:
                            self.last_diff[self.last] = d
                            self.extreme[self.last] = 0
                self.last_gps[self.last] = _i64(self.last_gps[self.last] + d)
            elif multi == GPSTIME_MULTI_CODE_FULL:
                self.next = (self.next + 1) & 3
                hi = self.ic.decompress(
                    _i32((self.last_gps[self.last] >> 32) & U32), 8)
                v = ((hi & U32) << 32) | dec.read_int()
                self.last_gps[self.next] = _i64(v)
                self.last = self.next
                self.last_diff[self.last] = 0
                self.extreme[self.last] = 0
            elif multi > GPSTIME_MULTI_CODE_FULL:
                self.last = (self.last + multi - GPSTIME_MULTI_CODE_FULL) & 3
                return self.read()
        return self.last_gps[self.last]

    def write(self, gps_i64: int):
        # simplified single-sequence encoder: emits only codes the
        # decoder handles (1 = 32-bit delta, 2/FULL = full 64-bit)
        enc = self.coder
        if self.last_diff[self.last] == 0:
            if gps_i64 == self.last_gps[self.last]:
                enc.encode_symbol(self.m_0diff, 0)
                return
            diff64 = gps_i64 - self.last_gps[self.last]
            diff = _i32(diff64 & U32)
            if diff == diff64:
                enc.encode_symbol(self.m_0diff, 1)
                self.ic.compress(0, diff, 0)
                self.last_diff[self.last] = diff
                self.extreme[self.last] = 0
            else:
                enc.encode_symbol(self.m_0diff, 2)
                self.next = (self.next + 1) & 3
                self.ic.compress(
                    _i32((self.last_gps[self.last] >> 32) & U32),
                    _i32((gps_i64 >> 32) & U32), 8)
                enc.write_int(gps_i64 & U32)
                self.last = self.next
                self.last_diff[self.last] = 0
                self.extreme[self.last] = 0
            self.last_gps[self.last] = gps_i64
        else:
            if gps_i64 == self.last_gps[self.last]:
                # unchanged: multi code 500 - (-10) + 1
                enc.encode_symbol(self.m_multi, GPSTIME_MULTI_UNCHANGED)
                return
            diff64 = gps_i64 - self.last_gps[self.last]
            diff = _i32(diff64 & U32)
            if diff == diff64:
                enc.encode_symbol(self.m_multi, 1)
                self.ic.compress(self.last_diff[self.last], diff, 1)
                self.extreme[self.last] = 0
            else:
                enc.encode_symbol(self.m_multi, GPSTIME_MULTI_CODE_FULL)
                self.next = (self.next + 1) & 3
                self.ic.compress(
                    _i32((self.last_gps[self.last] >> 32) & U32),
                    _i32((gps_i64 >> 32) & U32), 8)
                enc.write_int(gps_i64 & U32)
                self.last = self.next
                self.last_diff[self.last] = 0
                self.extreme[self.last] = 0
            self.last_gps[self.last] = gps_i64


class Rgb12:
    def __init__(self, coder, compress: bool):
        self.coder = coder
        self.m_used = SymbolModel(128, compress)
        self.m_diff = [SymbolModel(256, compress) for _ in range(6)]
        self.last = [0, 0, 0]

    def init(self, rgb):
        self.last = list(rgb)

    def read(self):
        dec = self.coder
        last = self.last
        sym = dec.decode_symbol(self.m_used)
        out = [0, 0, 0]
        if sym & 1:
            corr = dec.decode_symbol(self.m_diff[0])
            out[0] = _u8_fold(corr + (last[0] & 255))
        else:
            out[0] = last[0] & 0xFF
        if sym & 2:
            corr = dec.decode_symbol(self.m_diff[1])
            out[0] |= _u8_fold(corr + (last[0] >> 8)) << 8
        else:
            out[0] |= last[0] & 0xFF00
        if sym & 64:
            diff = (out[0] & 0xFF) - (last[0] & 0xFF)
            if sym & 4:
                corr = dec.decode_symbol(self.m_diff[2])
                out[1] = _u8_fold(corr + _u8_clamp(diff + (last[1] & 255)))
            else:
                out[1] = last[1] & 0xFF
            if sym & 16:
                corr = dec.decode_symbol(self.m_diff[4])
                diff = _div2(diff + ((out[1] & 0xFF) - (last[1] & 0xFF)))
                out[2] = _u8_fold(corr + _u8_clamp(diff + (last[2] & 255)))
            else:
                out[2] = last[2] & 0xFF
            diff = (out[0] >> 8) - (last[0] >> 8)
            if sym & 8:
                corr = dec.decode_symbol(self.m_diff[3])
                out[1] |= _u8_fold(corr + _u8_clamp(diff + (last[1] >> 8))) << 8
            else:
                out[1] |= last[1] & 0xFF00
            if sym & 32:
                corr = dec.decode_symbol(self.m_diff[5])
                diff = _div2(diff + ((out[1] >> 8) - (last[1] >> 8)))
                out[2] |= _u8_fold(corr + _u8_clamp(diff + (last[2] >> 8))) << 8
            else:
                out[2] |= last[2] & 0xFF00
        else:
            out[1] = out[0]
            out[2] = out[0]
        self.last = list(out)
        return out

    def write(self, rgb):
        # mirror of laswriteitemcompressed_v2.cpp:504-553
        enc = self.coder
        last = self.last
        diff_l = 0
        diff_h = 0
        sym = (
            (((last[0] & 0x00FF) != (rgb[0] & 0x00FF)) << 0)
            | (((last[0] & 0xFF00) != (rgb[0] & 0xFF00)) << 1)
            | (((last[1] & 0x00FF) != (rgb[1] & 0x00FF)) << 2)
            | (((last[1] & 0xFF00) != (rgb[1] & 0xFF00)) << 3)
            | (((last[2] & 0x00FF) != (rgb[2] & 0x00FF)) << 4)
            | (((last[2] & 0xFF00) != (rgb[2] & 0xFF00)) << 5)
            | ((
                ((rgb[0] & 0x00FF) != (rgb[1] & 0x00FF))
                or ((rgb[0] & 0x00FF) != (rgb[2] & 0x00FF))
                or ((rgb[0] & 0xFF00) != (rgb[1] & 0xFF00))
                or ((rgb[0] & 0xFF00) != (rgb[2] & 0xFF00))
            ) << 6)
        )
        enc.encode_symbol(self.m_used, sym)
        if sym & 1:
            diff_l = (rgb[0] & 255) - (last[0] & 255)
            enc.encode_symbol(self.m_diff[0], _u8_fold(diff_l))
        if sym & 2:
            diff_h = (rgb[0] >> 8) - (last[0] >> 8)
            enc.encode_symbol(self.m_diff[1], _u8_fold(diff_h))
        if sym & 64:
            if sym & 4:
                corr = (rgb[1] & 255) - _u8_clamp(diff_l + (last[1] & 255))
                enc.encode_symbol(self.m_diff[2], _u8_fold(corr))
            if sym & 16:
                diff_l = _div2(diff_l + (rgb[1] & 255) - (last[1] & 255))
                corr = (rgb[2] & 255) - _u8_clamp(diff_l + (last[2] & 255))
                enc.encode_symbol(self.m_diff[4], _u8_fold(corr))
            if sym & 8:
                corr = (rgb[1] >> 8) - _u8_clamp(diff_h + (last[1] >> 8))
                enc.encode_symbol(self.m_diff[3], _u8_fold(corr))
            if sym & 32:
                diff_h = _div2(diff_h + (rgb[1] >> 8) - (last[1] >> 8))
                corr = (rgb[2] >> 8) - _u8_clamp(diff_h + (last[2] >> 8))
                enc.encode_symbol(self.m_diff[5], _u8_fold(corr))
        self.last = list(rgb)


# ---------------------------------------------------------------------------
# chunked point stream + LAZ container
# ---------------------------------------------------------------------------

ITEM_POINT10 = 6
ITEM_GPSTIME11 = 7
ITEM_RGB12 = 8
_FORMAT_ITEMS = {
    0: [(ITEM_POINT10, 20, 2)],
    1: [(ITEM_POINT10, 20, 2), (ITEM_GPSTIME11, 8, 2)],
    2: [(ITEM_POINT10, 20, 2), (ITEM_RGB12, 6, 2)],
    3: [(ITEM_POINT10, 20, 2), (ITEM_GPSTIME11, 8, 2), (ITEM_RGB12, 6, 2)],
}


def _pack_point10(pt) -> bytes:
    return struct.pack(
        "<iiiHBBbBH", pt["x"], pt["y"], pt["z"], pt["intensity"],
        pt["bitbyte"], pt["classification"],
        pt["scan_angle"] - 256 if pt["scan_angle"] > 127 else pt["scan_angle"],
        pt["user_data"], pt["point_source"],
    )


def _unpack_point10(b: bytes) -> dict:
    x, y, z, inten, bb, cls, sar, ud, psid = struct.unpack("<iiiHBBbBH", b)
    return dict(x=x, y=y, z=z, intensity=inten, bitbyte=bb,
                classification=cls, scan_angle=sar & 0xFF, user_data=ud,
                point_source=psid)


def _compress_chunk(pts: list, fmt: int) -> bytes:
    """pts: list of (point10 dict, gps_i64, (r,g,b)) tuples."""
    out = bytearray()
    # first point raw
    p0, g0, c0 = pts[0]
    out += _pack_point10(p0)
    if fmt in (1, 3):
        out += struct.pack("<q", g0)
    if fmt in (2, 3):
        out += struct.pack("<HHH", *c0)
    if len(pts) > 1:
        enc = Encoder()
        point10 = Point10(enc, True)
        point10.init(p0)
        gps = Gps = rgb = None
        if fmt in (1, 3):
            gps = GpsTime11(enc, True)
            gps.init(g0)
        if fmt in (2, 3):
            rgb = Rgb12(enc, True)
            rgb.init(c0)
        for p, g, c in pts[1:]:
            point10.write(p)
            if gps is not None:
                gps.write(g)
            if rgb is not None:
                rgb.write(list(c))
        out += enc.done()
    return bytes(out)


def _decompress_chunk(data: bytes, pos: int, fmt: int, n: int):
    """-> (list of (point10 dict, gps_i64, (r,g,b)))."""
    raw_size = 20 + (8 if fmt in (1, 3) else 0) + (6 if fmt in (2, 3) else 0)
    p0 = _unpack_point10(data[pos : pos + 20])
    off = pos + 20
    g0 = 0
    c0 = (0, 0, 0)
    if fmt in (1, 3):
        (g0,) = struct.unpack_from("<q", data, off)
        off += 8
    if fmt in (2, 3):
        c0 = struct.unpack_from("<HHH", data, off)
        off += 6
    pts = [(dict(p0), g0, tuple(c0))]
    if n > 1:
        dec = Decoder(data, off)
        point10 = Point10(dec, False)
        point10.init(p0)
        gps = rgb = None
        if fmt in (1, 3):
            gps = GpsTime11(dec, False)
            gps.init(g0)
        if fmt in (2, 3):
            rgb = Rgb12(dec, False)
            rgb.init(list(c0))
        for _ in range(n - 1):
            p = point10.read()
            g = gps.read() if gps is not None else 0
            c = tuple(rgb.read()) if rgb is not None else (0, 0, 0)
            pts.append((p, g, c))
    return pts


def _chunk_table_bytes(chunk_bytes: list) -> bytes:
    out = bytearray(struct.pack("<II", 0, len(chunk_bytes)))
    if chunk_bytes:
        enc = Encoder()
        ic = IntegerCompressor(enc, 32, 2, compress=True)
        prev = 0
        for cb in chunk_bytes:
            ic.compress(prev, cb, 1)
            prev = cb
        out += enc.done()
    return bytes(out)


def _read_chunk_table(data: bytes, pos: int) -> list:
    version, nchunks = struct.unpack_from("<II", data, pos)
    assert version == 0, f"unsupported chunk table version {version}"
    sizes = []
    if nchunks:
        dec = Decoder(data, pos + 8)
        ic = IntegerCompressor(dec, 32, 2, compress=False)
        prev = 0
        for _ in range(nchunks):
            prev = ic.decompress(prev, 1)
            sizes.append(prev)
    return sizes


def write_laz(path: str, x, y, z, rgb=None, scale=(0.001, 0.001, 0.001),
              offset=(0.0, 0.0, 0.0), point_format: int = 2,
              gps_time=None, chunk_size: int = CHUNK_SIZE) -> None:
    """Write a chunked LAZ file (LAS 1.2 + laszip VLR + v2 items).

    x/y/z int32 grid coords; rgb (n,3) 8-bit or None; gps_time (n,) f64
    or None (formats 1/3)."""
    n = len(x)
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    z = np.asarray(z, np.int64)
    items = _FORMAT_ITEMS[point_format]
    record_length = sum(sz for _t, sz, _v in items)
    scale = np.asarray(scale, np.float64)
    offset_v = np.asarray(offset, np.float64)

    if rgb is None:
        rgb16 = np.zeros((n, 3), np.uint16)
    else:
        rgb = np.asarray(rgb)
        rgb16 = (rgb.astype(np.uint16) * 257) if rgb.max(initial=0) <= 255 \
            else rgb.astype(np.uint16)
    if gps_time is None:
        gps_i64 = np.zeros(n, np.int64)
    else:
        gps_i64 = np.asarray(gps_time, np.float64).view(np.int64)

    # laszip VLR payload (laszip.cpp pack/unpack layout)
    # -1 for the special-EVLR count/offset i64s when unused, matching the
    # laszip VLR convention (laszip.cpp); 0 could read as "present at 0"
    vlr_payload = struct.pack("<HHBBHIIqqH", 2, 0, 2, 2, 2, 0, chunk_size,
                              -1, -1, len(items))
    for t, sz, v in items:
        vlr_payload += struct.pack("<HHH", t, sz, v)
    vlr = (
        struct.pack("<H", 0) + b"laszip encoded\x00\x00"
        + struct.pack("<HH", 22204, len(vlr_payload))
        + b"pcrhpg24_tpu LASzip writer".ljust(32, b"\x00")
        + vlr_payload
    )

    header_size = 227
    offset_to_points = header_size + len(vlr)
    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24] = 1
    hdr[25] = 2  # LAS 1.2
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<I", hdr, 96, offset_to_points)
    struct.pack_into("<I", hdr, 100, 1)  # one VLR
    hdr[104] = point_format | 0x80  # bit 7: laszip compressed
    struct.pack_into("<H", hdr, 105, record_length)
    struct.pack_into("<I", hdr, 107, n)
    struct.pack_into("<3d", hdr, 131, *scale)
    struct.pack_into("<3d", hdr, 155, *offset_v)
    wx = x * scale[0] + offset_v[0]
    wy = y * scale[1] + offset_v[1]
    wz = z * scale[2] + offset_v[2]
    struct.pack_into("<6d", hdr, 179, wx.max(), wx.min(), wy.max(), wy.min(),
                     wz.max(), wz.min())

    chunks = []
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        pts = [
            (dict(x=int(x[i]), y=int(y[i]), z=int(z[i]), intensity=0,
                  bitbyte=0x11, classification=0, scan_angle=0, user_data=0,
                  point_source=0),
             int(gps_i64[i]),
             (int(rgb16[i, 0]), int(rgb16[i, 1]), int(rgb16[i, 2])))
            for i in range(s, e)
        ]
        chunks.append(_compress_chunk(pts, point_format))

    with open(path, "wb") as f:
        f.write(hdr)
        f.write(vlr)
        table_pos_field = f.tell()
        f.write(struct.pack("<q", 0))  # chunk table position placeholder
        for c in chunks:
            f.write(c)
        table_pos = f.tell()
        f.write(_chunk_table_bytes([len(c) for c in chunks]))
        f.seek(table_pos_field)
        f.write(struct.pack("<q", table_pos))


def read_laz_points(path: str, first: int = 0, count: int | None = None):
    """Decode [first, first+count) points of a LAZ file -> LasPoints."""
    from .las import LasHeader, LasPoints, read_header

    h = read_header(path)
    with open(path, "rb") as f:
        data = f.read()
    # find the laszip VLR
    hdr_size = struct.unpack_from("<H", data, 94)[0]
    n_vlrs = struct.unpack_from("<I", data, 100)[0]
    pos = hdr_size
    laszip_vlr = None
    for _ in range(n_vlrs):
        user_id = data[pos + 2 : pos + 18].split(b"\x00")[0]
        record_id, rec_len = struct.unpack_from("<HH", data, pos + 18)
        if user_id == b"laszip encoded" and record_id == 22204:
            laszip_vlr = data[pos + 54 : pos + 54 + rec_len]
        pos += 54 + rec_len
    assert laszip_vlr is not None, f"{path}: not a LAZ file (no laszip VLR)"
    (compressor, coder, _vmaj, _vmin, _vrev, _opts, chunk_size, _ne, _oe,
     num_items) = struct.unpack_from("<HHBBHIIqqH", laszip_vlr, 0)
    assert compressor == 2, f"unsupported laszip compressor {compressor}"
    assert coder == 0, f"unsupported laszip coder {coder}"
    # 0xFFFFFFFF marks adaptive/variable chunking (lasreadpoint.cpp);
    # treating it as a fixed chunk size would silently corrupt coords
    assert chunk_size != 0xFFFFFFFF, \
        f"{path}: variable-chunk LAZ (chunk_size=-1) unsupported"
    items = [struct.unpack_from("<HHH", laszip_vlr, 34 + 6 * i)
             for i in range(num_items)]
    types = [t for t, _s, _v in items]
    assert types[0] == ITEM_POINT10, f"unsupported first item {types[0]}"
    for t, _s, v in items:
        assert t in (ITEM_POINT10, ITEM_GPSTIME11, ITEM_RGB12), \
            f"unsupported laszip item type {t}"
        assert v == 2, f"unsupported laszip item version {v}"
    fmt = (1 if ITEM_GPSTIME11 in types else 0) + \
        (2 if ITEM_RGB12 in types else 0)

    (table_pos,) = struct.unpack_from("<q", data, h.offset_to_points)
    chunks_start = h.offset_to_points + 8
    sizes = _read_chunk_table(data, table_pos)
    starts = [chunks_start]
    for s in sizes:
        starts.append(starts[-1] + s)

    n_total = h.num_points
    n = n_total - first if count is None else min(count, n_total - first)
    c0 = first // chunk_size
    c1 = (first + n - 1) // chunk_size if n > 0 else c0 - 1

    xs = np.zeros(n, np.int32)
    ys = np.zeros(n, np.int32)
    zs = np.zeros(n, np.int32)
    color = np.zeros(n, np.uint32)
    w = 0
    for ci in range(c0, c1 + 1):
        cn = min(chunk_size, n_total - ci * chunk_size)
        pts = _decompress_chunk(data, starts[ci], fmt, cn)
        lo = max(first - ci * chunk_size, 0)
        hi = min(first + n - ci * chunk_size, cn)
        for i in range(lo, hi):
            p, _g, c = pts[i]
            xs[w] = p["x"]
            ys[w] = p["y"]
            zs[w] = p["z"]
            r, g8, b = (v if v <= 255 else v // 256 for v in c)
            color[w] = r | (g8 << 8) | (b << 16)
            w += 1
    return LasPoints(xs, ys, zs, color, h)
