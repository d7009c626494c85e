"""Crafted inputs for the B1-B5 gates, made from a seed with numpy.

Real scenes may never produce these patterns; the kernels must still
give their plain versions' outputs bit for bit.

`fixed_batches` and `native_batches` encode clouds with the port's own
codecs (`codec.fixed`, `codec.native`) that reach the formats' corners.
Chains are laid out as the codecs cut a batch (chain c = points
[64c, 64c + 64), group c // 128); each chain's kind follows its lane, so
every group holds every kind.  fbatch: all-zero chains (widths 0, no
word a round), chains whose deltas jump by up to 2**31 (32-bit fields,
3 words a round) and chains of random widths 0..32 per component, so a
round's ranks cover 0..3 words in one group; and a batch of 32-bit
fields only, the widest group stream the format has (24,576 words).
tbatch: bucket sizes drawn from a skewed (geometric) distribution, so
the canonical code reaches its 12-bit limit; deltas of bucket 32 (31
extra bits); 2**24 jumps; all-zero chains; and a batch of full-range
deltas only, about 24.6k words per group stream.

`project_inputs` builds a chunk for `project_batches` under the exact
power-of-two frame of `tests/test_pallas_project.py` (w = 2 + z * 2**-19,
ndc = x * 2**-19 / w).  Each chain walks a few "spots": pixel centres,
and two spots whose entries clip to the sentinel (off screen, behind the
camera).  The walks repeat a pid non-contiguously along the chain
(A B A, A B..B A at gaps 1-40, A B C .. A, a few spots at random,
sentinels between equal spots) beside plain runs and one-spot chains;
the chain heads repeat with other heads between them; depths take four
values, so keys tie and the payload breaks the tie; `lodn` is partial
(one batch full, one empty).

`colors_k` gives a chunk's BC7 or raw colours in B2's layout: raw
words at random (their top byte too, which B2 drops), and BC7 mode-6
blocks (`bc7_rows`) that reach the format's
fields: every pattern of the two p bits, endpoints 0 and 127 beside
random ones, indices all 0, all 15 and random, and every value of the
3-bit anchor field, which the decoder reads with p1 as its low bit.

`hqs_streams` builds a (pid, dep, pay) stream and its depth plane for
the HQS sums: every entry on one pixel, two pixels alternating along
rows and columns, half the entries on sentinel pids, pixels whose depth
plane is EMPTY, depths exactly at the 1 % tolerance and one ulp above
it.

`resolve_streams` builds (pid, dep, pay) streams for B3's u64 min: every
entry on one pixel; two pixels alternating along rows and columns; depths
tied within each pixel, so the payload decides, in groups of 4 points of
a chain and across parts; live entries whose key is all ones (pixels
that only they reach stay EMPTY); sentinel pids; depths falling or
rising along the stream, so a compare before the atomic skips none or
nearly all; and a ragged length.

`huffman_batches` builds `.huffman` batches for B12, encoded by the
port's codec (`batch_codec.encode_streams`) from crafted deltas, in the
flat layout of the decoder's inputs: escape-heavy batches (a large
`separate`: most symbols' codes are longer than 12 bits); all codewords
12 bits long; every lane's stream a whole number of words; a
one-symbol table (1-bit codes, so the window is a whole word every 32
symbols, the `cur_bits == 32` path); the buffer's last batch cut short,
so its refills read past the end of `encoding` (the zero pad, then the
clip); and no escapes at all, with `separate` empty, but table entries
of length 0 and -3, so lanes still read the empty `separate`.  For
B12's staging: warps and lanes of one batch at very different rates
(`uneven`: a warp of 1-bit codes, 6 words a lane, a warp of escapes
only, the format's longest stream, and lanes of both kinds and of ~10-bit
codes mixed in the others); one lane per warp whose 192 symbols all
escape while its neighbours have none (`escape_lane`); four batches
whose warp streams start at every word offset mod 4, with `encoding` and
`separate` lengths that are not multiples of 4 (`unaligned`);
`cluster_sizes` 40 words per warp short of the true counts, so that
lanes read past the words their warp's count claims (`understated`);
and table lengths outside the format's [-12, 12] on the entries of the
most frequent symbol (`wild_lengths`: 13 to 40 bits, literal and
escape), so that windows run dry by more than a word.

`tile_keys` builds (T, 8, 128) int32 key planes for B10's per-tile sort:
tiles of one triple, tiles already sorted and sorted in reverse, k0 and
k1 tied so that k2 decides, keys drawn from INT32_MIN, INT32_MAX and the
sign boundary, a few whole triples repeated, and HQS-like tiles of which
half the entries carry the 1080p frame's sentinel pid.

`flat_streams` builds the flat parts of the `.las` and Potree frames (one
entry a point, file or node order; B3's and B4's flat layout): every
entry on one pixel and accepted, so that at 2**24 + 1 entries the colour
sums wrap; runs of one pixel along consecutive entries, 1 to 96 long, so
that they cross the kernels' lanes, columns, passes and tiles, some on
sentinel pids and some with one depth for the whole run, so that the
payload decides B3; and random pixels over the whole plane.
`flat_cuts` splits such a stream into uneven parts, none a multiple of
the kernels' 512-entry tile.

`las_frame` builds the per-batch tables and 10-10-10 planes of a `.las`
frame (`loop_las_parts`' arguments): every precision level 0-4 next to
each other, culled batches among them, full-range plane words (bits 30
and 31 set too), a batch of zero planes and one of all-ones fields, a
box of zero extent, one through the camera's plane (w <= 0), one off
screen and one 9 km away, on screen.

`potree_part` builds what a Potree chunk hands B3 and B4: many nodes one
after the other, each a run of nearby pixels in random order inside the
node (its points fall around one spot of the screen, in the order they
were written), whole nodes culled and the tail of budgeted nodes
dropped, in linear pixel ids.
"""

from __future__ import annotations

import numpy as np

GROUPS, LANES = 8, 128
CHAINS = GROUPS * LANES
POW2 = 2.0 ** -19
OFF_SCREEN, BEHIND = -1, -2  # spot ids of the two clipping spots
HQS_KINDS = ("one_pid", "alternating", "sentinel", "empty_depth", "mixed")
RESOLVE_KINDS = ("one_pid", "alternating", "ties", "all_ones", "sentinel", "descending",
                 "ascending", "ragged")
HUFFMAN_KINDS = ("escapes", "cw12", "boundary", "one_symbol", "last_batch",
                 "empty_separate", "uneven", "escape_lane", "unaligned", "understated",
                 "wild_lengths")
FLAT_KINDS = ("one_pixel", "runs", "random")
TILE_KINDS = ("equal", "sorted", "reverse", "k2_decides", "extremes", "repeats", "sentinel")
# the pid of an HQS entry that lands nowhere at 1920x1080: the swizzled
# id space's size, 60 x 34 tiles of 32 x 32 pixels (`raster.swizzle_dims`)
SENTINEL_1080P = 60 * 34 * 1024


def pow2_frame(batches: int):
    """-> (frame (12,) f32, tbc (batches, 4) f32): cx = x * 2**-19,
    cy = y * 2**-19, w = 2 + z * 2**-19 (tests/test_torch_project.py)."""
    frame = np.zeros(12, np.float32)
    frame[0] = frame[4] = frame[8] = POW2  # t00, t11, t32
    frame[9:12] = 1.0
    tbc = np.zeros((batches, 4), np.float32)
    tbc[:, 3] = 2.0
    return frame, tbc


def _chain_walk(kind: int, c: int, points: int, spots: int, rng) -> np.ndarray:
    """Spot ids of one chain's points."""
    a, b = rng.choice(spots, 2, replace=False)
    gap = 1 + (c // 8) % 40
    if kind == 0:  # A B A (gap 1), A B B A, ... A B*40 A
        block = [a] + [b] * gap
    elif kind == 1:  # A, then `gap` other spots, then A again
        others = [s for s in rng.permutation(spots) if s != a]
        block = [a] + [others[j % len(others)] for j in range(gap)]
    elif kind == 2:  # A B A B ... with a sentinel now and then
        block = [a, b, a, OFF_SCREEN, b]
    elif kind == 3:  # three spots at random
        return rng.choice(rng.choice(spots, 3, replace=False), points)
    elif kind == 4:  # every spot and both sentinels at random
        return rng.choice(np.r_[np.arange(spots), OFF_SCREEN, BEHIND], points)
    elif kind == 5:  # contiguous runs of 1-8
        walk = []
        while len(walk) < points:
            walk += [rng.integers(spots)] * int(rng.integers(1, 9))
        return np.asarray(walk[:points])
    elif kind == 6:  # sentinels with an A every `gap + 1` points
        block = [BEHIND] * gap + [a]
    else:  # one spot all along
        block = [a]
    return np.resize(np.asarray(block), points)


def project_inputs(batches: int, points: int, width: int, height: int,
                   seed: int = 0, spots: int = 8) -> dict:
    """-> numpy arguments of `project_batches` under the pow2 frame:
    coords (C, points, 3, 8, 128) i32, colors_k (C, 4, 2, 8, 128) u32,
    anchors (C, 3) i32, tbc (C, 4) f32, lodn (C,) i32, frame (12,) f32."""
    rng = np.random.default_rng(seed)
    pix = rng.choice(width * height, spots, replace=False)  # distinct pixels
    px, py = pix % width, pix // width
    # pixel centres at w = 2: ndc = x * 2**-20
    sx = np.rint(((px + 0.5) / width * 2 - 1) * 2**20).astype(np.int64)
    sy = np.rint(((py + 0.5) / height * 2 - 1) * 2**20).astype(np.int64)
    walks = np.stack([_chain_walk(c % 8, c, points, spots, rng)
                      for c in range(batches * CHAINS)])  # (C*1024, points)
    # chain heads from three spots and a sentinel: equal heads with
    # other heads between them
    heads = np.r_[rng.choice(spots, 3, replace=False), OFF_SCREEN]
    walks[:, 0] = rng.choice(heads, batches * CHAINS)
    on = walks >= 0
    idx = np.where(on, walks, 0)
    x = np.where(on, sx[idx], np.where(walks == OFF_SCREEN, 3 * 2**20, 0))
    y = np.where(on, sy[idx], 0)
    z = rng.integers(0, 4, walks.shape) - np.where(walks == BEHIND, 2**21, 0)
    anchors = rng.integers(0, 2**22, (batches, 3))
    rel = np.stack([x, y, z], -1).reshape(batches, GROUPS, LANES, points, 3)
    coords = (rel.transpose(0, 3, 4, 1, 2)
              + anchors[:, None, :, None, None]).astype(np.int32)
    lodn = rng.integers(0, points + 1, batches)
    lodn[0] = points
    if batches > 1:
        lodn[1] = 0
    frame, tbc = pow2_frame(batches)
    colors_k = rng.integers(0, 2**32, (batches, 4, 2, GROUPS, LANES),
                            dtype=np.uint64).astype(np.uint32)
    return dict(coords=np.ascontiguousarray(coords), colors_k=colors_k,
                anchors=anchors.astype(np.int32), tbc=tbc,
                lodn=lodn.astype(np.int32), frame=frame)


def batch_payloads(batches: int, seed: int = 0) -> np.ndarray:
    """-> (batches,) u32 per-batch payloads for B2's batch-payload mode:
    ragged runs of repeated values (equal payloads, so depth alone
    decides), 0, all ones and values with the top bit set."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 2**32, batches, dtype=np.uint64).astype(np.uint32)
    runs = np.repeat(np.arange(batches), rng.integers(1, 5, batches))[:batches]
    pay = pay[runs]
    pay[: min(batches, 2)] = (0, 0xFFFFFFFF)[: min(batches, 2)]
    return pay


def bc7_rows(batches: int, seed: int = 0) -> np.ndarray:
    """-> (batches, 16384) u32 rows of BC7 mode-6 blocks (`codec/bc7.py`'s
    layout).  Block k: p0 = k & 1, p1 = (k >> 1) & 1; its six 7-bit
    endpoints each 0, 127 or random; its indices (k >> 2) % 4: all 0,
    all 15, random, random with the anchor field (k >> 4) % 8; the mode
    and alpha bits, which the decoder ignores, random."""
    rng = np.random.default_rng(seed)
    nb = batches * 4096
    k = np.arange(nb, dtype=np.uint64)
    u = lambda v: np.asarray(v, np.uint64)  # noqa: E731
    ends = rng.integers(0, 128, (nb, 6))
    pick = rng.integers(0, 3, (nb, 6))
    ends = u(np.where(pick == 0, 0, np.where(pick == 1, 127, ends)))
    lo = u(rng.integers(0, 128, nb)) | (u(rng.integers(0, 2**14, nb)) << u(49))
    for f in range(6):
        lo |= ends[:, f] << u(7 + 7 * f)
    lo |= (k & u(1)) << u(63)
    rand = rng.integers(0, 2**63, nb, dtype=np.int64).astype(np.uint64) << u(1)
    kind = (k >> u(2)) % u(4)
    hi = np.where(kind == 0, u(0), np.where(kind == 1, ~u(0), rand))
    anchor = ((k >> u(4)) % u(8)) << u(1)
    hi = np.where(kind == 3, (hi & ~u(0xE)) | anchor, hi)
    hi = (hi & ~u(1)) | ((k >> u(1)) & u(1))
    mask = u(0xFFFFFFFF)
    words = np.stack([lo & mask, lo >> u(32), hi & mask, hi >> u(32)], -1)
    return words.astype(np.uint32).reshape(batches, 16384)


def colors_k(batches: int, color_fmt: str, seed: int = 0) -> np.ndarray:
    """-> (batches, *bc1_layout.COLOR_K_SHAPE[color_fmt]) u32: a chunk's
    BC7 blocks (`bc7_rows`) or raw words (random, top byte included) in
    B2's layout."""
    from ..render.bc1_layout import colors_kernel_layout

    if color_fmt == "bc7":
        return colors_kernel_layout(bc7_rows(batches, seed), "bc7")
    if color_fmt != "raw":
        raise ValueError(f"no crafted {color_fmt!r} colours")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (batches, 65536), dtype=np.uint64).astype(np.uint32)
    return colors_kernel_layout(rows, "raw")


def _batch_coords(deltas: np.ndarray, rng):
    """(1024, 63, 3) i64 chain deltas -> x, y, z (65536,) i32 whose chains
    (from random starts, wrapping mod 2**32) have exactly these deltas."""
    starts = rng.integers(-(2**31), 2**31, (CHAINS, 1, 3))
    pts = np.concatenate([starts, starts + np.cumsum(deltas, axis=1)], axis=1)
    pts = ((pts + 2**31) % 2**32 - 2**31).astype(np.int32).reshape(-1, 3)
    return pts[:, 0], pts[:, 1], pts[:, 2]


def _full_range(rng, shape):
    """Deltas over the whole int32 range, each chain component holding
    -2**31 (zigzag 2**32 - 1: a 32-bit field, bucket 32) at least once."""
    d = rng.integers(-(2**31), 2**31, shape)
    d[:, rng.integers(shape[1])] = -(2**31)
    return d


def fixed_batches(seed: int = 0) -> list:
    """-> [FixedBatch, FixedBatch]: the fbatch corners (module doc)."""
    from ..codec.fixed import encode_fixed_batch

    rng = np.random.default_rng(seed)
    shape = (CHAINS, 63, 3)
    lane = np.arange(CHAINS) % LANES
    # random widths 0..32 per chain component; the first delta has all
    # w bits, so the encoder picks exactly w
    width = rng.integers(0, 33, (CHAINS, 1, 3))
    half = np.where(width > 0, 2.0 ** (width - 1), 0).astype(np.int64)
    d = rng.integers(-half, np.maximum(half, 1), shape)
    d[:, 0] = -half[:, 0]  # zigzag 2**w - 1
    d[lane % 8 == 0] = 0
    d[lane % 8 == 1] = _full_range(rng, shape)[lane % 8 == 1]
    mixed = encode_fixed_batch(*_batch_coords(d, rng))
    wide = encode_fixed_batch(*_batch_coords(_full_range(rng, shape), rng))
    return [mixed, wide]


def native_batches(seed: int = 0) -> list:
    """-> [NativeBatch, NativeBatch]: the tbatch corners (module doc)."""
    from ..codec.native import encode_native_batch

    rng = np.random.default_rng(seed)
    shape = (CHAINS, 63, 3)
    lane = (np.arange(CHAINS) % LANES)[:, None, None]
    # skewed: bucket b in 1..32 with probability ~2**-b, any value in it
    bucket = np.minimum(rng.geometric(0.5, shape), 32)
    zz = (2 ** (bucket - 1) + rng.integers(0, 2 ** (bucket - 1))).astype(np.int64)
    d = (zz >> 1) ^ -(zz & 1)
    d = np.where(lane % 8 == 0, 0, d)  # all-zero chains
    steps = rng.integers(-80, 80, shape) + rng.integers(-(2**24), 2**24, shape) * (
        rng.random(shape) < 0.05)
    d = np.where(lane % 8 == 1, steps, d)  # small steps and 2**24 jumps
    d = np.where(lane % 8 == 2, _full_range(rng, shape), d)  # bucket 32
    corners = encode_native_batch(*_batch_coords(d, rng))
    wide = encode_native_batch(*_batch_coords(_full_range(rng, shape), rng))
    return [corners, wide]


def hqs_streams(kind: str, rows: int, size: int, seed: int = 0):
    """-> (pid, dep, pay, fb_depth) u32 arrays: a stream of rows x 1024
    entries of the given kind (`HQS_KINDS`) and its (size,) depth plane,
    the per-pixel min depth of the live entries, EMPTY elsewhere."""
    rng = np.random.default_rng(seed)
    n = rows * CHAINS
    pixels = rng.choice(size, 64, replace=False)
    pid = rng.choice(pixels, n)
    if kind == "one_pid":
        pid[:] = pixels[0]
    elif kind == "alternating":  # along the flat order and along columns
        r, c = np.divmod(np.arange(n), CHAINS)
        pid = np.where((r + c) % 2 == 0, pixels[0], pixels[1])
    elif kind in ("sentinel", "mixed"):
        dead = rng.random(n) < 0.5
        pid[dead] = rng.choice([size, size + 1, 2**32 - 1], int(dead.sum()))
    if kind == "mixed":  # whole 32-row bands on one pixel, up to half the rows
        pid[: min(32, rows // 2) * CHAINS] = pixels[2]
    pid = pid.astype(np.uint32)
    live = pid < size
    # each pixel's depths straddle its 1 % tolerance
    spix = np.sort(pixels)
    near = (1 + rng.random(64) * 100).astype(np.float32)
    w = np.ones(n, np.float32)
    w[live] = near[np.searchsorted(spix, pid[live])] * (
        1 + rng.random(int(live.sum())).astype(np.float32) * np.float32(0.02))
    dep = w.view(np.uint32)
    pay = rng.integers(0, 2**24, n, dtype=np.uint64).astype(np.uint32)
    fbd = np.full(size, 0xFFFFFFFF, np.uint32)
    np.minimum.at(fbd, pid[live], dep[live])
    if kind in ("empty_depth", "mixed"):  # EMPTY (a NaN) accepts nothing
        fbd[pixels[1::2]] = 0xFFFFFFFF
    # depths exactly at the tolerance (accepted) and one ulp above it
    edge = np.flatnonzero(live & (fbd[np.minimum(pid, size - 1)] != 0xFFFFFFFF))
    if edge.size:
        pick = rng.choice(edge, min(edge.size, 2 * 64), replace=False)
        limit = fbd[pid[pick]].view(np.float32) * np.float32(1.01)
        half = pick.size // 2
        dep[pick[:half]] = limit[:half].view(np.uint32)
        dep[pick[half:]] = np.nextafter(limit[half:], np.float32(np.inf)).view(np.uint32)
    return pid, dep, pay, fbd


def resolve_streams(kind: str, rows: int, size: int, seed: int = 0):
    """-> (pid, dep, pay) u32 arrays: a stream of rows x 1024 entries (515
    fewer for `ragged`) of the given kind (`RESOLVE_KINDS`) for B3."""
    rng = np.random.default_rng(seed)
    n = rows * CHAINS - (515 if kind == "ragged" else 0)
    r, c = np.divmod(np.arange(n), CHAINS)  # point index, chain
    pixels = rng.choice(size, 64, replace=False)
    pid = rng.choice(pixels, n)
    dep = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(0, 2**24, n, dtype=np.uint64).astype(np.uint32)
    if kind == "one_pid":
        pid[:] = pixels[0]
    elif kind == "alternating":  # along the flat order and along columns
        pid = np.where((r + c) % 2 == 0, pixels[0], pixels[1])
    elif kind == "ties":  # 4 points of a chain per pixel, one depth per pixel
        pid = pixels[(r // 4 + c) % 16]
        dep = (0x3F800000 + pid % 3).astype(np.uint32)
    elif kind == "all_ones":  # half the pixels only ever see the all-ones key
        ones = np.isin(pid, pixels[::2]) | (rng.random(n) < 0.25)
        dep[ones] = 0xFFFFFFFF
        pay[ones] = 0xFFFFFFFF
    elif kind == "sentinel":
        dead = rng.random(n) < 0.5
        pid[dead] = rng.choice([size, size + 1, 2**32 - 1], int(dead.sum()))
    elif kind in ("descending", "ascending"):  # distinct, monotone along the stream
        step = np.arange(n) if kind == "ascending" else n - 1 - np.arange(n)
        dep = (0x3F800000 + step).astype(np.uint32)
    return pid.astype(np.uint32), dep, pay


def tile_keys(kind: str, tiles: int, seed: int = 0):
    """-> (k0, k1, k2) int32 arrays of shape (tiles, 8, 128) of the given
    kind (`TILE_KINDS`), for the per-tile sort by (k0, k1, k2) as signed
    int32."""
    rng = np.random.default_rng(seed)
    shape = (tiles, CHAINS)  # a tile holds as many entries as a batch has chains
    full = lambda size: rng.integers(-2**31, 2**31, size, dtype=np.int64)
    keys = [full(shape) for _ in range(3)]
    if kind == "equal":  # one triple per tile
        keys = [np.repeat(full((tiles, 1)), CHAINS, axis=1) for _ in range(3)]
    elif kind in ("sorted", "reverse"):
        keys = [rng.integers(-8, 8, shape), rng.integers(-8, 8, shape), keys[2]]
        order = np.lexsort(keys[::-1], axis=-1)
        if kind == "reverse":
            order = order[:, ::-1]
        keys = [np.take_along_axis(k, order, axis=1) for k in keys]
    elif kind == "k2_decides":  # k0 and k1 one value per tile
        keys[0] = np.repeat(full((tiles, 1)), CHAINS, axis=1)
        keys[1] = np.repeat(full((tiles, 1)), CHAINS, axis=1)
    elif kind == "extremes":
        corners = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1])
        keys = [rng.choice(corners, shape) for _ in range(3)]
    elif kind == "repeats":  # 16 distinct triples per tile
        which = rng.integers(0, 16, shape)
        keys = [np.take_along_axis(full((tiles, 16)), which, axis=1) for _ in range(3)]
    elif kind == "sentinel":  # an HQS tile: pid, f32 depth bits, 24-bit payload
        pid = rng.integers(0, SENTINEL_1080P, shape)
        pid[rng.random(shape) < 0.5] = SENTINEL_1080P
        dep = (1 + rng.random(shape) * 100).astype(np.float32).view(np.int32)
        keys = [pid, dep, rng.integers(0, 2**24, shape)]
    return tuple(k.astype(np.int32).reshape(tiles, GROUPS, LANES) for k in keys)


def _huffman_deltas(kind: str, rng) -> np.ndarray:
    """(1024, 192) i32 interleaved deltas of one batch of `kind`."""
    shape = (CHAINS, 192)
    if kind == "escapes":  # 20,000 rare values beside a few common ones
        rare = rng.integers(-(2**31), 2**31, 20000)
        d = np.where(rng.random(shape) < 0.8, rng.choice(rare, shape),
                     rng.integers(-3, 4, shape))
    elif kind == "cw12":  # 4096 values 48 times each: every code 12 bits
        d = rng.permutation(np.repeat(np.arange(-2048, 2048), 48)).reshape(shape)
    elif kind == "boundary":  # 16 values 12,288 times each: 4-bit codes
        d = rng.permutation(np.repeat(np.arange(16) * 1000 - 7000, 12288)).reshape(shape)
    elif kind == "one_symbol":
        d = np.full(shape, 7)
    elif kind == "uneven":
        d = _uneven_deltas(shape, rng)
    elif kind == "escape_lane":  # lane 5w % 32 of warp w: 192 distinct rare values
        d = rng.integers(-40, 41, shape)
        lanes = np.arange(32) * 32 + np.arange(32) * 5 % 32
        d[lanes] = _distinct_rare(lanes.size * 192, rng).reshape(lanes.size, 192)
    elif kind == "unaligned":  # lane l's deltas within +-2**(l % 12): lengths vary
        d = rng.integers(-(2 ** 11), 2 ** 11 + 1, shape) >> (11 - np.arange(CHAINS) % 12)[:, None]
    else:  # "last_batch", "empty_separate", "understated": 81 values, no escapes
        d = rng.integers(-40, 41, shape)
    return d.astype(np.int32)


def _distinct_rare(n: int, rng) -> np.ndarray:
    """n distinct values far from every common one: each escapes."""
    return rng.permutation(100_000 + 7 * np.arange(n)) * rng.choice([-1, 1], n)


def _uneven_deltas(shape, rng) -> np.ndarray:
    """Warp 0 all zeros (zero is over half the batch's symbols: a 1-bit
    code), warp 1 all distinct rare values (escapes), warp 2 256 values
    (~10-bit codes); in the other warps each lane is one of these or
    zeros with a few small values, by (lane + 3 warp) % 8."""
    warp, lane = np.divmod(np.arange(CHAINS), 32)
    mode = np.array([0, 0, 0, 2, 2, 1, 3, 3])[(lane + 3 * warp) % 8]
    mode[warp == 0], mode[warp == 1], mode[warp == 2] = 0, 1, 3
    d = np.zeros(shape, np.int64)
    small = np.where(rng.random(shape) < 0.9, 0, rng.integers(1, 17, shape))
    d[mode == 2] = small[mode == 2]
    d[mode == 3] = rng.integers(-128, 128, shape)[mode == 3]
    rare = mode == 1
    d[rare] = _distinct_rare(int(rare.sum()) * shape[1], rng).reshape(-1, shape[1])
    return d


def huffman_batches(kind: str, batches: int = 2, seed: int = 0) -> dict:
    """-> dict of the decoder's flat inputs (`decode_ref_plain`'s names;
    `encoding` u32, the rest i32) for `batches` batches of `kind`
    (`HUFFMAN_KINDS`, module doc)."""
    from ..codec.batch_codec import encode_streams

    rng = np.random.default_rng(seed)
    if kind == "unaligned":
        batches = max(batches, 4)
    parts = [encode_streams(_huffman_deltas(kind, rng)) for _ in range(batches)]
    enc = [p[0] for p in parts]
    sep = [p[1] for p in parts]
    out = dict(
        encoding=np.concatenate(enc).astype(np.uint32),
        enc_offsets=np.cumsum([0] + [len(e) for e in enc[:-1]]).astype(np.int32),
        cluster_sizes=np.stack([p[3] for p in parts]).astype(np.int32),
        separate=np.concatenate(sep).astype(np.int32),
        sep_offsets=np.cumsum([0] + [len(x) for x in sep[:-1]]).astype(np.int32),
        separate_sizes=np.stack([p[2] for p in parts]).astype(np.int32),
        table_values=np.stack([p[4] for p in parts]).astype(np.int32),
        table_cw_len=np.stack([p[5] for p in parts]).astype(np.int32),
        start_values=rng.integers(-(2**31), 2**31, (batches, CHAINS, 3)).astype(np.int32),
    )
    if kind == "last_batch":  # the last 200 words of the buffer are gone
        out["encoding"] = out["encoding"][:-200]
    if kind == "empty_separate":
        tl = out["table_cw_len"]
        tl[:, 5::97] = 0
        tl[:, 11::89] = -3
    if kind == "unaligned":  # a ragged tail after the last batch's words
        for k, dtype in (("encoding", np.uint32), ("separate", np.int32)):
            if out[k].size % 4 == 0:
                out[k] = np.append(out[k], dtype(12345))
    if kind == "understated":
        out["cluster_sizes"] -= 40 * np.arange(1, 33, dtype=np.int32)
    if kind == "wild_lengths":  # every 5th entry of the shortest code
        wild = np.array([13, 20, 31, 32, 33, 40, -13, -20, -33, -40], np.int32)
        for tl in out["table_cw_len"]:
            idx = np.flatnonzero(tl == tl[tl > 0].min())[::5]
            tl[idx] = np.resize(wild, idx.size)
    return out


def potree_part(nodes: int, width: int, height: int, seed: int = 0):
    """-> (pid, dep, pay, colour, fb_depth) u32 arrays: one part of
    `nodes` nodes of 256-8192 points each, in linear pixel ids of a
    width x height frame.  A node's points land in a square of 4-64
    pixels a side around its own spot, in random order; a tenth of the
    nodes are culled (every pid `width * height`) and a third keep only a
    prefix (the rest dropped, as a node budget's mask leaves them);
    depths lie within 3 % of the node's own, so that some entries fall
    outside the HQS tolerance; the payload is the global index, the
    colour random.  fb_depth is the depth half of the part's u64-min
    plane (B4's prepass), EMPTY where nothing lands."""
    rng = np.random.default_rng(seed)
    size = width * height
    counts = rng.integers(256, 8193, nodes)
    n = int(counts.sum())
    node = np.repeat(np.arange(nodes), counts)
    side = rng.integers(4, 65, nodes)[node]
    cx, cy = rng.integers(0, width, nodes)[node], rng.integers(0, height, nodes)[node]
    px = np.clip(cx + rng.integers(0, 1 << 16, n) % side - side // 2, 0, width - 1)
    py = np.clip(cy + rng.integers(0, 1 << 16, n) % side - side // 2, 0, height - 1)
    pid = (px + py * width).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.arange(n) - starts[node]
    take = np.where(rng.random(nodes) < 1 / 3, rng.integers(1, counts + 1), counts)
    culled = rng.random(nodes) < 0.1
    pid[culled[node] | (local >= take[node])] = size
    near = (1 + rng.random(nodes) * 500).astype(np.float32)
    w = near[node] * (1 + rng.random(n).astype(np.float32) * np.float32(0.03))
    dep = w.view(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    colour = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    fbd = np.full(size, 0xFFFFFFFF, np.uint32)
    live = pid < size
    np.minimum.at(fbd, pid[live], dep[live])
    return pid.astype(np.uint32), dep, pay, colour, fbd


def flat_streams(kind: str, n: int, size: int, seed: int = 0):
    """-> (pid, dep, pay, colour, fb_depth) u32 arrays: n entries of the
    given kind (`FLAT_KINDS`) in flat order, the payload the entry's
    index, the colour random, and fb_depth the min depth of the live
    entries on each pixel (B4's prepass), EMPTY elsewhere.  Depths lie
    within 3 % of a pixel's own, so some fall outside B4's 1 %; on
    `runs` and `random` some landed pixels have an EMPTY depth plane (a
    NaN: nothing is accepted) and some entries lie exactly at the
    tolerance or one ulp above it."""
    rng = np.random.default_rng(seed)
    pixels = rng.choice(size, min(size, 500), replace=False)
    if kind == "one_pixel":  # every entry accepted: the sums wrap past 2**24
        pid = np.full(n, pixels[0], np.int64)
        dep = np.full(n, 0x3F800000, np.uint32)
        return (pid.astype(np.uint32), dep, np.arange(n, dtype=np.uint32),
                np.full(n, 0xFFFFFFFF, np.uint32), _depth_plane(pid, dep, size))
    if kind == "runs":
        lens = rng.integers(1, 97, n // 24 + 2)  # 48.5 on average: enough runs
        lens = lens[: np.searchsorted(np.cumsum(lens), n) + 1]
        run_pid = rng.choice(pixels, lens.size).astype(np.int64)
        dead = rng.random(lens.size) < 0.1
        run_pid[dead] = rng.choice([size, size + 1, 2**32 - 1], int(dead.sum()))
        pid = np.repeat(run_pid, lens)[:n]
        tied = np.repeat(rng.random(lens.size) < 0.25, lens)[:n]
    else:
        pid = rng.integers(0, size, n).astype(np.int64)
        pid[rng.random(n) < 0.25] = size
        tied = np.zeros(n, bool)
    near = (1 + (pid % 997).astype(np.float32) * np.float32(0.5))
    w = near * (1 + rng.random(n).astype(np.float32) * np.float32(0.03))
    w[tied] = near[tied]  # one depth for the run: the payload decides
    dep = w.view(np.uint32)
    fbd = _depth_plane(pid, dep, size)
    live = pid < size
    landed = np.unique(pid[live])
    fbd[landed[: landed.size // 20]] = 0xFFFFFFFF
    edge = np.flatnonzero(live & (fbd[np.minimum(pid, size - 1)] != 0xFFFFFFFF))
    pick = rng.choice(edge, min(edge.size, 200), replace=False)
    limit = fbd[pid[pick]].view(np.float32) * np.float32(1.01)
    half = pick.size // 2
    dep[pick[:half]] = limit[:half].view(np.uint32)
    dep[pick[half:]] = np.nextafter(limit[half:], np.float32(np.inf)).view(np.uint32)
    colour = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return pid.astype(np.uint32), dep, np.arange(n, dtype=np.uint32), colour, fbd


def _depth_plane(pid, dep, size: int):
    """The (size,) min depth of the entries with pid < size, EMPTY elsewhere."""
    fbd = np.full(size, 0xFFFFFFFF, np.uint32)
    live = pid < size
    np.minimum.at(fbd, pid[live], dep[live])
    return fbd


def flat_cuts(n: int, parts: int, seed: int = 0) -> list:
    """Cut points [0, ..., n] of `parts` uneven, non-empty parts of n
    entries, none a multiple of 512 entries long."""
    rng = np.random.default_rng(seed)
    while True:
        inner = np.sort(rng.choice(np.arange(1, n), parts - 1, replace=False))
        cuts = [0, *inner.tolist(), n]
        if all((b - a) % 512 for a, b in zip(cuts, cuts[1:])):
            return cuts


def las_frame(batches: int, width: int, height: int, seed: int = 0) -> dict:
    """-> numpy arguments of `loop_las_parts` for `batches` (>= 10)
    batches (module doc): xyz4, xyz8, xyz12 (batches * 65536,) i32, level
    and vis (batches,) i32, bmin and bmax (batches, 3) f32, transform
    (4, 4) f32, a perspective 100 m from the origin looking down -z."""
    rng = np.random.default_rng(seed)
    n = batches * CHAINS * 64
    planes = {k: rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
              for k in ("xyz4", "xyz8", "xyz12")}
    b = CHAINS * 64
    for k in planes:
        planes[k][5 * b:6 * b] = 0
        planes[k][6 * b:7 * b] = 1023 * (1 + 1024 + 1024**2)
    level = rng.integers(0, 5, batches).astype(np.int32)
    level[:10] = np.arange(10) % 5
    vis = (rng.random(batches) > 0.15).astype(np.int32)
    vis[:10] = 1
    vis[3] = vis[batches - 1] = 0
    centre = rng.uniform([-40, -25, -20], [40, 25, 20], (batches, 3))
    extent = rng.uniform(0.5, 30.0, (batches, 3))
    extent[7] = 0.0  # every point on bmin
    centre[8], extent[8] = (0.0, 0.0, 100.0), (20.0, 20.0, 40.0)  # through the camera
    centre[9], extent[9] = (900.0, 0.0, 0.0), (10.0, 10.0, 10.0)  # off screen
    centre[6], extent[6] = (3000.0, 2000.0, -9000.0), (500.0, 500.0, 50.0)  # 9 km away
    bmin = (centre - extent / 2).astype(np.float32)
    bmax = (bmin + extent).astype(np.float32)
    f = 1.0 / np.tan(np.deg2rad(60.0) / 2.0)
    near, far = 0.1, 1000.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f * height / width, f
    proj[2, 2], proj[2, 3] = (far + near) / (near - far), 2.0 * far * near / (near - far)
    proj[3, 2] = -1.0
    view = np.eye(4)
    view[2, 3] = -100.0
    return dict(**planes, level=level, vis=vis, bmin=bmin, bmax=bmax,
                transform=(proj @ view).astype(np.float32))
