#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`pcrhpg24_tpu_torch`).

Run from the repo root on a host with one NVIDIA H100:

    python3 chip_smoke.py [--batches 256] [--potree-points 5e7] [--potree-budget N]

Phases, each of which exits non-zero on failure:
 1. environment: card name and power limit, torch, CUDA, nvcc;
 2. build: every kernel (B1-B6, B8-B10, B12) from `csrc/` with one nvcc
    per source, all started together, then one link;
 3. scenes: bench.py's synthetic terrain (`--batches` x 65,536 points,
    cached under out/) written by the port's own preprocessor three
    times, as `.tpc` v2 (fbatch), as `.tpc` v1 (tbatch) and as
    `.huffman` (the reference's own format), and by the port's Potree
    builder and `.wg` converter as `.wg`; all loaded onto the card; and
    as `.tpc` v2 with BC7 and with raw colours (each one's write and load
    time and resident bytes);
 4. kernel gates, each kernel bit-exact against its plain torch version
    on the card: B1 (and the NumPy protocol mirror) and B5 (and its
    NumPy mirror) at points 64 and 32; B2 and B3 for bench.py's three
    views in colour and HQS modes, and B2 in batch-payload mode (the
    batch index, the LOD count) with and without collapse; B3 and B4 on
    the orbit view's uncollapsed streams of every live chunk, and B3 on
    its colour streams; B2 in BC7 and raw mode (the BC7 and raw scenes'
    colours) at the same chunks, colour and HQS; B6 on the parametric frame's pid-sorted
    stream for each of its views and on the colour orbit chunk's stream
    sorted by pid, where it must also equal B3's planes; B8 on that
    stream sorted by (pid, depth, payload), equal to B3's planes, with
    and without the depth plane; B9 on the HQS orbit chunk's stream
    sorted by pid, equal to B4's sums; B10 on the first 4,096 tiles of
    that stream, also against `np.lexsort`.  Each kernel is also held
    against its plain version run on the CPU on a cut-down input, the
    path the CPU tests hold to the JAX reference.  Crafted inputs
    (`tools/crafted.py`) that the terrain may never produce: B1 and B5
    on batches encoded by the port's codecs
    that reach the formats' corners (all-zero chains, 32-bit fields and
    bucket-32 deltas, 2**24 jumps, 12-bit codes, every fbatch round count
    0..3 in one group, the widest group streams), against their plain
    versions and the NumPy mirrors at points 64, 48, 32, 16 and 40, and
    with every 7th round pointer moved back (the kernels' device-memory
    fallback) against their plain versions; B2 on 64-batch chunks whose pids repeat
    non-contiguously along a chain (A B A, A B..B A at gaps 1-40) and
    across equal chain heads, with sentinels, tied depths and a partial
    lodn, at points 16, 32, 48 and 64 (the LOD buckets) and 40 (the
    build that takes the count at run time), steps 6 and 3, colour (with
    and without the chain-head ladder) and HQS modes, at points 16, 40 and
    64 each also in batch-payload mode with a ragged per-batch payload
    (`crafted.batch_payloads`), and each in BC7 mode on crafted blocks
    (`crafted.bc7_rows`: every p-bit pattern, endpoints 0 and 127,
    indices 0 and 15, every anchor field) and in raw mode on random words
    with their top byte set; B4 on 4M-entry streams
    (every entry on one pixel, two pixels alternating, sentinel pids,
    EMPTY depths, depths at the tolerance and one ulp above it) split
    into uneven parts, one of them into 70 parts (two launches), and on
    2**24 + 1 entries of one pixel, whose sums wrap; B3 on 4M-entry
    streams (`crafted.resolve_streams`: one pixel, two alternating
    pixels, depths tied so the payload decides, all-ones keys, sentinel
    pids, depths falling and rising along the stream, a ragged length),
    each split into 4 uneven parts and into 70 (two launches), in both
    part orders, and on 2**24 + 1 entries of one pixel; B3 and B4 on a
    crafted Potree part (`crafted.potree_part`: 2,000 nodes, each a run of
    nearby pixels in random order, culled nodes and budget tails), in
    one call and in two groups into a running plane and accumulator; B3
    and B4 in both layouts (`layout="flat"`, the `.las` and Potree
    parts' kernels, and `"chain"`) on flat crafted streams
    (`crafted.flat_streams`: one pixel over 2**24 + 1 entries, whose B4
    sums wrap, runs of one pixel along consecutive entries, random
    pixels) in 4 and in 70 uneven parts none a multiple of the flat
    tile's 512 entries, both part orders; B10 on crafted
    tiles (`crafted.tile_keys`: one triple per tile, sorted, reverse
    sorted, k0 and k1 tied so that k2 decides, INT32_MIN, INT32_MAX and
    the sign boundary in every key, repeated triples, the HQS sentinel
    pid) at 4,097, 1 and 0 tiles, against its plain version and
    `np.lexsort`; B12 on the first 64-batch chunk of the `.huffman` scene
    at points 64 and 32, against its plain version (and the plain
    version on the CPU on 4 batches), and against the port's C++
    `.huffman` decoder on two batches; and on crafted batches
    (`crafted.huffman_batches`: escape-heavy, all codewords 12 bits,
    every lane's stream whole words, a one-symbol table, the buffer's
    last batch cut short so refills read past its end, an empty
    `separate` read by escapes of length 0 and -3; and for its staging
    in shared memory, warps and lanes of one batch from 1-bit codes to
    escapes only, one all-escape lane per warp, warp streams at every
    word offset mod 4 in buffers of ragged length, understated
    `cluster_sizes`, and table lengths outside [-12, 12], which take
    its checked steps) at points 64, 48, 32, 16 and 40;
 5. main paths at 1920x1080, each view 2 warm + 10 timed frames, with
    every kernel's launch count reset just before and read just after:
    through `pcrhpg24_tpu_torch.app`, `huffman_tpu` on v2 (B1, B2, B3),
    `huffman_tpu_hqs` on v2 (B1, B2, B3, B4) and `huffman_tpu` on v1
    (B5, B2, B3), and on the `.huffman` scene `huffman_mem_iter` (B12,
    B2, B3), `huffman_hqs` (B12, B3, B4) and `huffman_tpu` on the
    load-time transcode (B1, B2, B3; its image must also equal
    `huffman_tpu`'s on the `.tpc` v2), `huffman_tpu` and
    `huffman_tpu_hqs` on the BC7 and the raw `.tpc` v2 (B2 in those
    modes; every pixel of the raw colour frame one of the scene's input
    colours), at bench.py's three views and a
    close-up of the scene's far corner, which must leave at least one
    64-batch chunk with no batch in view (the live-chunk skip; each
    frame's live chunks are printed), and `--scene parametric` (B6) at three cameras
    on the radius-10 sphere; through `Renderer.loop` and the method class,
    `loop_nodes_compressed` on the `.wg` scene (B6) at bench.py's views;
    through the app, the `.las` scene's nine methods (the source paper's
    baselines: `loop_las`, `loop_las2`, `loop_las_hqs`, `basic`, the
    four 2021 variants and `2021 hqs`) at the `.tpc` paths' four views,
    and `basic` on the multi-file scene at the orbit view: B3 exactly
    once a frame, B4 exactly once an HQS frame, both in their flat
    layout (`pcr_u64_min_flat`, `pcr_hqs_sums_flat`), and no other
    kernel; B3 and B4 in both layouts also held against their plain
    versions on the `loop_las_hqs` orbit frame's parts, and the
    `[groups]` lines count the atomic sets of each layout there; the Potree scene written by the port's
    `synth_potree` (`--potree-points`, under `--potree-budget` resident
    points) and loaded once through the app's `build_methods` and
    `wait_loaded`, with a mid-load frame of each method, then
    `loop_nodes` (B3 alone) and `loop_nodes_hqs` (B3 and B4 alone, in
    their flat layout) through
    `Renderer.loop` at three views (the reference's 1B-point run's steady
    camera, an overview, and a corner close-up that must leave a
    16.7M-point chunk culled), unbudgeted and at `Debug.node_budget = 2`,
    whose compact frame must also equal the masked frame; B3 and B4 in
    both layouts held against their plain versions on the steady
    frame's parts, and their `[groups]` lines.
    Each listed kernel must have launched (B3
    exactly once per frame on the `.tpc`, `.huffman` and `.las` paths),
    and each image (and on the `.las` paths each plane left in
    `last_fb`) must show points and equal, bit for bit, the frame built
    from the plain torch versions alone;
 5b. the flagship frame's other outputs, through the app: on colour v2,
    colour v1 (`huffman_tpu`) and colour `.huffman` (`huffman_mem_iter`)
    at the orbit and corner views, each of `--colorize-chunks`,
    `--show-num-points`, `--colorize-overdraw`, `--show-bounding-box`,
    `--edl` and `--depth FILE`, and `--edl` and `--depth FILE` on the
    `.las` scene's `loop_las` at the orbit view: B2 and the decoder
    launched (not on `loop_las`), B3 once a
    frame (none in `huffman_tpu`'s overdraw frame, which counts entries
    instead), the image and the planes left in `last_fb` bit-exact
    against the same frame built from the plain versions, the depth file
    read back equal to the depth plane; one `--trace` run whose Chrome
    trace names `pcr_decode_fixed`, `pcr_project` and `pcr_u64_min` and
    holds kernels run on the card; the viewer (`engine/viewer.py`) on an
    ephemeral localhost port, whose `/frame` is byte-equal to the PNG of
    the app's colour v2 orbit image;
 5c. the sharded frames (`pcrhpg24_tpu_torch/parallel/`, ROADMAP A12):
    `parallel.dryrun.dryrun_multichip` starts two rank processes on the
    card, joined over `gloo` (whose collectives stage the planes through
    the host), each rendering its batches with the kernels above; the
    colour and HQS frames of the BC1 and BC7 `.tpc` v2 scenes (the BC7
    one with its last batch left out, so that dp = 2 does not divide
    the batch count: ROADMAP C4) as dp = 2 x sp = 1 and dp = 1 x sp = 2
    at the orbit view, and the `.huffman` path on the whole `.huffman`
    scene (256 batches) in both layouts; each rank holds its rows to
    the single-process frame; the all-reduce of a 1920x1080 u64 plane
    (MIN) and of the four HQS sum planes (SUM) is timed;
 6. times: median device frame (CUDA events), points/s, and each kernel
    beside its plain version, its bound and, where one PyTorch call
    computes the same function, that call, at the frame's shapes (one
    orbit chunk; B6 at the parametric frame's); B2 in colour, HQS and
    batch-payload mode, and in BC7 and raw mode on those scenes' orbit
    chunk (five rows); B3 per chunk and over the orbit
    frame's parts in one call, colour and HQS (three rows); B3 and B4 in
    their flat layout over the `loop_las` orbit frame's parts (two more
    rows), and over the `loop_nodes` steady frame's parts (two more),
    each with a model of the L2 sectors of its random accesses (the
    `[l2 model]` lines: counted from the inputs, not measured) and the
    chain layout's kernel on the same parts; the flat layout's kernels on
    the chain rows' parts (orbit chunk, the frame's parts), held to the
    chain kernels' planes; `index_add_` (the B4 rows' library call) adds
    the accepted entries only, the accept test left out of its time; the device
    time of the `.las` projections (torch ops) of `loop_las`, `basic`
    and `2021 early-z` at the orbit view; B4's and B3's
    planes handed on as
    strided views against a contiguous split, through their consumers.
    Each kernel's `ms` brackets the wrapper call as the host enqueues
    it, so a wrapper whose host side outlasts its kernel reads the
    host's time; its `device_ms` is the same call
    enqueued behind a ~1 ms device spin, so the events bracket device
    work alone; for B3 and B6 `kernel_device_ms` is one launch of the
    kernel alone into a plane filled before the spin, and
    `kernel_bound_ms` its bound: the stream read and 8 B written for
    each pixel a live entry lands in (`bound_ms`, the wrapper's, writes
    the whole plane).  B8, B9 and B10
    are reached by no method of the reference: their launches are 0.
    B12's resources: registers, shared memory per block, blocks and
    warps resident per SM, blocks per chunk and per SM; and the timed
    chunk's streams: words per warp stream, refills per lane, escapes
    per lane and per warp run, and the runs over the kernel's staging
    cap.  What the debug modes, the depth plane, EDL and the overlay add
    to the event-timed frame, and the device time of the depth
    unswizzle, `edl_shade` and `draw_bounding_boxes` alone
    (`utils/devtime.device_ms`);
 6b. probes (`pcrhpg24_tpu_torch/experiments/`, the card counterparts of
    the TPU probes of B3's merge, ROADMAP queue D): their library, built
    by `experiments/probes.py` in a thread while phase 3 runs, then
    `exp_pallas_scatter_probe` (random atomicMins from one thread, one
    warp and a full grid: 8192 int32 into 1 MB, and u64 keys at the
    `.las` and Potree parts' entry counts into the 1080p plane and a
    256 MiB one, timed by the slope of 1 and 5 chained launches),
    `r3_mat_lesion` (B3's stages: full, atomic-all, no-atomic, floor,
    no-load and count, in both layouts, on the orbit chunk, the orbit
    frame's colour parts, the `.las` orbit part and the Potree steady
    parts; full timed in turns with the shipped `u64_min_planes` and
    within 3% of it), `r4_floor` (the chain tile's noop, prep, full and
    nodma on the most populated chunk at bench.py's three views and the
    corner) and `r4_winsize` (chain tiles of 16, 8 and 4 columns, flat
    passes of 8 and 4, on the parts of `r3_mat_lesion`).  Each exact
    variant is held bit-exact to `u64_min_planes_plain` (the scatter
    probe to `scatter_reduce_`), each lesion's checksum to its plain
    version; each prints `[probe]` lines, and each probe kernel is a row
    of the kernels line with 0 launches (no path reaches it).  Then the
    decoders' and B2's probes: `exp_pallas_variants` (B5's variants
    full, ladder, rank-scan, no-table, no-window, no-refill and
    no-refill-no-table, one launch alone, on the TPU probe's input and on
    the v1 scene's busiest orbit chunk, with B5's stage split),
    `exp_variant_slope` (the same by the slope of 1 and 9 chained
    launches), `r3_decode_ilp` (B1 unrolled 2, 4, 8 and 64 times and with
    its ranks ahead, each with its registers and spills, on the v2
    scene's busiest orbit chunk), `exp_gather` (B12's 4096-entry table
    in shared memory as int2, as two tables, or by `__ldg`, at the TPU
    probe's shape and at B12's, randomly, per warp and as a dependent
    chain) and `r3_div_parity` (how many bits of 1/w, x/w, the casts and
    the affine chain each faster f32 form changes, on the TPU probe's
    inputs and through B2's chain on the v2 orbit chunk, and each form's
    time).  Every exact variant is held bit-exact to its plain version,
    every lesion to its own, `full` of B5 and B1 within 3% of the
    shipped kernel timed in turns.  Then B10's exchange probe and the
    rest of B3's (`merge_probe_phase`): `exp_mxu_perm` (55 partner-exchange
    stages by shuffles, one warp through shared memory and a 1024-thread
    block, at 256 and 4,096 tiles, alone and by slope, beside B10's row),
    `r3_corient` (the chain tile staged, read row by row into registers,
    or transposed by shuffles, with each form's registers and spills, on
    the orbit chunk and the 4 colour parts), `r3_flushacc` (a warp's
    same-pixel keys combined before the atomicMin, its atomics and
    groups counted), `r3_i8dot` (a u32 depth pass, then a payload pass),
    `r3_p4dot` (a 4-byte depth gather before the u64 atomicMin) and
    `r4_pwin` (tiles per part against tiles at fixed positions, both
    layouts, with their tile counts), each on the four targets of
    `r3_mat_lesion`.  Every exact variant is bit-exact to its plain
    version, every deterministic count equal to its plain count,
    combine-count between the landed pixels and the groups, and
    `staged`, `u64` and `per-part` within 3% of the shipped kernel.
    Last, `r3_matscatter.py`'s two sites and B6's six (`b6_probe_phase`),
    on the unsorted streams of the parametric near frame, the `.wg` orbit
    frame, the `.las` orbit part and Potree's steady parts laid end to
    end: `r3_matscatter` (pid, key3 and key2 sorts; atomic-head and
    store-head after the key sort, B6 after each sort, B8 and flat B3;
    each path's sort + resolve), `r2_merge_tune` (B6's lesions),
    `r3_kernel_floor` (its anatomy and interleaved loads), `r3_build_v2`
    (0-5 doubling steps), `r3_merge_micro` (groups a warp, cp.async
    rings), `r3_merge_micro2` (instruction cuts, atomics saved) and
    `r3_rows_prefix` (the whole stream, the live entries by a boolean
    index or `pcr_probe_compact`, or 64 and 128 rows, then the sort and
    B6).  Every path and exact variant is bit-exact to
    `u64_min_planes_plain`, every checksum and count equal to its plain
    version or within its bounds, and `full` within 3% of the shipped
    `pcr_merge_nk1`.
The last lines are the card line, a JSON object of the kernels and
`{"ok": true, "device": {...}}`.  Nothing of jax or of the JAX package
is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
W, H = 1920, 1080
WARMUP, FRAMES = 2, 10
KERNEL_REPS, PLAIN_REPS = 20, 5
SPIN_CYCLES = 2_000_000  # ~1 ms of device spin at the H100's clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# bench.py:176-183
VIEWS = {
    "orbit": dict(yaw=0.5, pitch=-0.9, radius=2500.0, target=(1000.0, 1000.0, 100.0)),
    "closeup": dict(yaw=2.4, pitch=-0.25, radius=180.0, target=(1000.0, 1000.0, 60.0)),
    "oblique": dict(yaw=-1.1, pitch=-0.08, radius=1400.0, target=(1000.0, 1000.0, 40.0)),
}
# the `.tpc` paths also render a close-up of the (1900, 1850) corner:
# Morton order keeps a chunk's batches near each other, so the frustum
# leaves whole chunks far from the corner with no batch in view
TPC_VIEWS = {**VIEWS,
             "corner": dict(yaw=0.3, pitch=-0.9, radius=50.0, target=(1900.0, 1850.0, 50.0))}
KERNEL_INFO = {  # C symbol -> (name, source, TPU kernel it replaces)
    "pcr_decode_fixed": ("B1 fbatch decode", "pcrhpg24_tpu_torch/csrc/decode_fixed.cu",
                         "pcrhpg24_tpu/render/pallas_decode_fixed.py:52"),
    "pcr_project": ("B2 fused projection", "pcrhpg24_tpu_torch/csrc/project.cu",
                    "pcrhpg24_tpu/render/pallas_project.py:83"),
    # the same kernel as HQS launches it (collapse=False): its own row
    "pcr_project:hqs": ("B2 fused projection, HQS mode", "pcrhpg24_tpu_torch/csrc/project.cu",
                        "pcrhpg24_tpu/render/pallas_project.py:83"),
    # and with a per-batch payload in place of the colour (the debug frames)
    "pcr_project:payload": ("B2 fused projection, batch-payload mode",
                            "pcrhpg24_tpu_torch/csrc/project.cu",
                            "pcrhpg24_tpu/render/pallas_project.py:83 (payload: XLA, "
                            "methods/huffman_tpu.py:146)"),
    # and in the other colour formats of a `.tpc` v2, whose payloads the
    # reference computes in XLA beside an XLA projection
    "pcr_project:bc7": ("B2 fused projection, BC7 mode", "pcrhpg24_tpu_torch/csrc/project.cu",
                        "pcrhpg24_tpu/render/pallas_project.py:83 (BC7 payload: XLA, "
                        "render/bc1_layout.py:68)"),
    "pcr_project:raw": ("B2 fused projection, raw mode", "pcrhpg24_tpu_torch/csrc/project.cu",
                        "pcrhpg24_tpu/render/pallas_project.py:83 (raw payload: XLA, "
                        "render/bc1_layout.py:101)"),
    "pcr_u64_min": ("B3 u64-min resolve", "pcrhpg24_tpu_torch/csrc/raster.cu",
                    "pcrhpg24_tpu/render/pallas_merge.py:467"),
    # the same kernel over all of the orbit frame's parts in one call
    "pcr_u64_min:frame": ("B3 u64-min resolve, one frame's parts",
                          "pcrhpg24_tpu_torch/csrc/raster.cu",
                          "pcrhpg24_tpu/render/pallas_merge.py:467"),
    "pcr_u64_min:hqs": ("B3 u64-min resolve, one HQS frame's parts (depth prepass)",
                        "pcrhpg24_tpu_torch/csrc/raster.cu",
                        "pcrhpg24_tpu/render/pallas_merge.py:467"),
    "pcr_hqs_sums": ("B4 HQS blend sums", "pcrhpg24_tpu_torch/csrc/hqs.cu",
                     "pcrhpg24_tpu/render/pallas_hqs.py:185"),
    # B3 and B4 in their flat layout (`tiles::kFlat`): where the `.las`
    # methods' XLA resolves stood, every chunk of a frame in one launch,
    # linear pixel ids, one entry a point in file order
    "pcr_u64_min_flat": ("B3 u64-min resolve, flat layout, one loop_las frame's parts",
                         "pcrhpg24_tpu_torch/csrc/raster.cu",
                         "pcrhpg24_tpu/render/pallas_merge.py:467 (on the .las path: XLA "
                         "sorted_scatter_u64_min, raster.py:125)"),
    "pcr_hqs_sums_flat": ("B4 HQS blend sums, flat layout, one loop_las_hqs frame's parts",
                          "pcrhpg24_tpu_torch/csrc/hqs.cu",
                          "pcrhpg24_tpu/render/pallas_hqs.py:185 (on the .las path: XLA "
                          "scatter-adds, methods/loop_las.py:415-418)"),
    # and where the Potree frames' resolves stand: a frame's live chunks,
    # each a part of node-ordered points
    "pcr_u64_min_flat:potree": ("B3 u64-min resolve, flat layout, one loop_nodes frame's parts",
                                "pcrhpg24_tpu_torch/csrc/raster.cu",
                                "pcrhpg24_tpu/render/pallas_merge.py:467 (dense_from_sorted_rows, "
                                "methods/loop_nodes.py:116)"),
    "pcr_hqs_sums_flat:potree": ("B4 HQS blend sums, flat layout, one loop_nodes_hqs frame's "
                                 "parts", "pcrhpg24_tpu_torch/csrc/hqs.cu",
                                 "pcrhpg24_tpu/render/pallas_hqs.py:185 (hqs_sums_from_rows, "
                                 "methods/loop_nodes.py:361)"),
    "pcr_decode_native": ("B5 tbatch decode", "pcrhpg24_tpu_torch/csrc/decode_native.cu",
                          "pcrhpg24_tpu/render/pallas_decode.py:55"),
    # B6' (pallas_merge.py:278) is the same function: this kernel serves both
    "pcr_merge_nk1": ("B6/B6' pid-sorted u64-min", "pcrhpg24_tpu_torch/csrc/merge.cu",
                      "pcrhpg24_tpu/render/pallas_merge.py:362"),
    "pcr_merge_heads": ("B8 3-key-sorted run heads", "pcrhpg24_tpu_torch/csrc/merge.cu",
                        "pcrhpg24_tpu/render/pallas_merge.py:137"),
    "pcr_hqs_sorted": ("B9 pid-sorted HQS sums", "pcrhpg24_tpu_torch/csrc/hqs.cu",
                       "pcrhpg24_tpu/render/pallas_hqs.py:71"),
    "pcr_tile_sort3": ("B10 per-tile 3-key sort", "pcrhpg24_tpu_torch/csrc/tile_sort.cu",
                       "pcrhpg24_tpu/render/pallas_raster.py:101"),
    # no Pallas counterpart: the reference decodes `.huffman` in plain XLA
    "pcr_decode_huffman": ("B12 .huffman decode", "pcrhpg24_tpu_torch/csrc/decode_huffman.cu",
                           "pcrhpg24_tpu/render/decode_jax.py:34 (XLA, no pallas_call)"),
}
# the probes' kernels (`pcrhpg24_tpu_torch/experiments/`): C symbol ->
# (name, source, TPU probe it answers for the card); reached by no path
PROBE_INFO = {
    "pcr_probe_scatter": ("probe: random atomicMin (exp_pallas_scatter_probe)",
                          "pcrhpg24_tpu_torch/experiments/exp_pallas_scatter_probe.cu",
                          "experiments/exp_pallas_scatter_probe.py:31 (chained: :63)"),
    "pcr_probe_lesion": ("probe: B3 stage lesions (r3_mat_lesion)",
                         "pcrhpg24_tpu_torch/experiments/r3_mat_lesion.cu",
                         "experiments/r3_mat_lesion.py:255"),
    "pcr_probe_floor": ("probe: B3 chain-tile anatomy (r4_floor)",
                        "pcrhpg24_tpu_torch/experiments/r4_floor.cu",
                        "experiments/r4_floor.py:222"),
    "pcr_probe_winsize": ("probe: B3 tile widths (r4_winsize)",
                          "pcrhpg24_tpu_torch/experiments/r4_winsize.cu",
                          "experiments/r4_winsize.py:214"),
    "pcr_probe_b5": ("probe: B5 stage variants (exp_pallas_variants, exp_variant_slope)",
                     "pcrhpg24_tpu_torch/experiments/exp_pallas_variants.cu",
                     "experiments/exp_pallas_variants.py:118 (by slope: exp_variant_slope.py:30)"),
    "pcr_probe_b1": ("probe: B1 unrolled and with ranks ahead (r3_decode_ilp)",
                     "pcrhpg24_tpu_torch/experiments/r3_decode_ilp.cu",
                     "experiments/r3_decode_ilp.py:141"),
    "pcr_probe_gather": ("probe: B12's 4096-entry table read (exp_gather)",
                         "pcrhpg24_tpu_torch/experiments/exp_gather.cu",
                         "experiments/exp_gather.py:18"),
    "pcr_probe_parity": ("probe: B2's f32 forms (r3_div_parity)",
                         "pcrhpg24_tpu_torch/experiments/r3_div_parity.cu",
                         "experiments/r3_div_parity.py:32 (affine: :62)"),
    "pcr_probe_perm": ("probe: B10's partner exchange by shuffles and shared memory "
                       "(exp_mxu_perm)",
                       "pcrhpg24_tpu_torch/experiments/exp_mxu_perm.cu",
                       "experiments/exp_mxu_perm.py:52"),
    "pcr_probe_corient": ("probe: B3's chain tile read into registers (r3_corient)",
                          "pcrhpg24_tpu_torch/experiments/r3_corient.cu",
                          "experiments/r3_corient.py:254"),
    "pcr_probe_combine": ("probe: B3 with a warp's same-pixel keys combined (r3_flushacc)",
                          "pcrhpg24_tpu_torch/experiments/r3_flushacc.cu",
                          "experiments/r3_flushacc.py:263"),
    "pcr_probe_narrow": ("probe: B3 with narrow keys, two-pass and half-gather "
                         "(r3_i8dot, r3_p4dot)",
                         "pcrhpg24_tpu_torch/experiments/r3_i8dot.cu",
                         "experiments/r3_i8dot.py:240 (half-gather: r3_p4dot.py:238)"),
    "pcr_probe_pwin": ("probe: B3's tiles per part against position tiles (r4_pwin)",
                       "pcrhpg24_tpu_torch/experiments/r4_pwin.cu",
                       "experiments/r4_pwin.py:373 (per-part baseline: :322)"),
    "pcr_probe_heads": ("probe: run heads stored after a full-key sort (r3_matscatter)",
                        "pcrhpg24_tpu_torch/experiments/r3_matscatter.cu",
                        "experiments/r3_matscatter.py:237 (B6 with no suffix-min: :294)"),
    "pcr_probe_b6": ("probe: B6's variants: stage lesions, anatomy, scan depth, groups a "
                     "warp, cp.async rings, instruction cuts (r2_merge_tune, "
                     "r3_kernel_floor, r3_build_v2, r3_merge_micro, r3_merge_micro2)",
                     "pcrhpg24_tpu_torch/experiments/r2_merge_tune.cu",
                     "experiments/r2_merge_tune.py:124 (also r3_kernel_floor.py:169, "
                     "r3_build_v2.py:118, r3_merge_micro.py:95, r3_merge_micro2.py:289)"),
    "pcr_probe_compact": ("probe: live entries compacted before the sort (r3_rows_prefix)",
                          "pcrhpg24_tpu_torch/experiments/r3_rows_prefix.cu",
                          "experiments/r3_rows_prefix.py:146"),
}
# cameras of the parametric scene: target (0, 0, 0) on the radius-10 sphere
# (the app's default radius of 1000 leaves it a few pixels wide)
PARAM_VIEWS = {
    "near": dict(yaw=0.4, pitch=-0.3, radius=14.0, target=(0.0, 0.0, 0.0)),
    "mid": dict(yaw=-1.2, pitch=-0.7, radius=22.0, target=(0.0, 0.0, 0.0)),
    "far": dict(yaw=2.0, pitch=0.25, radius=35.0, target=(0.0, 0.0, 0.0)),
}
# the `.tpc` v2 colour formats beside BC1
COLOR_FMTS = ("bc7", "raw")
# main paths: (label, method, scene: `.tpc` version, "huffman" or a colour
# format of a `.tpc` v2, kernels it must launch)
MAIN_PATHS = [
    ("colour v2", "huffman_tpu", 2, ("pcr_decode_fixed", "pcr_project", "pcr_u64_min")),
    ("hqs v2", "huffman_tpu_hqs", 2,
     ("pcr_decode_fixed", "pcr_project", "pcr_u64_min", "pcr_hqs_sums")),
    ("colour v1", "huffman_tpu", 1, ("pcr_decode_native", "pcr_project", "pcr_u64_min")),
    ("colour huffman", "huffman_mem_iter", "huffman",
     ("pcr_decode_huffman", "pcr_project", "pcr_u64_min")),
    ("hqs huffman", "huffman_hqs", "huffman",
     ("pcr_decode_huffman", "pcr_u64_min", "pcr_hqs_sums")),
    ("huffman->v2", "huffman_tpu", "huffman",
     ("pcr_decode_fixed", "pcr_project", "pcr_u64_min")),
    *((f"{kind} v2 {fmt}", method, fmt, ("pcr_decode_fixed", "pcr_project", "pcr_u64_min")
       + (("pcr_hqs_sums",) if kind == "hqs" else ()))
      for fmt in COLOR_FMTS for kind, method in (("colour", "huffman_tpu"),
                                                 ("hqs", "huffman_tpu_hqs"))),
]
# the `.las` methods, the source paper's baselines, in the app's order:
# (method, kernels it must launch; every other kernel must not launch)
LAS_METHODS = [(name, ("pcr_u64_min_flat", "pcr_hqs_sums_flat") if "hqs" in name
                else ("pcr_u64_min_flat",))
               for name in ("loop_las", "loop_las2", "loop_las_hqs", "basic", "2021 early-z",
                            "2021 early-z & reduce", "2021 dedup", "GL_POINTS", "2021 hqs")]
# the (path, view) whose launches are reported; None: reached by no method
OWNER = {"pcr_decode_fixed": ("colour v2", "orbit"), "pcr_project": ("colour v2", "orbit"),
         "pcr_project:hqs": ("hqs v2", "orbit"),
         "pcr_project:payload": ("colour v2 chunks", "orbit"),
         "pcr_project:bc7": ("colour v2 bc7", "orbit"),
         "pcr_project:raw": ("colour v2 raw", "orbit"),
         "pcr_u64_min": ("colour v2", "orbit"), "pcr_u64_min:frame": ("colour v2", "orbit"),
         "pcr_u64_min:hqs": ("hqs v2", "orbit"), "pcr_hqs_sums": ("hqs v2", "orbit"),
         "pcr_decode_native": ("colour v1", "orbit"),
         "pcr_merge_nk1": ("parametric", "near"), "pcr_merge_heads": None,
         "pcr_hqs_sorted": None, "pcr_tile_sort3": None,
         "pcr_decode_huffman": ("colour huffman", "orbit"),
         "pcr_u64_min_flat": ("las loop_las", "orbit"),
         "pcr_hqs_sums_flat": ("las loop_las_hqs", "orbit"),
         "pcr_u64_min_flat:potree": ("potree loop_nodes", "steady"),
         "pcr_hqs_sums_flat:potree": ("potree loop_nodes_hqs", "steady")}
# the synthetic Potree scene's cameras (`tools/synth_potree.py`, 4096 m): the
# steady camera of the reference's 1B-point run (experiments/r5_potree_1b.py),
# an overview, and a close-up of the (700, 700) corner on the terrain, which
# leaves the octants far from it, and the chunks that hold them, out
POTREE_VIEWS = {
    "steady": dict(yaw=0.45, pitch=-0.75, radius=6500.0, target=(2048.0, 2048.0, 500.0)),
    "overview": dict(yaw=-0.6, pitch=-1.2, radius=12000.0, target=(2048.0, 2048.0, 900.0)),
    "corner": dict(yaw=0.8, pitch=-0.5, radius=250.0, target=(700.0, 700.0, 1173.76)),
}
POTREE_DENSITY = 2.0  # Debug.node_budget of the reference's 1B-point run
# B12's arguments: the whole flat buffers, then each batch's rows
REF_KEYS = ("encoding", "enc_offsets", "cluster_sizes", "separate", "sep_offsets",
            "separate_sizes", "table_values", "table_cw_len", "start_values")
WHOLE_BUFFERS = ("encoding", "separate")


class Stopwatch:
    """Prints the seconds each phase of the run took."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[phase] {what}: {now - self.t:.1f} s")
        self.t = now


def print_ptxas(log: str) -> None:
    """ptxas's registers, shared memory and spills of each kernel instance
    in an nvcc log."""
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")
        elif "spill" in line:
            print(f"[build] {line.strip()}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_abs_err(a, b) -> int:
    """Largest |a - b| over int tensors of one shape (0 when bit-exact)."""
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not a.numel():
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def time_ms(fn, reps: int, spin: bool = False, setup=None) -> float:
    """Median ms of fn() over `reps` calls, after one warm call.

    The events bracket the call as the host enqueues it.  With `spin`,
    each call is enqueued behind a ~1 ms device spin, so the card is
    still busy while the host enqueues the call's work and the events
    bracket the device time alone.  `setup()` runs before each call,
    outside the events (and before the spin).
    """
    import torch

    if setup:
        setup()
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if setup:
            setup()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def hqs_accepted(pid, dep, fb_depth, size: int):
    """B4's accept test: the (n,) int64 pixel of each entry it adds,
    `size` where it adds nothing."""
    import torch

    from pcrhpg24_tpu_torch.u32 import widen

    q = widen(pid.reshape(-1))
    w = dep.reshape(-1).view(torch.float32)
    old = fb_depth.view(torch.float32)[torch.clamp(q, max=size - 1)]
    tol = torch.tensor(1.01, dtype=torch.float32, device=q.device)
    return torch.where((q < size) & (w <= old * tol), q, torch.full_like(q, size))


def hqs_rows(pid, dep, pay, fb_depth, size: int):
    """The one PyTorch call that computes B4's sums is `index_add_` of the
    accepted entries' (r, g, b, 1) rows into a (size, 4) plane: -> (index,
    rows) of the accepted entries only.  The accept test and the drop are
    left out of its time."""
    import torch

    from pcrhpg24_tpu_torch.u32 import widen

    q = hqs_accepted(pid, dep, fb_depth, size)
    ok = q < size
    y = widen(pay.reshape(-1))[ok]
    vals = torch.stack([y & 255, (y >> 8) & 255, (y >> 16) & 255, torch.ones_like(y)],
                       1).to(torch.int32)
    return q[ok], vals


LAZ_POINTS = 65536  # the multi-file scene's `.laz`: the codec is pure Python
LAZ_GRID = dict(scale=(0.01, 0.01, 0.01), offset=(3.0, 5.0, 0.0))  # another grid


def multi_paths(base: str) -> list:
    """The multi-file scene: the terrain's two halves as `.las`, and its
    first 65,536 points again as a `.laz` on a 1 cm grid."""
    return [f"{base}_a.las", f"{base}_b.las", f"{base}_c.laz"]


def build_scenes(base: str, batches: int) -> tuple[float, float]:
    """bench.py's generator (bench.py:86-102), written by the port's
    `write_las` as `<base>.las` and as the multi-file scene of
    `multi_paths`, by its preprocessor as `<base>_v2.tpc`, `<base>_v1.tpc`
    and `<base>.huffman`, and by its Potree writer and `.wg` converter
    as `<base>.wg`; -> (seconds in all, seconds writing the `.huffman`)."""
    import shutil

    from pcrhpg24_tpu_torch.formats.las import write_las
    from pcrhpg24_tpu_torch.formats.laz import write_laz
    from pcrhpg24_tpu_torch.formats.potree import build_potree
    from pcrhpg24_tpu_torch.preprocess import preprocess_las, preprocess_las_tpc
    from pcrhpg24_tpu_torch.tools.potree_to_wg import convert
    from pcrhpg24_tpu_torch.utils.synthetic import cloud_to_grid, terrain_cloud

    todo = [(v, codec) for v, codec in ((2, "fixed"), (1, "huffman"))
            if not os.path.exists(f"{base}_v{v}.tpc")]
    las, huf, wg = base + ".las", base + ".huffman", base + ".wg"
    multi = multi_paths(base)
    huf_s = 0.0
    if not todo and all(os.path.exists(p) for p in (las, huf, wg, *multi)):
        return 0.0, huf_s
    t0 = time.perf_counter()
    xyz, rgb = terrain_cloud(batches * 65536, seed=1, extent=2000.0)
    if not os.path.exists(wg):
        potree = base + "_potree"
        build_potree(potree, xyz, rgb)
        convert(potree, wg + ".tmp", precision=0.001)
        os.replace(wg + ".tmp", wg)
        shutil.rmtree(potree)
    grid = cloud_to_grid(xyz, scale=(0.001, 0.001, 0.001))
    if not os.path.exists(las):
        write_las(las + ".tmp", grid[:, 0], grid[:, 1], grid[:, 2], rgb)
        os.replace(las + ".tmp", las)
    half = len(grid) // 2
    for path, sl in zip(multi[:2], (slice(0, half), slice(half, None))):
        if not os.path.exists(path):
            write_las(path + ".tmp", grid[sl, 0], grid[sl, 1], grid[sl, 2], rgb[sl])
            os.replace(path + ".tmp", path)
    if not os.path.exists(multi[2]):
        g = cloud_to_grid(xyz[:LAZ_POINTS], **LAZ_GRID)
        write_laz(multi[2] + ".tmp", g[:, 0], g[:, 1], g[:, 2], rgb=rgb[:LAZ_POINTS],
                  point_format=2, **LAZ_GRID)
        os.replace(multi[2] + ".tmp", multi[2])
    del grid
    for v, codec in todo:
        out = f"{base}_v{v}.tpc"
        preprocess_las_tpc(las, out + ".tmp", sort=True, verbose=False, codec=codec)
        os.replace(out + ".tmp", out)
    if not os.path.exists(huf):
        t1 = time.perf_counter()
        preprocess_las(las, huf + ".tmp", sort=True, verbose=False)
        os.replace(huf + ".tmp", huf)
        huf_s = time.perf_counter() - t1
    return time.perf_counter() - t0, huf_s


def lexsorted(got, keys) -> bool:
    """Whether each tile of `got` is its tile of `keys` (int32 (T, 8, 128)
    planes) in `np.lexsort` order by (k0, k1, k2)."""
    k0, k1, k2 = (k.cpu().numpy().reshape(k.shape[0], k.shape[1] * k.shape[2])
                  for k in keys)
    order = np.lexsort((k2, k1, k0), axis=-1)
    return all(np.array_equal(g.cpu().numpy().reshape(k.shape),
                              np.take_along_axis(k, order, axis=1))
               for g, k in zip(got, (k0, k1, k2)))


def same_planes(got, want, what: str) -> int:
    """Max abs error over paired planes (None pairs with None); raises
    unless every pair is bit-exact."""
    err = 0
    for g, w in zip(got, want):
        check((g is None) == (w is None), f"{what}: plane present in one only")
        if g is not None:
            e = max_abs_err(g.cpu(), w.cpu())
            check(e == 0, f"{what} (max err {e})")
            err = max(err, e)
    return err


def atomic_groups(qs, size: int):
    """qs: for each part of a stream, the (n,) int64 pixel of each entry,
    `size` or more where it lands nothing -> (landing entries, (warp,
    pixel) groups of the chain tiles' columns (32 points of one chain: B3's
    and B4's chain layout), groups of flat 32-entry warps (a warp of their
    flat layout), landing entries whose next entry lands on the same
    pixel): the atomic sets of each layout if each warp combined its lanes
    of one pixel, and the pairs that a drop of keys beaten by the next lane
    could merge."""
    import torch

    total = [0, 0, 0, 0]
    for q in qs:
        ok = q < size
        e = torch.arange(q.numel(), device=q.device)[ok]
        q = q[ok]
        tiles = (e // (32 * 1024)) * 1024 + e % 1024  # (32-row band, column)
        pairs = int(((q[1:] == q[:-1]) & (e[1:] == e[:-1] + 1)).sum())
        for k, v in enumerate((int(ok.sum()), torch.unique(tiles * (size + 1) + q).numel(),
                               torch.unique((e // 32) * (size + 1) + q).numel(), pairs)):
            total[k] += v
    return tuple(total)


def flat_groups(label: str, parts, colour, fb, size: int, card: str) -> None:
    """Print `atomic_groups` of a frame's flat parts: B4's accepted entries
    (`colour`, the parts with the colours as payload, against the depth
    plane `fb`) and B3's landing entries (`parts`)."""
    from pcrhpg24_tpu_torch.u32 import widen

    for what, qs in (("B4: accepted entries", [hqs_accepted(*p[:2], fb, size) for p in colour]),
                     ("B3: landing entries", [widen(p[0].reshape(-1)) for p in parts])):
        n_q, tiled, flat, pairs = atomic_groups(qs, size)
        print(f"[groups] {label} {what} {n_q:,} fall into {tiled:,} (warp, pixel) groups "
              f"of 32-point chain-tile columns ({tiled / n_q:.4f} an entry), "
              f"{flat:,} over flat 32-entry warps ({flat / n_q:.4f}); {pairs:,} "
              f"entries land on their next entry's pixel ({pairs / n_q:.6f}) [{card}]")


def view_args(method, renderer, view: dict, lod: float) -> dict:
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.renderer import Setting

    Debug.lod = lod
    renderer.apply_setting(Setting(**view))
    renderer.controls_update()
    return method.frame_args(renderer)

# the flagship frame's other outputs: (label, method, scene, kernels it
# must launch), each at these views, with each of these app flags
OUTPUT_VIEWS = ("orbit", "corner")
OUTPUT_FLAGS = {
    "chunks": ("--colorize-chunks",),
    "num_points": ("--show-num-points",),
    "overdraw": ("--colorize-overdraw",),
    "boxes": ("--show-bounding-box",),
    "edl": ("--edl",),
    "depth": ("--depth",),
}
OUTPUT_PATHS = [  # (label, method, scene, kernels, views, flags)
    ("colour v2", "huffman_tpu", 2, ("pcr_decode_fixed", "pcr_project"), OUTPUT_VIEWS,
     tuple(OUTPUT_FLAGS)),
    ("colour v1", "huffman_tpu", 1, ("pcr_decode_native", "pcr_project"), OUTPUT_VIEWS,
     tuple(OUTPUT_FLAGS)),
    ("colour huffman", "huffman_mem_iter", "huffman", ("pcr_decode_huffman", "pcr_project"),
     OUTPUT_VIEWS, tuple(OUTPUT_FLAGS)),
    ("las loop_las", "loop_las", "las", (), ("orbit",), ("edl", "depth")),
]


def app_argv(path: str, method_name: str, view: dict, frames: int) -> list:
    return ["--scene", path, "--method", method_name, "--device", DEVICE,
            "--width", str(W), "--height", str(H), "--lod", "1.0",
            "--yaw", str(view["yaw"]), "--pitch", str(view["pitch"]),
            "--radius", str(view["radius"]), "--target", *map(str, view["target"]),
            "--frames", str(frames)]


def output_phase(paths: dict, results: dict) -> None:
    """Each of `OUTPUT_FLAGS` through the app on each of `OUTPUT_PATHS`
    at `OUTPUT_VIEWS`: the kernels' launches, the image and the planes
    the frame leaves in `last_fb` bit-exact against the same frame built
    from the plain versions, the depth file read back; frame times into
    `results[(f"{label} {flag}", view)]`."""
    import torch

    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.methods.huffman_mem_iter import mem_iter_frame
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu import render_frame_native
    from pcrhpg24_tpu_torch.render.raster import BACKGROUND, edl_shade
    from pcrhpg24_tpu_torch.utils.exr import read_exr_z

    frames = WARMUP + FRAMES
    plain_frame = {"huffman_tpu": render_frame_native, "huffman_mem_iter": mem_iter_frame}
    for label, method_name, v, must, views, flags in OUTPUT_PATHS:
        tag = v if isinstance(v, str) else f"v{v}"
        for name in views:
            for flag in flags:
                extra = OUTPUT_FLAGS[flag]
                argv = app_argv(paths[v], method_name, TPC_VIEWS[name], frames) + list(extra)
                depth_path = None
                if flag == "depth":
                    depth_path = os.path.join(
                        REPO, "out", f"chip_smoke_depth_{tag}_{name}"
                                     f"{'.exr' if v == 2 else '.npy'}")
                    argv.append(depth_path)
                for k in build.KERNELS.values():
                    k.launches = 0
                rr = app.run(argv)
                launches = {s: k.launches for s, k in build.KERNELS.items()}
                for s in must:
                    check(launches[s] > 0, f"{s} never launched ({label} {flag}, {name})")
                # the overdraw frame counts entries in place of the resolve;
                # the `.las` frame resolves in B3's flat layout
                b3 = 0 if (flag == "overdraw" and method_name == "huffman_tpu") else frames
                b3_sym = "pcr_u64_min_flat" if v == "las" else "pcr_u64_min"
                for sym in ("pcr_u64_min", "pcr_u64_min_flat"):
                    want = b3 if sym == b3_sym else 0
                    check(launches[sym] == want,
                          f"{sym} launched {launches[sym]} times in {frames} frames "
                          f"({label} {flag}, {name}), not {want}")
                method = Runtime.selected
                if method_name in plain_frame:
                    fd, fp, img = plain_frame[method_name](
                        **method.frame_args(rr), **method.frame_mode(rr), plain=True)
                else:  # a `.las` method
                    fd, fp, img = method.frame(rr, plain=True)
                if Debug.show_bounding_box:
                    img = method.draw_boxes(rr, img)
                if Debug.edl and fd is not None:
                    img = edl_shade(img, fd, W, H, Debug.edl_strength)
                got = rr.last_image
                check(tuple(got.shape) == (H, W), f"no {H}x{W} image")
                shown = int((got != BACKGROUND).sum())
                check(shown > 0, f"{label} {flag} {name}: the image is all background")
                e = same_planes([got, *rr.last_fb], [img, fd, fp],
                                f"{label} {flag} {name}: image or planes != the "
                                f"all-plain frame")
                note = ""
                if depth_path:
                    back = (read_exr_z(depth_path) if depth_path.endswith(".exr")
                            else np.load(depth_path))
                    check(np.array_equal(back, rr.depth_image()),
                          f"{label} {name}: the --depth file != fb_d")
                    note = f"; {os.path.basename(depth_path)} read back equal to fb_d"
                results[(f"{label} {flag}", name)] = dict(
                    frame_ms=statistics.median(rr.frame_ms[WARMUP:]), shown=shown,
                    launches=launches, frames=len(rr.frame_ms[WARMUP:]), output=flag)
                planes = ", ".join("-" if x is None else "plane" for x in rr.last_fb)
                print(f"[output] {label} ({method_name}) {name} {' '.join(extra)}: "
                      f"{shown:,} pixels shown, image "
                      f"and last_fb ({planes}) bit-exact vs the all-plain frame (err {e})"
                      f"{note}; launches { {s: launches[s] for s in (*must, b3_sym)} }")
                method.las.unload()
                del rr, method, got, img, fd, fp
                Runtime.clear()
                torch.cuda.empty_cache()
    for f in ("colorize_chunks", "show_num_points", "colorize_overdraw", "edl",
              "show_bounding_box"):
        setattr(Debug, f, False)


def both_layouts(parts, colour, size: int, errs: dict, what: str):
    """B3 on `parts` and B4 on `colour` (the same parts with the colours
    as payload) in the flat layout, as their callers launch them, and in
    the chain layout, each against its plain version; -> B3's depth plane
    (B4's prepass), contiguous."""
    from pcrhpg24_tpu_torch.render.hqs import hqs_sums, hqs_sums_plain
    from pcrhpg24_tpu_torch.render.raster import u64_min_planes, u64_min_planes_plain

    want = u64_min_planes_plain(parts, size)
    fb = want[0].contiguous()
    want4 = hqs_sums_plain(colour, fb, size)
    for layout, suffix in (("flat", "_flat"), ("chain", "")):
        errs["pcr_u64_min" + suffix] = max(errs["pcr_u64_min" + suffix], same_planes(
            u64_min_planes(parts, size, layout=layout), want,
            f"B3 in the {layout} layout on {what}"))
        errs["pcr_hqs_sums" + suffix] = max(errs["pcr_hqs_sums" + suffix], same_planes(
            hqs_sums(colour, fb, size, layout=layout), want4,
            f"B4 in the {layout} layout on {what}"))
    print(f"[gate] B3 and B4 in the flat and the chain layout bit-exact vs their plain "
          f"versions on {what} ({sum(p[0].numel() for p in parts):,} entries in "
          f"{len(parts)} part(s))")
    return fb


def las_phase(las_path: str, multi: list, results: dict, errs: dict, card: str) -> dict:
    """The nine `.las` methods through the app at `TPC_VIEWS`, and `basic`
    on the multi-file scene at the orbit view: B3 launched once a frame,
    B4 once an HQS frame, no other kernel; the image and the planes left
    in `last_fb` bit-exact against the same frame built from the plain
    versions.  Frame times into `results[(f"las {method}", view)]`; the
    device time of each frame's projection (torch ops) printed; B3 and
    B4 held against their plain versions on the orbit frame's parts.
    -> the loop_las_hqs orbit frame's parts, colour parts and depth plane
    (the kernels line's `.las` rows)."""
    import torch

    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.methods import basic, compute_2021, loop_las
    from pcrhpg24_tpu_torch.render.raster import BACKGROUND
    from pcrhpg24_tpu_torch.utils.devtime import device_ms

    frames = WARMUP + FRAMES
    size = W * H
    parts_of = {loop_las.ComputeLoopLas: loop_las.loop_las_parts,
                basic.BasicMethod: basic.basic_parts,
                compute_2021.Compute2021: compute_2021.compute2021_parts}
    shapes = {}
    runs = [(las_path, name, must, view) for name, must in LAS_METHODS for view in TPC_VIEWS]
    runs.append((",".join(multi), "basic", ("pcr_u64_min_flat",), "orbit"))
    for path, method_name, must, name in runs:
        label = f"las {method_name}" if path == las_path else f"multi-file {method_name}"
        for k in build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        rr = app.run(app_argv(path, method_name, TPC_VIEWS[name], frames))
        wall = time.perf_counter() - t0
        launches = {s: k.launches for s, k in build.KERNELS.items()}
        for s_, n_ in launches.items():
            want = frames if s_ in must else 0
            check(n_ == want, f"{s_} launched {n_} times in {frames} frames ({label}, {name}), "
                              f"not {want}")
        method = Runtime.selected
        fd, fp, img = method.frame(rr, plain=True)
        got = rr.last_image
        check(tuple(got.shape) == (H, W), f"no {H}x{W} image")
        shown = int((got != BACKGROUND).sum())
        check(shown > 0, f"{label} {name}: the image is all background")
        e = same_planes([got, *rr.last_fb], [img, fd, fp],
                        f"{label} {name}: image or planes != the all-plain frame")
        args = {k: v for k, v in method.frame_args(rr).items() if k != "hqs"}
        parts_fn = next(f for c, f in parts_of.items() if isinstance(method, c))
        points = (int(args["vis"].sum()) * 65536 if "vis" in args else args["points"])
        results[(label, name)] = dict(
            frame_ms=statistics.median(rr.frame_ms[WARMUP:]), visible=points, shown=shown,
            launches=launches, frames=len(rr.frame_ms[WARMUP:]), what="points projected")
        proj = ""
        if name == "orbit" and method_name in ("loop_las", "basic", "2021 early-z"):
            ms = statistics.median([device_ms(lambda: parts_fn(**args))
                                    for _ in range(KERNEL_REPS)])
            proj = f"; its projection (torch ops) {ms:.4f} ms device"
        if (method_name, name) == ("loop_las_hqs", "orbit") and path == las_path:
            parts = parts_fn(**args)
            colour = loop_las.colour_parts(parts, args["dev"]["rgba"])
            fb = both_layouts(parts, colour, size, errs, "the loop_las orbit frame's parts")
            flat_groups("loop_las_hqs orbit", parts, colour, fb, size, card)
            shapes = dict(parts=parts, colour=colour, fb=fb)
        print(f"[main] {label} {name}: {shown:,} pixels shown, image and last_fb bit-exact "
              f"vs the all-plain frame (err {e}); {points:,} points projected; launches "
              f"{ {s_: launches[s_] for s_ in must} } in {frames} frames, no other kernel; "
              f"app.run {wall:.1f} s with the load{proj} [{card}]")
        method.las.unload()
        del rr, method, got, img, fd, fp
        Runtime.clear()
        torch.cuda.empty_cache()
    return shapes


def potree_scene(points: int) -> tuple[str, float]:
    """The synthetic Potree scene of `points` points (the reference's
    `tools/synth_potree.py`, the port's copy), written under out/ and
    cached -> (its directory, seconds writing it, 0 when cached)."""
    import shutil

    from pcrhpg24_tpu_torch.tools.synth_potree import synth_potree

    path = os.path.join(REPO, "out", f"chip_smoke_potree_{points}")
    if os.path.exists(os.path.join(path, "metadata.json")):
        return path, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(path + ".tmp", ignore_errors=True)
    synth_potree(path + ".tmp", points, verbose=False)
    os.replace(path + ".tmp", path)
    return path, time.perf_counter() - t0


def potree_phase(path: str, budget, results: dict, errs: dict, card: str) -> dict:
    """`loop_nodes` and `loop_nodes_hqs` on a Potree scene through the
    app's `build_methods`, `wait_loaded` and `Renderer.loop`, one load of
    the scene (capped at `budget` resident points) for every run: one
    mid-load frame of each method, then at `POTREE_VIEWS`, unbudgeted
    and at `Debug.node_budget = POTREE_DENSITY`, the warm and timed
    frames.  Each run resets the launch counts and reads them after: the
    colour frame launches B3 alone, the HQS frame B3 and B4 alone.  Each
    image and the planes left in `last_fb` equal the frame built from
    the plain versions; a budgeted frame (the compact gather) equals the
    reference's masked frame.  Frame times into
    `results[(f"potree {method}[ budget]", view)]`.  -> the steady view's
    unbudgeted parts, their colour parts and depth plane (the kernels
    line's Potree rows)."""
    import torch

    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.engine.potree_resource import PotreeData
    from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.methods.loop_nodes import CHUNK_PTS, node_parts
    from pcrhpg24_tpu_torch.render.raster import BACKGROUND

    frames = WARMUP + FRAMES
    size = W * H
    r = Renderer(W, H, DEVICE)
    r.apply_setting(Setting(**POTREE_VIEWS["steady"]))
    colour, hqs = app.build_methods(r, path)
    data = PotreeData.create(path, DEVICE, budget)  # the residency cap: no app flag
    colour.potree = hqs.potree = data
    must = {colour.name: ("pcr_u64_min_flat",),
            hqs.name: ("pcr_u64_min_flat", "pcr_hqs_sums_flat")}

    def run(m, n: int, label: str, view: str) -> dict:
        for k in build.KERNELS.values():
            k.launches = 0
        r.loop(m.update, m.render, frames=n)
        launches = {s_: k.launches for s_, k in build.KERNELS.items()}
        for s_, n_ in launches.items():
            ok = n_ >= n if s_ in must[m.name] else n_ == 0
            check(ok, f"{s_} launched {n_} times in {n} frames ({label}, {view})")
        img = r.last_image
        check(tuple(img.shape) == (H, W), f"no {H}x{W} image")
        shown = int((img != BACKGROUND).sum())
        check(shown > 0, f"{label} {view}: the image is all background")
        fd, fp, want = m.frame(r, plain=True)
        same_planes([img, *r.last_fb], [want, fd, fp],
                    f"{label} {view}: image or planes != the all-plain frame")
        return launches

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    colour.update(r)  # starts the loader
    for m, bins in ((colour, 1), (hqs, 2)):  # HQS calls process() twice a frame
        while data._queue.qsize() < bins and data._thread.is_alive():
            time.sleep(0.01)
        before = data.nodes_loaded
        launches = run(m, 1, f"potree {m.name} mid-load", "steady")
        check(before < data.nodes_loaded < len(data.nodes),
              f"potree {m.name}: no frame in the middle of the load")
        print(f"[main] potree {m.name} mid-load frame with {data.nodes_loaded} of "
              f"{len(data.nodes)} nodes, {data.num_points_loaded:,} points resident: image "
              f"and last_fb bit-exact vs the all-plain frame; launches "
              f"{ {s_: launches[s_] for s_ in must[m.name]} }")
    app.wait_loaded(colour, r)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resident = nbytes(*data.dev.values(), *data.node_dev.values(), data.node_ids)
    print(f"[scene] potree: {path} {data.total_points:,} points in {len(data.nodes)} nodes "
          f"resident of {data.num_points:,} in the scene"
          f"{f' (cap {budget:,})' if budget else ''}, {len(data.bins)} bins; loaded in "
          f"{load_s:.1f} s with two frames; {resident:,} B resident on the card, peak "
          f"{torch.cuda.max_memory_allocated():,} B allocated [{card}]")

    nchunks = -(-data.dev["xyz4"].shape[0] // CHUNK_PTS)
    shapes = {}
    for name, view in POTREE_VIEWS.items():
        r.apply_setting(Setting(**view))
        r.controls_update()
        for density in (0.0, POTREE_DENSITY):
            Debug.node_budget = density
            tables = colour.frame_tables(r, cull=True)
            if density:
                nodes, takes = tables["gather"]
                points = int(takes.sum())
                # the cover of the reference's compact buffer may shrink the takes
                what = f"budgeted points gathered (the budget asked {tables['asked']:,})"
            else:
                live = len(tables["chunks"])
                vis = (tables["code"][:data.nodes_loaded] & 1) == 1
                points, what = int(data.node_count[vis].sum()), "points of visible nodes"
                if name == "corner":
                    check(live < nchunks, f"potree corner: {live} of {nchunks} chunks "
                                          f"live, none culled")
            for m in (colour, hqs):
                label = f"potree {m.name}{' budget' if density else ''}"
                launches = run(m, frames, label, name)
                if density:  # the compact gather against the masked chunks
                    fd, fp, want = m.frame(r, compact=False)
                    same_planes([r.last_image, *r.last_fb], [want, fd, fp],
                                f"{label} {name}: the compact frame != the masked frame")
                results[(label, name)] = dict(
                    frame_ms=statistics.median(r.frame_ms[-FRAMES:]), visible=points,
                    shown=int((r.last_image != BACKGROUND).sum()), launches=launches,
                    frames=FRAMES, what=what,
                    scene=f"{data.total_points:,} of {data.num_points:,} points resident")
                print(f"[main] {label} {name}: image and last_fb bit-exact vs the "
                      f"all-plain frame{' and the masked frame' if density else ''}; "
                      f"{points:,} {what}"
                      f"{'' if density else f', {live} of {nchunks} chunks live'}; "
                      f"launches { {s_: launches[s_] for s_ in must[m.name]} } in {frames} "
                      f"frames, no other kernel [{card}]")
            if (name, density) == ("steady", 0.0):
                parts = list(node_parts(**colour.frame_args(r, tables)))
                rgba = data.dev["rgba"]
                cparts = [(pid, dep, rgba[idx]) for pid, dep, idx in parts]
                fb = both_layouts(parts, cparts, size, errs,
                                  "the potree steady frame's parts")
                flat_groups("potree loop_nodes_hqs steady", parts, cparts, fb, size, card)
                shapes = dict(parts=parts, colour=cparts, fb=fb)
    Debug.node_budget = 0.0
    print(f"[scene] potree: peak {torch.cuda.max_memory_allocated():,} B allocated over the "
          f"load and every frame [{card}]")
    data.unload()
    Runtime.clear()
    torch.cuda.empty_cache()
    return shapes


def probe_phase(targets: list, chunks: dict, counts, card: str) -> list:
    """Phase 6b: the card counterparts of the TPU probes of B3's merge
    (`pcrhpg24_tpu_torch/experiments/`).  `exp_pallas_scatter_probe` at
    the u64 entry `counts`; `r3_mat_lesion` and `r4_winsize` on each of
    `targets`, (label, parts, plane size) of B3's parts; `r4_floor` on
    `chunks`, {view: (the most populated chunk's part, size)}.  Each
    module holds every variant to its plain version and raises on a
    mismatch.  -> the kernels line's rows of the four probe kernels (0
    launches: no path reaches them), each timed on one of the parts."""
    from pcrhpg24_tpu_torch.experiments import (exp_pallas_scatter_probe, r3_mat_lesion,
                                                r4_floor, r4_winsize)

    scatter = exp_pallas_scatter_probe.run(card, counts)
    lesions = {label: r3_mat_lesion.run(label, parts, size, card)
               for label, parts, size in targets}
    floors = {view: r4_floor.run(f"{view} chunk", [part], size, card)
              for view, (part, size) in chunks.items()}
    widths = {label: r4_winsize.run(label, parts, size, card)
              for label, parts, size in targets}
    print(f"[gate] probes: the scatter probe bit-exact vs scatter_reduce_ in "
          f"{len(scatter)} cases; full, atomic-all, count, no-load and every tile width "
          f"bit-exact vs u64_min_planes_plain, the no-atomic, floor and noop checksums "
          f"equal to their plain versions, on {len(targets)} targets and {len(chunks)} "
          f"chunks; full within 3% of the shipped kernel in each layout")

    chunk, las = targets[0], targets[2]
    key = f"1080p plane, {counts[0]:,} u64 keys"  # the plain version is the library call
    s = scatter[key]
    rows = [probe_row("pcr_probe_scatter", s["ms"], s["plain_ms"], s["plain_ms"],
                      s["n"] * 12 + s["words"] * 8),
            b3_row("pcr_probe_lesion", lesions[las[0]]["flat"]["full"], *las[1:]),
            b3_row("pcr_probe_floor", floors["orbit"]["full"], [chunks["orbit"][0]],
                   chunks["orbit"][1]),
            b3_row("pcr_probe_winsize", widths[chunk[0]][("chain", 8)], *chunk[1:])]
    print_probe_rows(rows, card)
    return rows


def b3_row(sym: str, ms: float, parts, size: int) -> dict:
    """A B3 probe's row: its plain version and library call
    (`scatter_reduce_`) timed on the same parts; the bound, the parts'
    bytes and the plane's."""
    from pcrhpg24_tpu_torch.experiments import probes

    library, reset = probes.amin_library(parts, size)
    return probe_row(sym, ms, probes.plain_ms(parts, size), probes.time_ms(library, 5, reset),
                     sum(nbytes(*p) for p in parts) + 8 * size)


def landed(pid, size: int) -> int:
    """Pixels that the live entries (pid < size) of `pid` land in: the
    plane words a resolve must write when the plane is filled before it."""
    import torch

    from pcrhpg24_tpu_torch.u32 import widen

    q = widen(pid.reshape(-1))
    return int(torch.unique(q[q < size]).numel())


def probe_row(sym: str, ms: float, plain_ms: float, library_ms, moved: int) -> dict:
    """A probe kernel's row of the kernels line: 0 launches (no path
    reaches it), its bound the bytes `moved` over the card's memory
    rate; `library_ms` None where no one PyTorch call computes it."""
    name, source, replaces = PROBE_INFO[sym]
    # every time is of one launch alone, on the card: ms, device_ms and
    # kernel_device_ms are that one reading
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                max_abs_err=0, ms=round(ms, 4), device_ms=round(ms, 4),
                kernel_device_ms=round(ms, 4), plain_ms=round(plain_ms, 4),
                bound_ms=round(moved / HBM_BYTES_PER_S * 1e3, 4), bound_by="bytes",
                library_ms=None if library_ms is None else round(library_ms, 4))


def print_probe_rows(rows: list, card: str) -> None:
    for r in rows:
        lib = "no single call" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {r['name']}: {r['ms']:.4f} ms device (one launch alone) vs plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (bytes), library "
              f"{lib}; reached by no path: 0 launches [{card}]")


def decoder_probe_phase(v1: tuple, v2: tuple, card: str, log: str) -> list:
    """Phase 6b, the decoders' and B2's probes: `exp_pallas_variants` and
    `exp_variant_slope` (B5's variants, one launch alone and by slope) on
    the TPU probe's input and on `v1`, (label, `probes.chunk_args`) of the
    v1 scene's busiest orbit chunk; `r3_decode_ilp` (B1's unroll and ranks
    ahead, ptxas resources from `log`) on `v2`'s, the v2 scene's;
    `exp_gather` (B12's table read) at B12's scale; `r3_div_parity` on the
    TPU probe's inputs and on `v2`'s decoded points.  Each module holds
    every variant to its plain version, and `full` within 3% of the
    shipped kernel, and raises on a mismatch.  -> the kernels line's rows
    of their four kernels (0 launches)."""
    from pcrhpg24_tpu_torch.experiments import (exp_gather, exp_pallas_variants,
                                                exp_variant_slope, r3_decode_ilp,
                                                r3_div_parity)
    from pcrhpg24_tpu_torch.render.decode_fixed import decode_fixed_batches

    ev = exp_pallas_variants
    b5_inputs = [("TPU probe input", ev.probe_input()), (v1[0], ev.inputs_of(v1[1]))]
    variants = {label: ev.run(label, ins, card) for label, ins in b5_inputs}
    slopes = {label: exp_variant_slope.run(label, ins, card, variants[label])
              for label, ins in b5_inputs}
    b1_in = r3_decode_ilp.inputs_of(v2[1])
    ilp = r3_decode_ilp.run(v2[0], b1_in, card, log)
    gather = exp_gather.run(card)
    parity = r3_div_parity.run(card, (v2[0], v2[1], decode_fixed_batches(*b1_in)))
    print(f"[gate] probes: B5's {len(ev.VARIANTS)} variants bit-exact vs decode_native_plain "
          f"or their lesion plains on {len(b5_inputs)} inputs, one launch alone and chained "
          f"({len(slopes)} x {len(ev.VARIANTS)} slopes); B1's {len(r3_decode_ilp.VARIANTS)} "
          f"variants vs decode_fixed_plain; the gather's {len(gather) - 1} source x pattern "
          f"cases vs gather_plain; the parity forms' exact ones vs their plain versions "
          f"({len(parity['probe'])} forms on the TPU probe's inputs, "
          f"{len(parity['b2'])} on B2's chain); full within 3% of the shipped B5 and B1")
    times = parity["times"]
    rows = [probe_row("pcr_probe_b5", variants[v1[0]]["full"], variants[v1[0]]["plain_ms"],
                      None, ev.moved_bytes(b5_inputs[1][1])),
            probe_row("pcr_probe_b1", ilp["full"], ilp["plain_ms"], None,
                      r3_decode_ilp.moved_bytes(b1_in)),
            probe_row("pcr_probe_gather", gather[("smem-int2", "chain")]["ms"],
                      gather["plain_ms"], None,
                      exp_gather.TABLES * exp_gather.TAB * 8 + exp_gather.LANES * 4),
            probe_row("pcr_probe_parity", times[("inv", "div_rn", "elementwise")],
                      times["plain_ms"], times["library_ms"], r3_div_parity.BIG * 8)]
    print_probe_rows(rows, card)
    return rows


def merge_probe_phase(targets: list, card: str, log: str, b10_ms: float) -> list:
    """Phase 6b, B10's exchange probe and the rest of B3's: `exp_mxu_perm`
    (55 partner-exchange stages by shuffles and through shared memory, at
    256 and 4,096 tiles, beside B10's device ms `b10_ms`); `r3_corient`
    (the chain tile read into registers) on the chain targets;
    `r3_flushacc` (a warp's same-pixel keys combined), `r3_i8dot` and
    `r3_p4dot` (narrow keys) on each target in its layout; `r4_pwin`
    (position tiles) on each in both layouts.  `targets`: (label, parts,
    plane size) of B3's parts, the first two chain, the others flat, as
    `probe_phase` takes them.  Each module holds every exact variant to
    its plain version, each count to its plain count or between its
    bounds, and each restated shipped kernel within 3% of it, and raises
    otherwise.  -> the kernels line's rows of their five kernels (0
    launches)."""
    from pcrhpg24_tpu_torch.experiments import (exp_mxu_perm, r3_corient, r3_flushacc,
                                                r3_i8dot, r3_p4dot, r4_pwin)

    perm = exp_mxu_perm.run(card, b10_ms=b10_ms)
    corient = {label: r3_corient.run(label, parts, size, card, log)
               for label, parts, size in targets[:2]}
    combine, narrow, pwin = {}, {}, {}
    for (label, parts, size), layout in zip(targets, ("chain", "chain", "flat", "flat")):
        combine[label] = r3_flushacc.run(label, parts, size, card, layout)
        narrow[label] = r3_i8dot.run(label, parts, size, card, layout)
        narrow[label].update(r3_p4dot.run(label, parts, size, card, layout))
        pwin[label] = r4_pwin.run(label, parts, size, card)
    print(f"[gate] probes: the exchange's {len(exp_mxu_perm.FORMS)} forms bit-exact vs "
          f"perm_plain at {len(exp_mxu_perm.TILES)} tile counts; r3_corient's "
          f"{len(r3_corient.FORMS)} forms on {len(corient)} chain targets, r3_flushacc's "
          f"full, count, combine and combine-count, r3_i8dot's u64 and two-pass (also vs "
          f"two_pass_plain), r3_p4dot's half-gather and r4_pwin's two tilings in both layouts "
          f"bit-exact vs u64_min_planes_plain on {len(targets)} targets; no-atomic and "
          f"combine-would-be equal to their plain counts, count and combine-count between the "
          f"landed pixels and them, the tile counts equal to tiles_plain; staged, u64 and "
          f"per-part within 3% of the shipped kernel")
    las, potree = targets[2], targets[3]
    big = perm[(exp_mxu_perm.TILES[-1], "shfl")]
    rows = [probe_row("pcr_probe_perm", big["ms"], big["plain_ms"], None,
                      exp_mxu_perm.TILES[-1] * exp_mxu_perm.SUB * exp_mxu_perm.LANES * 4 * 2),
            b3_row("pcr_probe_corient", corient[targets[1][0]]["rowload"], *targets[1][1:]),
            b3_row("pcr_probe_combine", combine[potree[0]]["combine"], *potree[1:]),
            b3_row("pcr_probe_narrow", narrow[las[0]]["two-pass"], *las[1:]),
            b3_row("pcr_probe_pwin", pwin[potree[0]][("flat", "position")]["ms"], *potree[1:])]
    print_probe_rows(rows, card)
    return rows


def b6_probe_phase(targets: list, card: str, log: str, b6_ms: float) -> list:
    """Phase 6b, the last of queue B: `r3_matscatter.py`'s two sites and
    B6's six (`pcrhpg24_tpu_torch/experiments/`).  `targets`: (label,
    unsorted stream, plane size) of the parametric near frame, the `.wg`
    orbit frame, the `.las` orbit part and Potree 5e7's steady parts laid
    end to end; `r3_matscatter` (sorts, then head stores, B6, B8 and flat
    B3) runs on all four, `r2_merge_tune` (B6's lesions) on the first
    two, `r3_kernel_floor` (its anatomy and interleaved loads),
    `r3_build_v2` (scan depth), `r3_merge_micro` (groups a warp, cp.async
    rings), `r3_merge_micro2` (instruction cuts) and `r3_rows_prefix`
    (what to sort) on the first three.  Each module holds every exact
    variant and path bit-exact to `u64_min_planes_plain`, every checksum
    and count to its plain version or bounds, and `full` within 3% of the
    shipped `pcr_merge_nk1` timed in turns, and raises otherwise; `b6_ms`
    is the shipped B6's device ms, `log` the probes' nvcc log.  -> the
    kernels line's rows of their three kernels (0 launches; the two
    resolves' bounds count 8 B for each landed pixel, as the shipped
    B6's)."""
    import torch

    from pcrhpg24_tpu_torch.experiments import (probes, r2_merge_tune, r3_build_v2,
                                                r3_kernel_floor, r3_matscatter, r3_merge_micro,
                                                r3_merge_micro2, r3_rows_prefix)
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.merge import dense_from_sorted_plain
    from pcrhpg24_tpu_torch.render.raster import sort_by_pid

    t0 = time.perf_counter()
    shipped = probes.ptxas_instances(build.build()[2])
    ship = next(r for k, r in shipped.items() if "merge_nk1_kernel" in k)
    print(f"[build] pcr_merge_nk1 (csrc/merge.cuh's defaults): {ship['registers']} registers, "
          f"{ship['spill_stores']} B spill stores, {ship['spill_loads']} B spill loads")
    for args, res in probes.instance_resources(
            r"merge_nk1_probeILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
            log).items():
        print(f"[build] B6 variant (lesion, steps, groups, stages, load, cut, head) "
              f"{tuple(map(int, args))}: {res['registers']} registers, {res['smem']} B static "
              f"shared memory, {res['spill_stores']} B spill stores")
    heads = {label: r3_matscatter.run(label, stream, size, card)
             for label, stream, size in targets}
    lesions = {label: r2_merge_tune.run(label, stream, size, card)
               for label, stream, size in targets[:2]}
    rows = {}
    for label, stream, size in targets[:3]:
        for module in (r3_kernel_floor, r3_build_v2, r3_merge_micro, r3_merge_micro2):
            module.run(label, stream, size, card)
        rows[label] = r3_rows_prefix.run(label, stream, size, card)
    seconds = time.perf_counter() - t0
    print(f"[gate] probes: r3_matscatter's atomic-head and store-head after the full-key sort, "
          f"B6 on the key- and pid-sorted streams, B8 and flat B3 bit-exact vs "
          f"u64_min_planes_plain on {len(heads)} streams, key2's order equal to key3's; B6's "
          f"lesions, anatomy, {len(r3_build_v2.VARIANTS)} depths, "
          f"{len(r3_merge_micro.VARIANTS)} (groups, stages) and the cuts bit-exact or equal to "
          f"their plain checksums and counts, and full within 3% of the shipped pcr_merge_nk1 "
          f"({b6_ms:.4f} ms device in the kernel times), on {len(rows)} streams; every "
          f"r3_rows_prefix path bit-exact and the compaction equal to its plain version: "
          f"{seconds:.1f} s")

    (param, ps_raw, psize), (las, ls_raw, lsize) = targets[0], targets[2]
    sp = sort_by_pid(*ps_raw)
    ks = probes.sort_by_key2(*ls_raw)
    live = rows[las]["live"]
    # the planes are filled outside the timed launch: a resolve reads its
    # stream and writes only the words of the pixels it lands in
    heads_lib, heads_reset = probes.amin_library([ks], lsize)
    b6_lib, b6_reset = probes.amin_library([sp], psize)
    rows_out = [
        probe_row("pcr_probe_heads", heads[las]["resolves"]["store-head"],
                  probes.time_ms(lambda: dense_from_sorted_plain(*ks, lsize), 5),
                  probes.time_ms(heads_lib, 5, heads_reset),
                  nbytes(*ks) + 8 * landed(ks[0], lsize)),
        probe_row("pcr_probe_b6", lesions[param]["full"], probes.plain_ms([sp], psize),
                  probes.time_ms(b6_lib, 5, b6_reset), nbytes(*sp) + 8 * landed(sp[0], psize)),
        probe_row("pcr_probe_compact", rows[las]["compact"], rows[las]["plain"],
                  rows[las]["plain"], nbytes(*ls_raw) + 12 * live)]
    print_probe_rows(rows_out, card)
    del sp, ks, heads_lib, b6_lib
    torch.cuda.empty_cache()
    return rows_out


def fetch_frame(port: int, view: dict) -> tuple[bytes, str]:
    """GET the viewer's /frame for `view` until it is not stale."""
    import urllib.request

    url = (f"http://127.0.0.1:{port}/frame?yaw={view['yaw']}&pitch={view['pitch']}"
           f"&radius={view['radius']}&method=0&mode=")
    for _ in range(4):
        with urllib.request.urlopen(url, timeout=120) as resp:
            body = resp.read()
            if resp.headers.get("x-stale") != "1":
                return body, resp.headers.get("x-method")
    raise RuntimeError("chip_smoke: the viewer's frames never converged")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=256,
                    help="scene size in 65,536-point batches (256 = 16.8M)")
    ap.add_argument("--potree-points", type=float, default=5e7,
                    help="points of the synthetic Potree scene (5e7: the fully resident "
                         "scene of the reference's r3_potree_frame; 1e9 its 1B-point run)")
    ap.add_argument("--potree-budget", type=float, default=None,
                    help="the Potree scene's residency cap in points (3e8 in the "
                         "reference's 1B-point run; default: all resident)")
    ap.add_argument("--flat-variants", action="store_true",
                    help="also time the variants of B3's and B4's flat design "
                         "(tools/flat_variants.py) on the .las and Potree parts")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pcrhpg24_tpu_torch import app
    from pcrhpg24_tpu_torch.engine.debug import Debug
    from pcrhpg24_tpu_torch.engine.method import Runtime
    from pcrhpg24_tpu_torch.engine.native_resource import NativeLasData
    from pcrhpg24_tpu_torch.engine.resource import HuffmanLasData
    from pcrhpg24_tpu_torch.engine.renderer import Renderer, Setting
    from pcrhpg24_tpu_torch.engine.viewer import ViewerServer
    from pcrhpg24_tpu_torch.formats.native_file import decode_tpc_batch_coords, read_tpc_batch
    from pcrhpg24_tpu_torch.experiments import probes
    from pcrhpg24_tpu_torch.kernels import build
    from pcrhpg24_tpu_torch.render.camera import frame_setup_device
    from pcrhpg24_tpu_torch import native
    from pcrhpg24_tpu_torch.codec.batch_codec import deltas_to_coords
    from pcrhpg24_tpu_torch.formats.huffman_file import read_batch, read_file_header
    from pcrhpg24_tpu_torch.render.decode_fixed import (
        decode_fixed_batches, decode_fixed_plain, pack_fixed_batches)
    from pcrhpg24_tpu_torch.render.decode_huffman import (
        PTS, decode_ref_batches, decode_ref_plain, kernel_resources)
    from pcrhpg24_tpu_torch.render.decode_tbatch import (
        decode_native_batches, decode_native_plain, pack_native_batches)
    from pcrhpg24_tpu_torch.render.hqs import (
        hqs_sums, hqs_sums_from_sorted, hqs_sums_plain)
    from pcrhpg24_tpu_torch.render.merge import (
        MERGE_NK1, dense_from_sorted, dense_from_sorted_nk1, dense_from_sorted_plain)
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu import (
        CHUNK, HuffmanTpu, frame_streams, render_frame_native)
    from pcrhpg24_tpu_torch.render.methods.huffman_hqs import hqs_huffman_frame
    from pcrhpg24_tpu_torch.render.methods.huffman_mem_iter import mem_iter_frame
    from pcrhpg24_tpu_torch.render.methods.huffman_tpu_hqs import hqs_frame_native
    from pcrhpg24_tpu_torch.render.methods.loop_las import resolve_indexed
    from pcrhpg24_tpu_torch.render.methods.loop_nodes_compressed import (
        ComputeLoopNodesCompressed, WgData, render_wg, wg_points)
    from pcrhpg24_tpu_torch.render.methods.parametric import (
        N_U, N_V, Parametric, render_parametric, surface_points)
    from pcrhpg24_tpu_torch.render.project import project_batches, project_plain
    from pcrhpg24_tpu_torch.render.raster import (
        BACKGROUND, U64_MIN, U64_MIN_FLAT, edl_shade, image_to_rgb8, key_plane, project_points, resolve,
        sort_by_pid, swizzle_dims, u64_min_planes, u64_min_planes_plain, unswizzle_plane)
    from pcrhpg24_tpu_torch.render import raster
    from pcrhpg24_tpu_torch.render.overlay import draw_bounding_boxes
    from pcrhpg24_tpu_torch.formats.las import read_points
    from pcrhpg24_tpu_torch.parallel.dryrun import dryrun_multichip
    from pcrhpg24_tpu_torch.preprocess import preprocess_las_tpc
    from pcrhpg24_tpu_torch.utils.devtime import device_ms
    from pcrhpg24_tpu_torch.utils.png import write_png_bytes
    from pcrhpg24_tpu_torch.render.tile_sort import TILE, tile_sort3, tile_sort3_plain
    from pcrhpg24_tpu_torch.tools import crafted
    from pcrhpg24_tpu_torch.u32 import INT64_MAX, biased_key, from_u32, widen

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[env] nvcc: {nvcc}")

    watch = Stopwatch()
    # ---- 2. build ----
    lib, build_s, log = build.build()
    build.load()
    print(f"[build] {os.path.relpath(lib, REPO)} from {len(build.sources())} sources "
          f"in csrc/ for sm_90a (one nvcc each, in parallel): {build_s:.2f} s")
    print_ptxas(log)
    # the probes' library (phase 6b) builds while the scenes are written
    probe_pool = ThreadPoolExecutor(1)
    probe_build = probe_pool.submit(probes.build)

    # ---- 3. scenes ----
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    base = os.path.join(REPO, "out", f"chip_smoke_{args.batches}")
    scenes = {v: f"{base}_v{v}.tpc" for v in (2, 1)}
    huf_path = base + ".huffman"
    gen_s, huf_s = build_scenes(base, args.batches)
    data = {}
    for v, path in scenes.items():
        t0 = time.perf_counter()
        data[v] = NativeLasData.create(path, DEVICE).wait_loaded()
        torch.cuda.synchronize()
        check(data[v].version == v, f"{path} is not .tpc v{v}")
        print(f"[scene] v{v}: {path} {data[v].num_batches} batches, "
              f"{data[v].num_points:,} points, {os.path.getsize(path):,} B on disk; "
              f"loaded in {time.perf_counter() - t0:.1f} s; "
              f"{nbytes(*data[v].dev.values()):,} B resident on the card")
    # the same terrain as .tpc v2 with BC7 and with raw colours
    cscenes = {fmt: f"{base}_v2_{fmt}.tpc" for fmt in COLOR_FMTS}
    cdata = {}
    for fmt, path in cscenes.items():
        t0 = time.perf_counter()
        written = not os.path.exists(path)
        if written:
            preprocess_las_tpc(base + ".las", path + ".tmp", sort=True, verbose=False,
                               color_fmt=fmt)
            os.replace(path + ".tmp", path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cdata[fmt] = NativeLasData.create(path, DEVICE).wait_loaded()
        torch.cuda.synchronize()
        check(cdata[fmt].version == 2 and cdata[fmt].color_fmt == fmt,
              f"{path} is not a .tpc v2 with {fmt} colours")
        print(f"[scene] v2 {fmt}: {path} {cdata[fmt].num_batches} batches, "
              f"{os.path.getsize(path):,} B on disk; "
              f"{f'written in {write_s:.1f} s' if written else 'cached'}; loaded in "
              f"{time.perf_counter() - t0:.1f} s; {nbytes(*cdata[fmt].dev.values()):,} B "
              f"resident on the card, of which {nbytes(cdata[fmt].dev['colors_k']):,} B "
              f"colours (BC1 v2: {nbytes(data[2].dev['colors_k']):,})")
    t0 = time.perf_counter()
    wg = WgData.create(base + ".wg", DEVICE).wait_loaded()
    torch.cuda.synchronize()
    print(f"[scene] .wg: {base}.wg {len(wg.records)} nodes, {wg.num_points:,} points, "
          f"{os.path.getsize(base + '.wg'):,} B on disk; loaded in "
          f"{time.perf_counter() - t0:.1f} s; {nbytes(*wg.dev.values()):,} B resident "
          f"on the card")
    t0 = time.perf_counter()
    huf = HuffmanLasData.create(huf_path, DEVICE).wait_loaded()
    torch.cuda.synchronize()
    print(f"[scene] .huffman: {huf_path} {huf.num_batches} batches, {huf.num_points:,} "
          f"points, {os.path.getsize(huf_path):,} B on disk; written in {huf_s:.1f} s "
          f"(0 = cached); loaded in {time.perf_counter() - t0:.1f} s; "
          f"{nbytes(*huf.dev.values()):,} B resident on the card")
    print(f"[scene] all four generated in {gen_s:.1f} s (0 = cached); allocated "
          f"{torch.cuda.memory_allocated():,} B")

    watch.lap("build and scenes")
    # ---- 4. kernel gates ----
    errs = {k: 0 for k in KERNEL_INFO}
    sl = slice(0, CHUNK)
    d2, d1 = data[2].dev, data[1].dev
    fixed_in = [d2[k][sl] for k in ("widths", "streams", "ptrs", "starts")]
    native_in = [d1[k][sl] for k in ("lj", "streams", "ptrs", "dD", "lut", "starts")]
    # the chunk's batches as the file holds them: the NumPy mirror's input,
    # and the stream words the decoders must read (for their bound)
    chunk_batches = {v: [read_tpc_batch(scenes[v], data[v].header, b)[0]
                         for b in range(min(data[v].num_batches, CHUNK))] for v in scenes}
    stream_bytes = {v: sum(np.asarray(s).nbytes for fb in fbs for s in fb.streams)
                    for v, fbs in chunk_batches.items()}
    for sym, kernel, plain, inputs, v in (
            ("pcr_decode_fixed", decode_fixed_batches, decode_fixed_plain, fixed_in, 2),
            ("pcr_decode_native", decode_native_batches, decode_native_plain, native_in, 1)):
        for pts in (64, 32):
            got = kernel(*inputs, points=pts)
            want = plain(*inputs, points=pts)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"{sym} != plain at points={pts} (max err {e})")
            errs[sym] = max(errs[sym], e)
            # the card's kernel against the plain version run on the CPU, the
            # path tests/test_torch_*.py hold to the JAX reference
            cpu = plain(*(x[:4].cpu() for x in inputs), points=pts)
            check(torch.equal(got[:4].cpu(), cpu),
                  f"{sym} on the card != CPU plain at points={pts}")
            for b in (0, len(chunk_batches[v]) - 1):
                mirror = decode_tpc_batch_coords(chunk_batches[v][b]).reshape(
                    8, 128, 64, 3)[:, :, :pts]
                mine = got[b].permute(2, 3, 0, 1).cpu().numpy()
                check(np.array_equal(mine, mirror),
                      f"{sym} != NumPy mirror on batch {b} at points={pts}")
        print(f"[gate] {KERNEL_INFO[sym][0]}: bit-exact vs its plain version "
              f"(64 batches), the plain version on the CPU (4 batches) and the "
              f"NumPy mirror (2 batches) at points 64 and 32")
    # B1 and B5 on crafted batches that reach the formats' corners
    for sym, kernel, plain, fbs, pack, keys in (
            ("pcr_decode_fixed", decode_fixed_batches, decode_fixed_plain,
             crafted.fixed_batches(seed=1), pack_fixed_batches,
             ("widths", "streams", "ptrs", "starts")),
            ("pcr_decode_native", decode_native_batches, decode_native_plain,
             crafted.native_batches(seed=2), pack_native_batches,
             ("lj", "streams", "ptrs", "dD", "lut", "starts"))):
        pk = pack(fbs)
        cin = [(from_u32(pk[k]) if pk[k].dtype == np.uint32 else torch.from_numpy(pk[k]))
               .to(DEVICE) for k in keys]
        mirrors = [decode_tpc_batch_coords(fb).reshape(8, 128, 64, 3) for fb in fbs]
        for pts in (64, 48, 32, 16, 40):
            got = kernel(*cin, points=pts)
            want = plain(*cin, points=pts)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            check(e == 0, f"{sym} != plain on the crafted batches at points={pts} "
                          f"(max err {e})")
            for b, mirror in enumerate(mirrors):
                check(np.array_equal(got[b].permute(2, 3, 0, 1).cpu().numpy(),
                                     mirror[:, :, :pts]),
                      f"{sym} != NumPy mirror on crafted batch {b} at points={pts}")
        # every 7th round pointer moved back 2,000 words: rounds no encoder
        # writes, which the kernels read from device memory once their
        # rings have moved past the words
        back = [x.clone() for x in cin]
        ptr = back[keys.index("ptrs")].view(-1)
        ptr[::7] = torch.clamp(ptr[::7] - 2000, min=0)
        for pts in (64, 48, 32, 16, 40):
            e = max_abs_err(kernel(*back, points=pts), plain(*back, points=pts))
            check(e == 0, f"{sym} != plain with moved-back pointers at points={pts} "
                          f"(max err {e})")
        words = max(len(s) for fb in fbs for s in fb.streams)
        print(f"[gate] crafted {KERNEL_INFO[sym][0]}: bit-exact vs its plain version and "
              f"the NumPy mirror on {len(fbs)} batches at points 64, 48, 32, 16 and 40 "
              f"(widest group stream {words:,} words), and vs its plain version with "
              f"every 7th round pointer moved back 2,000 words")
    del cin, back, got, want

    # B12 on the .huffman scene's first chunk: against its plain version,
    # the plain version on the CPU and the port's C++ decoder
    hd = huf.dev
    huf_in = [hd[k] if k in WHOLE_BUFFERS else hd[k][sl] for k in REF_KEYS]
    huf_hdr = read_file_header(huf_path)
    huf_batches = {b: read_batch(huf_path, huf_hdr, b)
                   for b in (0, min(huf.num_batches, CHUNK) - 1)}
    for pts in (64, 32):
        got = decode_ref_batches(*huf_in, points=pts)
        want = decode_ref_plain(*huf_in, points=pts)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"pcr_decode_huffman != plain at points={pts} (max err {e})")
        errs["pcr_decode_huffman"] = max(errs["pcr_decode_huffman"], e)
        cpu = decode_ref_plain(*(x.cpu() if k in WHOLE_BUFFERS else x[:4].cpu()
                                 for k, x in zip(REF_KEYS, huf_in)), points=pts)
        check(torch.equal(got[:4].cpu(), cpu),
              f"pcr_decode_huffman on the card != CPU plain at points={pts}")
        for b, rb in huf_batches.items():
            deltas = native.decode_ref_batch_deltas(
                rb.encoding, rb.cluster_sizes, rb.separate, rb.separate_sizes,
                rb.decoder_values, rb.decoder_cw_len)
            mirror = deltas_to_coords(deltas, rb.start_values).reshape(1024, 64, 3)
            mine = got[b].permute(2, 3, 0, 1).reshape(1024, pts, 3).cpu().numpy()
            check(np.array_equal(mine, mirror[:, :pts]),
                  f"pcr_decode_huffman != the C++ decoder on batch {b} at points={pts}")
    print(f"[gate] {KERNEL_INFO['pcr_decode_huffman'][0]}: bit-exact vs its plain version "
          f"(64 batches), the plain version on the CPU (4 batches) and the C++ "
          f".huffman decoder (batches {sorted(huf_batches)}) at points 64 and 32")
    # each crafted kind also with `encoding` and `separate` as views 1, 2
    # and 3 words into their storage: buffers that start off a 16-byte
    # boundary, so the kernel's staging windows round outwards around the
    # buffer's own start (its first words come from device memory)
    def shifted(x, by):
        buf = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
        buf[by:] = x
        return buf[by:]
    for kind in crafted.HUFFMAN_KINDS:
        ch = crafted.huffman_batches(kind, seed=5)
        cin = [(from_u32(ch[k]) if k == "encoding" else torch.from_numpy(ch[k])).to(DEVICE)
               for k in REF_KEYS]
        views = [cin] + [[shifted(x, by) if k in WHOLE_BUFFERS else x
                          for k, x in zip(REF_KEYS, cin)] for by in (1, 2, 3)]
        for pts in (64, 48, 32, 16, 40):
            want = decode_ref_plain(*cin, points=pts)
            for by, vin in enumerate(views):
                check(vin[0].data_ptr() % 16 == 4 * by, "a crafted view's offset")
                e = max_abs_err(decode_ref_batches(*vin, points=pts), want)
                check(e == 0, f"pcr_decode_huffman != plain on crafted {kind!r} batches at "
                              f"points={pts}, buffers {by} words into their storage "
                              f"(max err {e})")
        print(f"[gate] crafted {KERNEL_INFO['pcr_decode_huffman'][0]} {kind!r}: bit-exact "
              f"vs its plain version at points 64, 48, 32, 16 and 40, with the buffers "
              f"0-3 words into their storage "
              f"({ch['encoding'].size:,} words, {ch['separate'].size:,} escapes)")
    del cin, got, want, cpu

    r = Renderer(W, H, DEVICE)
    m = HuffmanTpu(r, data[2])
    size = swizzle_dims(W, H)[2]
    shapes = {}
    fmt_args = {}  # B2's arguments on the BC7 and raw scenes' orbit chunk
    for name, view in VIEWS.items():
        for lod in (1.0, 0.1):  # 0.1: the app's default LOD, buckets < 64
            a = view_args(m, r, view, lod)
            fpar = a["frame_params"]
            lod_n = torch.clamp(frame_setup_device(
                fpar[0:16].reshape(4, 4), fpar[16:22], d2["bbox_min"], d2["bbox_max"],
                fpar[23].to(torch.int32), W, H, fpar[22], True), max=a["points"])
            per_chunk = lod_n[: a["nchunks"] * CHUNK].reshape(-1, CHUNK).sum(1)
            c = int(per_chunk.argmax())  # the most populated chunk
            cs = slice(c * CHUNK, (c + 1) * CHUNK)
            t = fpar[24:40].reshape(4, 4)
            frame12 = torch.cat([t[0, :3], t[1, :3], t[3, :3], a["scale"]])
            coords = decode_fixed_batches(*(d2[k][cs] for k in
                                            ("widths", "streams", "ptrs", "starts")),
                                          points=a["points"])
            pargs = (coords, d2["colors_k"][cs], d2["anchor"][cs], a["tb"][cs],
                     lod_n[cs], frame12, W, H)
            for collapse in (True, False):
                got = project_batches(*pargs, points=a["points"], collapse=collapse)
                plain = project_plain(*pargs, points=a["points"], collapse=collapse)
                torch.cuda.synchronize()
                for g, p in zip(got, plain):
                    e = max_abs_err(g, p)
                    check(e == 0, f"B2 != plain ({name}, lod {lod}, "
                                  f"collapse={collapse}, err {e})")
                    errs["pcr_project"] = max(errs["pcr_project"], e)
                if collapse:
                    stream = got
                else:
                    hstream = got
            # B2's batch-payload mode (the debug frames' payloads): the
            # batch index and the clamped LOD count, with and without collapse
            for pay in (torch.arange(c * CHUNK, (c + 1) * CHUNK, dtype=torch.int32,
                                     device=DEVICE), lod_n[cs]):
                for collapse in (True, False):
                    got = project_batches(*pargs, points=a["points"], collapse=collapse,
                                          payload=pay)
                    plain = project_plain(*pargs, points=a["points"], collapse=collapse,
                                          payload=pay)
                    torch.cuda.synchronize()
                    for g, p in zip(got, plain):
                        e = max_abs_err(g, p)
                        check(e == 0, f"B2 payload mode != plain ({name}, lod {lod}, "
                                      f"collapse={collapse}, err {e})")
            # B2 in BC7 and raw mode on the same chunk of those scenes
            for fmt, fd in ((f, cdata[f].dev) for f in COLOR_FMTS):
                fargs = (decode_fixed_batches(*(fd[k][cs] for k in
                                                ("widths", "streams", "ptrs", "starts")),
                                              points=a["points"]),
                         fd["colors_k"][cs], fd["anchor"][cs], *pargs[3:])
                for collapse in (True, False):
                    got = project_batches(*fargs, points=a["points"], collapse=collapse,
                                          color_fmt=fmt)
                    plain = project_plain(*fargs, points=a["points"], collapse=collapse,
                                          color_fmt=fmt)
                    torch.cuda.synchronize()
                    for g, p in zip(got, plain):
                        e = max_abs_err(g, p)
                        check(e == 0, f"B2 {fmt} mode != plain ({name}, lod {lod}, "
                                      f"collapse={collapse}, err {e})")
                        errs[f"pcr_project:{fmt}"] = max(errs[f"pcr_project:{fmt}"], e)
                if name == "orbit" and lod == 1.0:
                    fmt_args[fmt] = fargs
            for st, mode in ((hstream, "HQS"), (stream, "colour")):
                planes = u64_min_planes([st], size)
                errs["pcr_u64_min"] = max(errs["pcr_u64_min"], same_planes(
                    planes, u64_min_planes_plain([st], size),
                    f"B3 != plain ({name}, lod {lod}, {mode} stream)"))
            live = [int((widen(x[0]) < size).sum()) for x in (stream, hstream)]
            print(f"[gate] {name} lod {lod}: chunk {c}, points {a['points']}: B2 "
                  f"bit-exact vs project_plain (colour + HQS, in batch-payload mode "
                  f"with the batch index and the LOD count, and in BC7 and raw mode on "
                  f"those scenes' chunk), B3 bit-exact vs "
                  f"u64_min_planes_plain on the colour and HQS streams ({live[0]:,} and "
                  f"{live[1]:,} live entries)")
            if name == "orbit" and lod == 1.0:
                shapes = dict(decode=(fixed_in, a["points"]), project=(pargs, a["points"]),
                              stream=stream)
                # the card's kernels against the plain versions run on the CPU,
                # the path tests/test_torch_*.py hold to the JAX reference
                cpu = [x.cpu() if torch.is_tensor(x) else x for x in pargs]
                for g, p in zip(stream, project_plain(*cpu, points=a["points"])):
                    check(torch.equal(g.cpu(), p), "B2 on the card != CPU plain")
                for g, p in zip(planes, u64_min_planes_plain(
                        [tuple(x.cpu() for x in stream)], size)):
                    check(torch.equal(g.cpu(), p), "B3 on the card != CPU plain")
                print("[gate] orbit: B2 stream and B3 planes from the card equal "
                      "the plain versions run on the CPU")

    # B3 and B4 on the orbit view's uncollapsed streams of every live
    # chunk, B3 on its colour streams: the frame's parts, one call each
    a = view_args(m, r, VIEWS["orbit"], 1.0)
    parts, size, _dev = frame_streams(**a, collapse=False)
    cparts, _size, _dev = frame_streams(**a)
    for fparts, mode in ((parts, "HQS"), (cparts, "colour")):
        errs["pcr_u64_min"] = max(errs["pcr_u64_min"], same_planes(
            u64_min_planes(fparts, size), u64_min_planes_plain(fparts, size),
            f"B3 != plain on the orbit frame's {mode} parts"))
    print(f"[gate] orbit lod 1.0: B3 bit-exact vs u64_min_planes_plain over the frame's "
          f"{len(cparts)} colour parts and {len(parts)} HQS parts in one call each")
    fb_d = u64_min_planes(parts, size)[0].contiguous()
    got = hqs_sums(parts, fb_d, size)
    want = hqs_sums_plain(parts, fb_d, size)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        e = max_abs_err(g, p)
        check(e == 0, f"B4 != plain (orbit, err {e})")
        errs["pcr_hqs_sums"] = max(errs["pcr_hqs_sums"], e)
    accepted = int(widen(got[3]).sum())
    entries = sum(int((p[0] < size).sum()) for p in parts)
    print(f"[gate] orbit lod 1.0 HQS: B4 bit-exact vs hqs_sums_plain over "
          f"{len(parts)} live chunks ({entries:,} live entries, {accepted:,} "
          f"accepted)")
    one = hqs_sums([parts[0]], fb_d, size)
    cpu = hqs_sums_plain([tuple(x.cpu() for x in parts[0])], fb_d.cpu(), size)
    for g, p in zip(one, cpu):
        check(torch.equal(g.cpu(), p), "B4 on the card != CPU plain")
    print("[gate] orbit: B4 planes of one chunk from the card equal the plain "
          "version run on the CPU")
    for what, q in (("B4, HQS chunk: accepted entries", hqs_accepted(*parts[0][:2], fb_d, size)),
                    ("B3, colour chunk: live entries", widen(cparts[0][0].reshape(-1))),
                    ("B3, HQS chunk: live entries", widen(parts[0][0].reshape(-1)))):
        n_q, tiled, flat, _pairs = atomic_groups([q], size)
        print(f"[gate] orbit {what} {n_q:,} fall into {tiled:,} (warp, pixel) groups "
              f"of 32-point chain columns ({tiled / n_q:.3f} atomic sets per entry), "
              f"{flat:,} over flat 32-entry warps ({flat / n_q:.3f})")
    shapes["hqs"] = ([parts[0]], fb_d)
    shapes["frame"] = dict(colour=cparts, hqs=parts)
    del parts, cparts, got, want, one, cpu
    Debug.lod = 1.0

    # B2 on crafted chunks: non-contiguous pid repeats along chains and
    # across chain heads, sentinels, tied depths, a partial lodn; the LOD
    # buckets have builds of their own, 40 takes the run-time count
    for pts in (16, 32, 40, 48, 64):
        ca = crafted.project_inputs(CHUNK, pts, W, H, seed=pts)
        cargs = [torch.from_numpy(ca["coords"]).to(DEVICE),
                 from_u32(ca["colors_k"]).to(DEVICE),
                 *(torch.from_numpy(ca[k]).to(DEVICE)
                   for k in ("anchors", "tbc", "lodn", "frame")), W, H]
        modes = [(6, True, True), (6, True, False), (3, True, True), (3, True, False),
                 (6, False, False)]
        for steps, collapse, chain in modes:
            got = project_batches(*cargs, points=pts, steps=steps, chain_collapse=chain,
                                  collapse=collapse)
            want = project_plain(*cargs, points=pts, steps=steps, chain_collapse=chain,
                                 collapse=collapse)
            torch.cuda.synchronize()
            for g, p in zip(got, want):
                e = max_abs_err(g, p)
                check(e == 0, f"B2 != plain on the crafted chunk (points {pts}, steps "
                              f"{steps}, collapse={collapse}, chain={chain}, err {e})")
        raw = want[0]
        aba = ((raw[:, :-2] == raw[:, 2:]) & (raw[:, :-2] != raw[:, 1:-1])
               & (widen(raw[:, 2:]) < size))
        paid = ""
        if pts in (16, 40, 64):  # batch-payload mode with a ragged per-batch payload
            cpay = from_u32(crafted.batch_payloads(len(ca["lodn"]), seed=pts)).to(DEVICE)
            for steps, collapse, chain in modes:
                got = project_batches(*cargs, points=pts, steps=steps, chain_collapse=chain,
                                      collapse=collapse, payload=cpay)
                want = project_plain(*cargs, points=pts, steps=steps, chain_collapse=chain,
                                     collapse=collapse, payload=cpay)
                torch.cuda.synchronize()
                for g, p in zip(got, want):
                    e = max_abs_err(g, p)
                    check(e == 0, f"B2 payload mode != plain on the crafted chunk (points "
                                  f"{pts}, steps {steps}, collapse={collapse}, "
                                  f"chain={chain}, err {e})")
            paid = ", each also in batch-payload mode with a ragged per-batch payload"
        # BC7 mode on crafted blocks, raw mode on words with their top byte set
        for fmt in COLOR_FMTS:
            fargs = [cargs[0], from_u32(crafted.colors_k(len(ca["lodn"]), fmt,
                                                         seed=pts)).to(DEVICE), *cargs[2:]]
            for steps, collapse, chain in modes:
                got = project_batches(*fargs, points=pts, steps=steps, chain_collapse=chain,
                                      collapse=collapse, color_fmt=fmt)
                want = project_plain(*fargs, points=pts, steps=steps, chain_collapse=chain,
                                     collapse=collapse, color_fmt=fmt)
                torch.cuda.synchronize()
                for g, p in zip(got, want):
                    e = max_abs_err(g, p)
                    check(e == 0, f"B2 {fmt} mode != plain on the crafted chunk (points "
                                  f"{pts}, steps {steps}, collapse={collapse}, "
                                  f"chain={chain}, err {e})")
        paid += "; each in BC7 mode (crafted blocks) and raw mode"
        print(f"[gate] crafted chunk, points {pts}: B2 bit-exact vs project_plain at "
              f"steps 6 and 3, colour with and without the head ladder, and HQS{paid} "
              f"({int(aba.sum()):,} A B A triples along chains, "
              f"{int((widen(raw) < size).sum()):,} live entries)")
    del ca, cargs, got, want, raw

    # B4 on crafted streams, split into uneven parts (one into 70: two launches)
    for kind in crafted.HQS_KINDS:
        cp, cd, cy, cf = (from_u32(x).to(DEVICE) for x in
                          crafted.hqs_streams(kind, 4096, size, seed=7))
        cuts = [0, 1000 * 1024 + 37, 1001 * 1024, 3333 * 1024 + 5, cp.numel()]
        if kind == "mixed":
            cuts = np.linspace(0, cp.numel(), 71).astype(int).tolist()
        cparts = [(cp[a:b], cd[a:b], cy[a:b]) for a, b in zip(cuts, cuts[1:])]
        got = hqs_sums(cparts, cf, size)
        want = hqs_sums_plain(cparts, cf, size)
        same_planes(got, want, f"B4 != plain on crafted {kind} streams")
        print(f"[gate] crafted HQS stream {kind!r}: B4 bit-exact vs hqs_sums_plain over "
              f"{len(cparts)} parts ({cp.numel():,} entries, "
              f"{int(widen(got[3]).sum()):,} accepted)")
    many = 2**24 + 1  # 255 * many wraps the r plane
    wrap = (torch.full((many,), 5, dtype=torch.int32, device=DEVICE),
            torch.full((many,), 0x3F800000, dtype=torch.int32, device=DEVICE),
            torch.full((many,), 255, dtype=torch.int32, device=DEVICE))
    wfb = torch.full((8,), 0x3F800000, dtype=torch.int32, device=DEVICE)
    got = hqs_sums([wrap], wfb, 8)
    same_planes(got, hqs_sums_plain([wrap], wfb, 8), "B4 != plain on wrapping sums")
    check(int(widen(got[0])[5]) == 255 * many % 2**32, "B4's r sum did not wrap mod 2**32")
    print(f"[gate] B4 on {many:,} entries of one pixel: sums wrap mod 2**32 as the "
          f"plain version's")
    del cp, cd, cy, cf, cparts, got, want, wrap

    # B3 on crafted streams, in 4 uneven parts and in 70 (two launches),
    # in both part orders
    for kind in crafted.RESOLVE_KINDS:
        cp, cd, cy = (from_u32(x).to(DEVICE) for x in
                      crafted.resolve_streams(kind, 4096, size, seed=7))
        for cuts in ([0, 1000 * 1024 + 37, 1001 * 1024, 3333 * 1024 + 5, cp.numel()],
                     np.linspace(0, cp.numel(), 71).astype(int).tolist()):
            cparts = [(cp[a:b], cd[a:b], cy[a:b]) for a, b in zip(cuts, cuts[1:])]
            want = u64_min_planes_plain(cparts, size)
            for order in (cparts, cparts[::-1]):
                errs["pcr_u64_min"] = max(errs["pcr_u64_min"], same_planes(
                    u64_min_planes(order, size), want,
                    f"B3 != plain on crafted {kind} streams ({len(cparts)} parts)"))
        print(f"[gate] crafted resolve stream {kind!r}: B3 bit-exact vs "
              f"u64_min_planes_plain in 4 and 70 parts, both orders ({cp.numel():,} "
              f"entries, {int((widen(want[1]) != 0xFFFFFFFF).sum()):,} pixels landed)")
    one = torch.full((many,), 5, dtype=torch.int32, device=DEVICE)
    falling = torch.arange(many, 0, -1, dtype=torch.int32, device=DEVICE)
    part = (one, falling, torch.flip(falling, (0,)))
    got = u64_min_planes([part], 8)
    same_planes(got, u64_min_planes_plain([part], 8), f"B3 != plain on {many:,} entries")
    check(int(got[0][5]) == 1 and int(got[1][5]) == many, "B3's min on one pixel")
    print(f"[gate] B3 on {many:,} entries of one pixel, depths falling: bit-exact vs "
          f"u64_min_planes_plain")
    del cp, cd, cy, cparts, got, want, one, falling, part

    # B3 and B4 in both layouts on flat crafted streams (`crafted.flat_streams`):
    # one pixel over 2**24 + 1 entries, runs of one pixel along consecutive
    # entries, random pixels; 4M entries less 333, in 4 and in 70 uneven parts
    # (two launches) none a multiple of the flat tile's 512 entries, both orders
    for kind in crafted.FLAT_KINDS:
        n_f = many if kind == "one_pixel" else 4096 * 1024 - 333
        fpid, fdep, fpay, fcol, ffb = (from_u32(x).to(DEVICE) for x in
                                       crafted.flat_streams(kind, n_f, size, seed=13))
        for nparts in (4, 70):
            cuts = crafted.flat_cuts(n_f, nparts, seed=nparts)
            b3p = [(fpid[a:b], fdep[a:b], fpay[a:b]) for a, b in zip(cuts, cuts[1:])]
            b4p = [(fpid[a:b], fdep[a:b], fcol[a:b]) for a, b in zip(cuts, cuts[1:])]
            want = u64_min_planes_plain(b3p, size)
            want4 = hqs_sums_plain(b4p, ffb, size)
            for layout, suffix in (("flat", "_flat"), ("chain", "")):
                for o3, o4 in ((b3p, b4p), (b3p[::-1], b4p[::-1])):
                    errs["pcr_u64_min" + suffix] = max(errs["pcr_u64_min" + suffix], same_planes(
                        u64_min_planes(o3, size, layout=layout), want,
                        f"B3 ({layout}) != plain on flat crafted {kind} ({nparts} parts)"))
                    errs["pcr_hqs_sums" + suffix] = max(errs["pcr_hqs_sums" + suffix], same_planes(
                        hqs_sums(o4, ffb, size, layout=layout), want4,
                        f"B4 ({layout}) != plain on flat crafted {kind} ({nparts} parts)"))
        if kind == "one_pixel":
            q = int(fpid[0])
            check(int(widen(want4[0])[q]) == 255 * many % 2**32 and int(want[1][q]) == 0,
                  "flat crafted one_pixel: B4's r sum did not wrap, or B3's tie went wrong")
        print(f"[gate] flat crafted stream {kind!r} ({n_f:,} entries, "
              f"{int((widen(fpid) < size).sum()):,} landing, "
              f"{int(widen(want4[3]).sum()):,} accepted): B3 and B4 in the flat and the chain "
              f"layout bit-exact vs their plain versions in 4 and 70 parts, both orders")
    del fpid, fdep, fpay, fcol, ffb, b3p, b4p, want, want4

    # B3 and B4 on a crafted Potree part (`crafted.potree_part`): many nodes,
    # each a run of nearby pixels in random order, culled nodes and budget
    # tails dropped; in two groups into a running plane and accumulator (as
    # `loop_nodes` resolves a frame's live chunks), against the plain
    # versions over the whole part in one call
    psize = W * H
    cp, cd, cy, cc, cf = (from_u32(x).to(DEVICE) for x in
                          crafted.potree_part(2000, W, H, seed=11))
    half = cp.numel() // 2 + 37
    want = u64_min_planes_plain([(cp, cd, cy)], psize)
    check(torch.equal(want[0], cf), "crafted Potree part: its depth plane")
    plane = key_plane(psize, DEVICE)
    for sl_ in (slice(0, half), slice(half, None)):
        got = u64_min_planes([(cp[sl_], cd[sl_], cy[sl_])], psize, plane)
    errs["pcr_u64_min"] = max(errs["pcr_u64_min"], same_planes(
        got, want, "B3 != plain on the crafted Potree part, two groups"))
    same_planes(u64_min_planes([(cp, cd, cy)], psize), want,
                "B3 != plain on the crafted Potree part")
    want = hqs_sums_plain([(cp, cd, cc)], cf, psize)
    acc = torch.zeros((psize, 4), dtype=torch.int32, device=DEVICE)
    for sl_ in (slice(0, half), slice(half, None)):
        got = hqs_sums([(cp[sl_], cd[sl_], cc[sl_])], cf, psize, acc)
    errs["pcr_hqs_sums"] = max(errs["pcr_hqs_sums"], same_planes(
        got, want, "B4 != plain on the crafted Potree part, two groups"))
    same_planes(hqs_sums([(cp, cd, cc)], cf, psize), want,
                "B4 != plain on the crafted Potree part")
    print(f"[gate] crafted Potree part (2,000 nodes, {cp.numel():,} entries, "
          f"{int((widen(cp) < psize).sum()):,} live, {int(widen(want[3]).sum()):,} "
          f"accepted): B3 and B4 bit-exact vs their plain versions, in one call and in "
          f"two groups into a running plane and accumulator")
    del cp, cd, cy, cc, cf, got, want, plane, acc

    # B6 on the parametric frame's pid-sorted stream, for each camera
    cut = 1 << 18  # entries of the cut-down input held to the CPU plain version
    param = Parametric(Renderer(W, H, DEVICE))
    for name, view in PARAM_VIEWS.items():
        rp = Renderer(W, H, DEVICE)
        rp.apply_setting(Setting(**view))
        rp.controls_update()
        fx, fy, fz, rgba = surface_points(param.surface, rp.device)
        pid, depth = project_points(fx, fy, fz, param.transform(rp), W, H)
        sp = sort_by_pid(pid, depth, rgba)
        errs["pcr_merge_nk1"] = max(errs["pcr_merge_nk1"], same_planes(
            dense_from_sorted_nk1(*sp, W * H), u64_min_planes_plain([sp], W * H),
            f"B6 != plain (parametric {name})"))
        live = int((sp[0] < W * H).sum())
        if name == "near":
            shapes["param"] = sp
            shapes["param raw"] = (pid, depth, rgba)
            part = tuple(x[:cut] for x in sp)
            same_planes(dense_from_sorted_nk1(*part, W * H),
                        u64_min_planes_plain([tuple(x.cpu() for x in part)], W * H),
                        "B6 on the card != CPU plain (parametric cut)")
        print(f"[gate] parametric {name}: B6 bit-exact vs u64_min_planes_plain on the "
              f"pid-sorted stream ({N_U * N_V:,} entries, {live:,} live)")
    del fx, fy, fz, rgba, pid, depth, sp
    print(f"[gate] B6 on the first {cut:,} sorted entries of the parametric near "
          f"stream equals the plain version run on the CPU")

    # B6 and B8 on the colour orbit chunk's stream, against B3's planes
    stream = shapes["stream"]
    b3 = u64_min_planes([stream], size)
    s1 = sort_by_pid(*stream)
    errs["pcr_merge_nk1"] = max(errs["pcr_merge_nk1"], same_planes(
        dense_from_sorted_nk1(*s1, size), b3, "B6 (pid-sorted) != B3 (unsorted)"))
    same_planes(dense_from_sorted_nk1(*s1, size), u64_min_planes_plain([s1], size),
                "B6 != plain (orbit chunk)")
    s3 = probes.sort_by_key3(*stream)
    shapes["key3"] = s3
    for need_depth in (True, False):
        want = (b3[0] if need_depth else None, b3[1])
        got = dense_from_sorted(*s3, size, need_depth)
        errs["pcr_merge_heads"] = max(errs["pcr_merge_heads"], same_planes(
            got, want, f"B8 != B3 (need_depth={need_depth})"))
        same_planes(got, dense_from_sorted_plain(*s3, size, need_depth),
                    f"B8 != plain (need_depth={need_depth})")
        part = tuple(x[:cut] for x in s3)
        same_planes(dense_from_sorted(*part, size, need_depth),
                    dense_from_sorted_plain(*(x.cpu() for x in part), size, need_depth),
                    f"B8 on the card != CPU plain (need_depth={need_depth})")
    part = tuple(x[:cut] for x in s1)
    same_planes(dense_from_sorted_nk1(*part, size),
                u64_min_planes_plain([tuple(x.cpu() for x in part)], size),
                "B6 on the card != CPU plain (orbit chunk cut)")
    print(f"[gate] orbit chunk: B6 on the pid-sorted stream and B8 on the 3-key-sorted "
          f"stream (with and without depth) equal B3's planes and their plain "
          f"versions ({stream[0].numel():,} entries); the first {cut:,} sorted "
          f"entries equal the plain versions run on the CPU")
    del b3, s1, got, want

    # B9 on the HQS orbit chunk's stream sorted by pid, against B4's sums
    (hpart,), hfb = shapes["hqs"]
    hs = sort_by_pid(*hpart)
    shapes["hqs_sorted"] = hs
    got = hqs_sums_from_sorted(*hs, hfb, size)
    errs["pcr_hqs_sorted"] = same_planes(got, hqs_sums([hpart], hfb, size),
                                         "B9 (pid-sorted) != B4 (unsorted)")
    same_planes(got, hqs_sums_plain([hs], hfb, size), "B9 != plain")
    part = tuple(x[:cut] for x in hs)
    same_planes(hqs_sums_from_sorted(*part, hfb, size),
                hqs_sums_plain([tuple(x.cpu() for x in part)], hfb.cpu(), size),
                "B9 on the card != CPU plain")
    print(f"[gate] orbit HQS chunk: B9 on the pid-sorted stream equals B4's sums and "
          f"hqs_sums_plain ({hs[0].numel():,} entries, {int(widen(got[3]).sum()):,} "
          f"accepted); its first {cut:,} entries equal the CPU plain version")

    # B10 on the first 4,096 tiles of the HQS chunk's (unsorted) stream
    tiles = min(4096, hpart[0].numel() // TILE)
    keys = [x.reshape(-1)[: tiles * TILE].reshape(tiles, 8, 128) for x in hpart]
    shapes["tiles"] = keys
    got = tile_sort3(*keys)
    errs["pcr_tile_sort3"] = same_planes(got, tile_sort3_plain(*keys), "B10 != plain")
    check(lexsorted(got, keys), "B10 != np.lexsort on the HQS tiles")
    same_planes([g[:16] for g in got], tile_sort3_plain(*(k[:16].cpu() for k in keys)),
                "B10 on the card != CPU plain")
    print(f"[gate] B10 bit-exact vs tile_sort3_plain and np.lexsort on {tiles:,} tiles of "
          f"the HQS orbit chunk's stream; its first 16 tiles equal the CPU plain version")
    # B10 on crafted tiles: 4,097 is ragged against any tiles per block
    for kind in crafted.TILE_KINDS:
        for n_tiles in (4097, 1, 0):
            ck = [torch.from_numpy(k).to(DEVICE) for k in
                  crafted.tile_keys(kind, n_tiles, seed=n_tiles)]
            got = tile_sort3(*ck)
            errs["pcr_tile_sort3"] = max(errs["pcr_tile_sort3"], same_planes(
                got, tile_sort3_plain(*ck), f"B10 != plain on {n_tiles} {kind!r} tiles"))
            check(lexsorted(got, ck), f"B10 != np.lexsort on {n_tiles} {kind!r} tiles")
    print(f"[gate] B10 bit-exact vs tile_sort3_plain and np.lexsort on crafted tiles "
          f"({', '.join(crafted.TILE_KINDS)}) at 4,097, 1 and 0 tiles")
    del got, keys, ck, hpart, hs

    watch.lap("kernel gates")
    # ---- 5. main paths through the app ----
    results = {}
    colour_v2 = {}  # huffman_tpu's images on the .tpc v2, by view
    tpc_f32 = None  # the .tpc v2 with las_min rounded to f32
    plain_frames = {"huffman_tpu": lambda fa: render_frame_native(**fa, plain=True)[2],
                    "huffman_tpu_hqs": lambda fa: hqs_frame_native(**fa, plain=True)[2],
                    "huffman_mem_iter": lambda fa: mem_iter_frame(**fa, plain=True)[2],
                    "huffman_hqs": lambda fa: hqs_huffman_frame(**fa, plain=True)[2]}
    # the raw scene's input colours: every pixel of its colour frame is one
    las_colours = torch.unique(torch.from_numpy(
        (read_points(base + ".las", 0, args.batches * 65536).color.astype(np.uint32)
         & 0xFFFFFF).view(np.int32)).to(DEVICE))
    for label, method_name, v, must in MAIN_PATHS:
        if label == f"colour v2 {COLOR_FMTS[0]}":
            watch.lap("main paths of the BC1 .tpc and .huffman scenes")
        tag = ("huffman" if v == "huffman" else f"v2_{v}" if v in COLOR_FMTS else f"v{v}")
        path = (huf_path if v == "huffman" else cscenes[v] if v in COLOR_FMTS
                else scenes[v])
        for name, view in TPC_VIEWS.items():
            argv = app_argv(path, method_name, view, WARMUP + FRAMES)
            if name == "orbit":
                shot = f"chip_smoke_{method_name}_{tag}_orbit.png"
                argv += ["--screenshot", os.path.join(REPO, "out", shot)]
            for k in build.KERNELS.values():
                k.launches = 0
            rr = app.run(argv)
            launches = {s: k.launches for s, k in build.KERNELS.items()}
            for s in must:
                check(launches[s] > 0, f"{s} never launched on the main path "
                                       f"({label}, {name})")
            check(launches["pcr_u64_min"] == WARMUP + FRAMES,
                  f"pcr_u64_min launched {launches['pcr_u64_min']} times in "
                  f"{WARMUP + FRAMES} frames ({label}, {name}): not once per frame")
            img = rr.last_image
            check(img is not None and tuple(img.shape) == (H, W), f"no {H}x{W} image")
            shown = int((img != BACKGROUND).sum())
            check(shown > 0, f"{label} {name}: the image is all background")
            method = Runtime.selected
            fa = method.frame_args(rr)
            img_plain = plain_frames[method_name](fa)
            torch.cuda.synchronize()
            e = max_abs_err(img, img_plain)
            check(e == 0, f"{label} {name}: main-path image != all-plain frame "
                          f"(err {e})")
            same = ""
            if label == "colour v2":
                colour_v2[name] = img.cpu()
            if label == "colour v2 raw":
                vals = torch.unique(img[img != BACKGROUND])
                check(bool(torch.isin(vals, las_colours).all()),
                      f"{label} {name}: a pixel carries a colour no input point has")
                same = (f"; each of its {vals.numel():,} colours one of the scene's "
                        f"{las_colours.numel():,} input colours")
            if label == "huffman->v2":  # tests/test_native_pipeline.py:227-244
                # `.huffman` stores las_min as f32, `.tpc` as f64: the same
                # points on the same kernels, with the `.tpc`'s las_min
                # rounded as the `.huffman`'s, give the same image
                if tpc_f32 is None:
                    tpc_f32 = NativeLasData.create(scenes[2], DEVICE)
                    tpc_f32.las_min = np.float32(tpc_f32.las_min).astype(np.float64)
                    tpc_f32.wait_loaded()
                check(np.array_equal(tpc_f32.las_min, method.las.las_min),
                      "the .huffman's las_min is not the .tpc's rounded to f32")
                want = render_frame_native(**HuffmanTpu(rr, tpc_f32).frame_args(rr))[2]
                check(torch.equal(img, want),
                      f"{label} {name}: image != huffman_tpu's on the .tpc v2 with "
                      f"las_min in f32")
                moved = int((img.cpu() != colour_v2[name]).sum())
                same = (f"; equal to huffman_tpu's image on the .tpc v2 with las_min in "
                        f"f32 ({moved:,} pixels differ from the f64 las_min's)")
            _, lod_full = method.frame_setup(rr)
            visible = int(lod_full.astype(np.int64).sum() * 1024)
            # the chunks the frame decoded
            nchunks = -(-method.las.num_batches // CHUNK)
            live = len(fa["chunks"]) if "chunks" in fa else len(frame_streams(**fa)[0])
            if name == "corner":
                check(live < nchunks, f"{label} corner: {live} of {nchunks} "
                                      f"chunks live, none culled")
            ms = statistics.median(rr.frame_ms[WARMUP:])
            results[(label, name)] = dict(
                frame_ms=ms, visible=visible, shown=shown, launches=launches,
                frames=len(rr.frame_ms[WARMUP:]))
            scene = (".huffman" if v == "huffman" else f".tpc v2 {v}" if v in COLOR_FMTS
                     else f".tpc v{v}")
            print(f"[main] {label} ({method_name}, {scene}) {name}: {shown:,} pixels "
                  f"shown, image bit-exact vs the all-plain frame{same}; {live} of "
                  f"{nchunks} chunks live; launches "
                  f"{ {s: launches[s] for s in must} }")
            method.las.unload()
            del rr, method, img, img_plain
            Runtime.clear()
            torch.cuda.empty_cache()

    watch.lap("main paths of the BC7 and raw .tpc scenes")

    def b6_frame(label, name, rr, launches, img, img_plain, points):
        """Checks and records the run of a path that must launch B6."""
        check(launches["pcr_merge_nk1"] > 0,
              f"pcr_merge_nk1 never launched on the main path ({label}, {name})")
        check(img is not None and tuple(img.shape) == (H, W), f"no {H}x{W} image")
        shown = int((img != BACKGROUND).sum())
        check(shown > 0, f"{label} {name}: the image is all background")
        e = max_abs_err(img, img_plain)
        check(e == 0, f"{label} {name}: main-path image != all-plain frame (err {e})")
        results[(label, name)] = dict(
            frame_ms=statistics.median(rr.frame_ms[WARMUP:]), visible=points,
            shown=shown, launches=launches, frames=len(rr.frame_ms[WARMUP:]))
        print(f"[main] {label} {name}: {shown:,} pixels shown, image bit-exact vs the "
              f"all-plain frame; launches {{'pcr_merge_nk1': "
              f"{launches['pcr_merge_nk1']}}}")

    # parametric through the app: the sphere, regenerated every frame
    for name, view in PARAM_VIEWS.items():
        argv = ["--scene", "parametric", "--device", DEVICE, "--width", str(W),
                "--height", str(H), "--yaw", str(view["yaw"]), "--pitch",
                str(view["pitch"]), "--radius", str(view["radius"]),
                "--target", *map(str, view["target"]), "--frames", str(WARMUP + FRAMES)]
        if name == "near":
            argv += ["--screenshot", os.path.join(REPO, "out", "chip_smoke_parametric.png")]
        for k in build.KERNELS.values():
            k.launches = 0
        rr = app.run(argv)
        launches = {s: k.launches for s, k in build.KERNELS.items()}
        method = Runtime.selected
        _fb_d, fb_p = render_parametric(method.transform(rr), method.surface, W, H,
                                        plain=True)
        b6_frame("parametric", name, rr, launches, rr.last_image, resolve(fb_p, W, H),
                 N_U * N_V)
        Runtime.clear()
        del rr, method

    # loop_nodes_compressed on the .wg scene, through Renderer.loop
    for name, view in VIEWS.items():
        rw = Renderer(W, H, DEVICE)
        rw.apply_setting(Setting(**view))
        m = ComputeLoopNodesCompressed(rw, wg)
        for k in build.KERNELS.values():
            k.launches = 0
        rw.loop(m.update, m.render, frames=WARMUP + FRAMES)
        launches = {s: k.launches for s, k in build.KERNELS.items()}
        _fb_d, fb_p = render_wg(**wg.dev, transform=m.transform(rw), width=W, height=H,
                                plain=True)
        if name == "orbit":  # the stream B6 resolves, for the B6 probes
            d = wg.dev
            wpid, wdep = project_points(*wg_points(d["words"], d["bits"], d["base_bit"],
                                                   d["bmin"], d["bmax"]), m.transform(rw), W, H)
            shapes["wg"] = (wpid, wdep, torch.arange(wpid.numel(), dtype=torch.int32,
                                                     device=DEVICE))
        b6_frame("wg", name, rw, launches, rw.last_image,
                 resolve_indexed(fb_p, wg.dev["colors"], W, H), wg.num_points)
        del rw, m
    wg.unload()
    torch.cuda.empty_cache()

    tpc_f32.unload()

    # the `.las` methods, and `basic` on the multi-file scene
    watch.lap("main paths of the parametric and .wg scenes")
    las_shapes = las_phase(base + ".las", multi_paths(base), results, errs, card)
    watch.lap("the .las methods")

    # the Potree scene's two methods, one load for every view
    potree_path, potree_s = potree_scene(int(args.potree_points))
    print(f"[scene] potree: {potree_path} written in {potree_s:.1f} s (0 = cached), "
          f"{sum(os.path.getsize(os.path.join(potree_path, f)) for f in os.listdir(potree_path)):,}"
          f" B on disk")
    potree_budget = None if args.potree_budget is None else int(args.potree_budget)
    potree_shapes = potree_phase(potree_path, potree_budget, results, errs, card)
    watch.lap("the Potree scene and methods")

    # ---- 5b. the flagship frame's other outputs, through the app ----
    output_phase({2: scenes[2], 1: scenes[1], "huffman": huf_path, "las": base + ".las"},
                 results)
    # a --trace run: the profiler's ranges name each launch by its C symbol
    trace_dir = os.path.join(REPO, "out", "chip_smoke_trace")
    rr = app.run(app_argv(scenes[2], "huffman_tpu", VIEWS["orbit"], 2)
                 + ["--trace", trace_dir])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    named = {e.get("name") for e in events}
    on_card = [e for e in events if e.get("cat") == "kernel"]
    for sym in ("pcr_decode_fixed", "pcr_project", "pcr_u64_min"):
        check(sym in named, f"the --trace file names no {sym}")
    check(len(on_card) > 0, "the --trace file holds no kernel run on the card")
    print(f"[output] --trace {os.path.relpath(trace_dir, REPO)}/trace.json: {len(events):,} "
          f"events, {len(on_card):,} kernels on the card over 2 frames, ranges "
          f"pcr_decode_fixed, pcr_project and pcr_u64_min present")
    Runtime.selected.las.unload()
    Runtime.clear()
    del rr
    # the viewer on an ephemeral localhost port: its /frame is the app's image
    rv = Renderer(W, H, DEVICE)
    rv.apply_setting(Setting(**VIEWS["orbit"]))
    Debug.lod = 1.0
    vmethods = app.build_methods(rv, scenes[2])
    app.wait_loaded(vmethods[0], rv)
    srv = ViewerServer(rv, vmethods, 0)
    port = srv.bind()
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info", timeout=60) as resp:
            info = json.loads(resp.read())
        check(info["methods"] == ["huffman_tpu", "huffman_tpu_hqs"], f"viewer /info {info}")
        png, served_by = fetch_frame(port, VIEWS["orbit"])
        want = write_png_bytes(image_to_rgb8(colour_v2["orbit"]).numpy(), level=1)
        check(served_by == "huffman_tpu" and png == want,
              "the viewer's /frame != the app's colour v2 orbit image")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/timings", timeout=60) as resp:
            rows = json.loads(resp.read())["rows"]
        check(any(r_["label"] == "frame" for r_ in rows), "viewer /timings has no frame row")
    finally:
        srv.shutdown()
        server.join(timeout=60)
        vmethods[0].las.unload()
        Runtime.clear()
    check(not server.is_alive(), "the viewer's server thread did not stop")
    print(f"[output] viewer on 127.0.0.1:{port}: /info, /timings, and /frame (orbit) "
          f"byte-equal to the PNG of the app's colour v2 orbit image ({len(png):,} B)")
    torch.cuda.empty_cache()

    watch.lap("the flagship frame's other outputs")
    # ---- 5c. the sharded frames (ROADMAP A12): two ranks on the card ----
    t_a12 = time.perf_counter()
    torch.cuda.empty_cache()
    a12_views = {"orbit": VIEWS["orbit"]}
    tasks = []
    # the BC7 scene less its last batch: dp = 2 does not divide its count (C4)
    for fmt, path, budget in (("bc1", scenes[2], None),
                              ("bc7", cscenes["bc7"], cdata["bc7"].num_batches - 1)):
        for dp, sp in ((2, 1), (1, 2)):
            tasks.append(dict(name=f"{fmt} {dp}x{sp}", kind="tpc", scene=path, budget=budget,
                              dp=dp, sp=sp, width=W, height=H, lod=1.0, views=a12_views,
                              modes=["color", "hqs"]))
    # the .huffman path on the whole scene, at the orbit camera
    hscene = {k: hd[k].cpu().numpy() for k in REF_KEYS}
    r.apply_setting(Setting(**VIEWS["orbit"]))
    r.controls_update()
    npz = os.path.join(REPO, "out", "chip_smoke_a12_huffman.npz")
    np.savez(npz, **hscene, lod_n=np.full(huf.num_batches, PTS, np.int32),
             transform=(r.camera.proj() @ r.camera.view()).astype(np.float32),
             scale=np.asarray(huf.scale, np.float32),
             offset_rel=(np.asarray(huf.offset) - np.asarray(huf.las_min)).astype(np.float32))
    for dp, sp in ((2, 1), (1, 2)):
        tasks.append(dict(name=f"huffman {dp}x{sp}", kind="huffman", scene=npz, dp=dp, sp=sp,
                          width=W, height=H))
    a12 = dryrun_multichip(2, tasks, "gloo", "cuda:0", workdir=os.path.join(REPO, "out"))
    check(a12.pop("foreign_modules") == [], "a rank process loaded jax or the JAX package")
    for t in tasks:
        run = a12[t["name"]]
        spans = [(x["start"], x["stop"]) for x in run["ranks"]]
        if t["name"] == "bc7 2x1":  # dp does not divide the batches
            n_b = run["ranks"][0]["batches"]
            check(n_b % 2 == 1 and spans == [(0, n_b // 2 + 1), (n_b // 2 + 1, n_b)],
                  f"A12 {t['name']}: shards {spans} of {n_b} batches")
        for frame, img in run["images"].items():
            shown = int((img != BACKGROUND).sum())
            check(img.shape == (H, W) and shown > 0, f"A12 {t['name']} {frame}: no image")
            ms = [x["frames"][frame]["ms"] for x in run["ranks"]]
            print(f"[a12] {t['name']} {frame}: {shown:,} pixels shown, every rank's "
                  f"{H // t['sp']} rows equal to the single-process frame's; ranks' "
                  f"batches {spans}; sharded frame {', '.join(f'{x:.3f}' for x in ms)} ms "
                  f"(host clock, median of 5, each rank) [{card}]")
        if t["kind"] == "tpc":
            c = [x["collective_ms"] for x in run["ranks"]]
            mins = ", ".join(f"{x['min_u64']:.3f}" for x in c)
            sums = ", ".join(f"{x['sum_4_planes']:.3f}" for x in c)
            print(f"[a12] {t['name']}: all_reduce over gloo of a {W}x{H} plane "
                  f"({c[0]['plane_entries']:,} u64 entries, MIN) {mins} ms, of the four "
                  f"HQS sum planes (SUM, int64) {sums} ms (each rank, median of 5) [{card}]")
    print(f"[a12] two ranks on {torch.cuda.get_device_name(0)} over gloo, {len(tasks)} "
          f"tasks: {time.perf_counter() - t_a12:.1f} s with the ranks' start and loads")

    watch.lap("the sharded frames")
    # ---- 6. times: kernels at the frame's shapes (one orbit chunk; B6 at the
    # parametric frame's, B10 at 4,096 tiles of the HQS chunk) ----
    dargs, dpts = shapes["decode"]
    pargs, ppts = shapes["project"]
    stream = shapes["stream"]
    hparts, hfb = shapes["hqs"]
    n = stream[0].numel()
    hn = hparts[0][0].numel()
    sp, s3, hs, tiles = shapes["param"], shapes["key3"], shapes["hqs_sorted"], shapes["tiles"]
    fparts = shapes["frame"]
    psize = W * H
    bpay = torch.arange(CHUNK, dtype=torch.int32, device=DEVICE)  # the batch index

    def amin_rows(pid, dep, pay, plane_size):
        """The one PyTorch call that computes the u64-min planes
        (scatter_reduce amin): its index, keys and (plane_size + 1,) plane."""
        pid64 = widen(pid.reshape(-1))
        idx = torch.where(pid64 < plane_size, pid64, torch.full_like(pid64, plane_size))
        plane = torch.full((plane_size + 1,), INT64_MAX, dtype=torch.int64, device=DEVICE)
        return idx, biased_key(dep.reshape(-1), pay.reshape(-1)), plane

    idx3, keys, plane3 = amin_rows(*stream, size)
    frame_rows = {mode: amin_rows(*(torch.cat([p[k].reshape(-1) for p in fp])
                                    for k in range(3)), size)
                  for mode, fp in fparts.items()}
    idx6, keys6, plane6 = amin_rows(*sp, psize)
    idx8, keys8, plane8 = amin_rows(*s3, size)
    idx4, vals4 = hqs_rows(*hparts[0], hfb, size)
    idx9, vals9 = hqs_rows(*hs, hfb, size)
    plane4 = torch.zeros((size, 4), dtype=torch.int32, device=DEVICE)
    lparts, lcolour, lfb = las_shapes["parts"], las_shapes["colour"], las_shapes["fb"]
    idx3l, keys3l, plane3l = amin_rows(*(torch.cat([p[k].reshape(-1) for p in lparts])
                                         for k in range(3)), psize)
    idx4l, vals4l = hqs_rows(*(torch.cat([p[k].reshape(-1) for p in lcolour])
                               for k in range(3)), lfb, psize)
    plane4l = torch.zeros((psize, 4), dtype=torch.int32, device=DEVICE)
    pparts, pcolour, pfb = (potree_shapes[k] for k in ("parts", "colour", "fb"))
    idx3p, keys3p, plane3p = amin_rows(*(torch.cat([p[k].reshape(-1) for p in pparts])
                                         for k in range(3)), psize)
    idx4p, vals4p = hqs_rows(*(torch.cat([p[k].reshape(-1) for p in pcolour])
                               for k in range(3)), pfb, psize)
    plane4p = torch.zeros((psize, 4), dtype=torch.int32, device=DEVICE)
    timed = {
        "pcr_decode_fixed": (lambda: decode_fixed_batches(*dargs, points=dpts),
                             lambda: decode_fixed_plain(*dargs, points=dpts), None),
        "pcr_project": (lambda: project_batches(*pargs, points=ppts),
                        lambda: project_plain(*pargs, points=ppts), None),
        "pcr_project:hqs": (lambda: project_batches(*pargs, points=ppts, collapse=False),
                            lambda: project_plain(*pargs, points=ppts, collapse=False),
                            None),
        "pcr_project:payload": (lambda: project_batches(*pargs, points=ppts, payload=bpay),
                                lambda: project_plain(*pargs, points=ppts, payload=bpay),
                                None),
        **{f"pcr_project:{fmt}": (
            lambda fa=fmt_args[fmt], f=fmt: project_batches(*fa, points=ppts, color_fmt=f),
            lambda fa=fmt_args[fmt], f=fmt: project_plain(*fa, points=ppts, color_fmt=f),
            None) for fmt in COLOR_FMTS},
        "pcr_u64_min": (lambda: u64_min_planes([stream], size),
                        lambda: u64_min_planes_plain([stream], size),
                        lambda: plane3.scatter_reduce_(0, idx3, keys, reduce="amin")),
        **{f"pcr_u64_min:{row}": (
            lambda fp=fparts[mode]: u64_min_planes(fp, size),
            lambda fp=fparts[mode]: u64_min_planes_plain(fp, size),
            lambda r=frame_rows[mode]: r[2].scatter_reduce_(0, r[0], r[1], reduce="amin"))
           for row, mode in (("frame", "colour"), ("hqs", "hqs"))},
        "pcr_hqs_sums": (lambda: hqs_sums(hparts, hfb, size),
                         lambda: hqs_sums_plain(hparts, hfb, size),
                         lambda: plane4.index_add_(0, idx4, vals4)),
        "pcr_u64_min_flat": (lambda: u64_min_planes(lparts, psize, layout="flat"),
                             lambda: u64_min_planes_plain(lparts, psize),
                             lambda: plane3l.scatter_reduce_(0, idx3l, keys3l, reduce="amin")),
        "pcr_hqs_sums_flat": (lambda: hqs_sums(lcolour, lfb, psize, layout="flat"),
                              lambda: hqs_sums_plain(lcolour, lfb, psize),
                              lambda: plane4l.index_add_(0, idx4l, vals4l)),
        "pcr_u64_min_flat:potree": (lambda: u64_min_planes(pparts, psize, layout="flat"),
                                    lambda: u64_min_planes_plain(pparts, psize),
                                    lambda: plane3p.scatter_reduce_(0, idx3p, keys3p,
                                                                    reduce="amin")),
        "pcr_hqs_sums_flat:potree": (lambda: hqs_sums(pcolour, pfb, psize, layout="flat"),
                                     lambda: hqs_sums_plain(pcolour, pfb, psize),
                                     lambda: plane4p.index_add_(0, idx4p, vals4p)),
        "pcr_decode_native": (lambda: decode_native_batches(*native_in, points=64),
                              lambda: decode_native_plain(*native_in, points=64), None),
        "pcr_merge_nk1": (lambda: dense_from_sorted_nk1(*sp, psize),
                          lambda: u64_min_planes_plain([sp], psize),
                          lambda: plane6.scatter_reduce_(0, idx6, keys6, reduce="amin")),
        "pcr_merge_heads": (lambda: dense_from_sorted(*s3, size),
                            lambda: dense_from_sorted_plain(*s3, size),
                            lambda: plane8.scatter_reduce_(0, idx8, keys8, reduce="amin")),
        "pcr_hqs_sorted": (lambda: hqs_sums_from_sorted(*hs, hfb, size),
                           lambda: hqs_sums_plain([hs], hfb, size),
                           lambda: plane4.index_add_(0, idx9, vals9)),
        "pcr_tile_sort3": (lambda: tile_sort3(*tiles), lambda: tile_sort3_plain(*tiles),
                           None),  # a per-tile 3-key sort is no one PyTorch call
        "pcr_decode_huffman": (lambda: decode_ref_batches(*huf_in, points=dpts),
                               lambda: decode_ref_plain(*huf_in, points=dpts), None),
    }
    # least bytes each function must move (inputs read once, outputs
    # written once), at the timed shapes; the decoders read each batch's
    # own stream words, not the padding of the device rows
    coords_b = nbytes(pargs[0])
    fixed_tables = [x for i, x in enumerate(dargs) if i != 1]  # all but streams
    native_tables = [x for i, x in enumerate(native_in) if i != 1]
    bound_bytes = {
        "pcr_decode_fixed": (nbytes(*fixed_tables) + stream_bytes[2]
                             + CHUNK * dpts * 3 * 1024 * 4),
        "pcr_project": nbytes(*pargs[:6]) + coords_b,  # 3 u32 outputs per entry
        "pcr_project:hqs": nbytes(*pargs[:6]) + coords_b,
        "pcr_project:payload": nbytes(pargs[0], *pargs[2:6], bpay) + coords_b,  # no colours
        # raw: the rows of the decoded points only
        **{f"pcr_project:{fmt}": (nbytes(fa[0], *fa[2:6]) + coords_b
                                  + nbytes(fa[1][:, :ppts] if fmt == "raw" else fa[1]))
           for fmt, fa in fmt_args.items()},
        "pcr_u64_min": nbytes(*stream) + 8 * size,
        "pcr_u64_min:frame": sum(nbytes(*p) for p in fparts["colour"]) + 8 * size,
        "pcr_u64_min:hqs": sum(nbytes(*p) for p in fparts["hqs"]) + 8 * size,
        "pcr_hqs_sums": nbytes(*hparts[0], hfb) + 16 * size,
        "pcr_u64_min_flat": sum(nbytes(*p) for p in lparts) + 8 * psize,
        "pcr_hqs_sums_flat": sum(nbytes(*p) for p in lcolour) + nbytes(lfb) + 16 * psize,
        "pcr_u64_min_flat:potree": sum(nbytes(*p) for p in pparts) + 8 * psize,
        "pcr_hqs_sums_flat:potree": (sum(nbytes(*p) for p in pcolour) + nbytes(pfb)
                                     + 16 * psize),
        "pcr_decode_native": (nbytes(*native_tables) + stream_bytes[1]
                              + CHUNK * 64 * 3 * 1024 * 4),
        "pcr_merge_nk1": nbytes(*sp) + 8 * psize,
        "pcr_merge_heads": nbytes(*s3) + 8 * size,
        "pcr_hqs_sorted": nbytes(*hs, hfb) + 16 * size,
        "pcr_tile_sort3": 2 * nbytes(*tiles),  # each key read once, written once
        # the chunk's rows, its own stream words and escapes, the coordinates
        "pcr_decode_huffman": (nbytes(*(x for k, x in zip(REF_KEYS, huf_in)
                                                if k not in WHOLE_BUFFERS))
                               + 4 * int(hd["cluster_sizes"][sl, -1].sum())
                               + 4 * int(hd["separate_sizes"][sl, -1].sum())
                               + CHUNK * dpts * 3 * 1024 * 4),
    }
    timed_at = {  # what each kernel is timed on
        "pcr_merge_nk1": f"the parametric near frame's pid-sorted stream, "
                         f"{sp[0].numel():,} entries into {psize:,} pixels",
        "pcr_merge_heads": f"one orbit chunk sorted by 3 keys, {n:,} entries",
        "pcr_hqs_sorted": f"one orbit HQS chunk sorted by pid, {hn:,} entries",
        "pcr_tile_sort3": f"{tiles[0].shape[0]:,} tiles of the orbit HQS chunk",
        "pcr_hqs_sums": f"one orbit HQS chunk, {hn:,} entries",
        "pcr_u64_min_flat": f"the loop_las orbit frame's {len(lparts)} part(s), "
                            f"{sum(p[0].numel() for p in lparts):,} entries into {psize:,} "
                            f"pixels",
        "pcr_hqs_sums_flat": f"the loop_las_hqs orbit frame's {len(lcolour)} part(s), "
                             f"{sum(p[0].numel() for p in lcolour):,} entries",
        "pcr_u64_min_flat:potree": f"the loop_nodes steady frame's {len(pparts)} part(s), "
                                   f"{sum(p[0].numel() for p in pparts):,} entries into "
                                   f"{psize:,} pixels",
        "pcr_hqs_sums_flat:potree": f"the loop_nodes_hqs steady frame's {len(pcolour)} "
                                    f"part(s), {sum(p[0].numel() for p in pcolour):,} entries",
        "pcr_decode_huffman": f"the .huffman scene's first {CHUNK} batches at points "
                              f"{dpts}",
        "pcr_project:hqs": f"one orbit chunk in HQS mode, {n:,} entries",
        "pcr_project:payload": f"one orbit chunk in batch-payload mode (the batch index), "
                               f"{n:,} entries",
        **{f"pcr_project:{fmt}": f"the {fmt} scene's orbit chunk in {fmt} mode, {n:,} entries"
           for fmt in COLOR_FMTS},
        **{f"pcr_u64_min:{row}": f"the orbit frame's {len(fparts[mode])} {mode} parts, "
                                 f"{sum(p[0].numel() for p in fparts[mode]):,} entries"
           for row, mode in (("frame", "colour"), ("hqs", "hqs"))},
    }

    def b3_alone(parts):
        return lambda: [U64_MIN.launch(*g, plane_alone.data_ptr(), size)
                        for g in build.part_groups(parts)]

    # one launch of the kernel alone into a plane filled outside the events
    plane_alone = torch.empty((max(size, psize),), dtype=torch.int64, device=DEVICE)
    alone = {
        "pcr_u64_min": b3_alone([stream]),
        "pcr_u64_min:frame": b3_alone(fparts["colour"]),
        "pcr_u64_min:hqs": b3_alone(fparts["hqs"]),
        "pcr_u64_min_flat": lambda: [U64_MIN_FLAT.launch(*g, plane_alone.data_ptr(), psize)
                                     for g in build.part_groups(lparts)],
        "pcr_u64_min_flat:potree": lambda: [U64_MIN_FLAT.launch(*g, plane_alone.data_ptr(),
                                                                psize)
                                            for g in build.part_groups(pparts)],
        "pcr_merge_nk1": lambda: MERGE_NK1.launch(
            sp[0].data_ptr(), sp[1].data_ptr(), sp[2].data_ptr(), plane_alone.data_ptr(),
            sp[0].numel(), psize),
    }
    # the kernel alone reads its parts and writes only the plane words its
    # live entries land in: the plane is filled outside its events
    alone_bound = {s: (sum(nbytes(*p) for p in parts)
                       + 8 * landed(torch.cat([p[0].reshape(-1) for p in parts]), plane_size))
                   / HBM_BYTES_PER_S * 1e3
                   for s, (parts, plane_size) in (
                       ("pcr_u64_min", ([stream], size)),
                       ("pcr_u64_min:frame", (fparts["colour"], size)),
                       ("pcr_u64_min:hqs", (fparts["hqs"], size)),
                       ("pcr_u64_min_flat", (lparts, psize)),
                       ("pcr_u64_min_flat:potree", (pparts, psize)),
                       ("pcr_merge_nk1", ([sp], psize)))}
    assert set(alone_bound) == set(alone)
    # f32 work of B2's projection: 3 scale, 3 x (3 mul + 3 add), 1 div,
    # 2 ndc mul, 2 x (mul, add, mul) pixel maps per entry
    bound_ops = {s: 32 * n for s in ("pcr_project", "pcr_project:hqs", "pcr_project:payload",
                                     *(f"pcr_project:{fmt}" for fmt in COLOR_FMTS))}
    # a model of the L2 sectors of the flat rows' random accesses, from the
    # inputs (no counter is read): a 32 B sector for each landing entry's
    # plane word (B3) or depth word (B4), and for each accepted entry's
    # 16 B row of sums (B4's four atomics, one request)
    landing = {"las": int((idx3l < psize).sum()), "potree": int((idx3p < psize).sum())}
    accepted = {"las": idx4l.numel(), "potree": idx4p.numel()}
    l2_model = {"pcr_u64_min_flat": 32 * landing["las"],
                "pcr_u64_min_flat:potree": 32 * landing["potree"],
                "pcr_hqs_sums_flat": 32 * (landing["las"] + accepted["las"]),
                "pcr_hqs_sums_flat:potree": 32 * (landing["potree"] + accepted["potree"])}
    device_of = {}
    kernels = []
    for s, (kern, plain, library) in timed.items():
        k_ms = time_ms(kern, KERNEL_REPS)
        k_dev = time_ms(kern, KERNEL_REPS, spin=True)
        p_ms = time_ms(plain, PLAIN_REPS)
        lib_ms = time_ms(library, KERNEL_REPS) if library else None
        lib_dev = time_ms(library, KERNEL_REPS, spin=True) if library else None
        k_alone = (time_ms(alone[s], KERNEL_REPS, spin=True,
                           setup=lambda: plane_alone.fill_(-1)) if s in alone else None)
        t_bytes = bound_bytes[s] / HBM_BYTES_PER_S * 1e3
        t_ops = bound_ops.get(s, 0) / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
        owner = OWNER[s]
        sym = s.split(":")[0]  # the row's C symbol
        kernels.append(dict(
            name=KERNEL_INFO[s][0], route="cuda", source=KERNEL_INFO[s][1],
            replaces=KERNEL_INFO[s][2],
            launches=results[owner]["launches"][sym] if owner else 0,
            max_abs_err=max(errs[sym], errs[s]), ms=round(k_ms, 4), device_ms=round(k_dev, 4),
            kernel_device_ms=None if k_alone is None else round(k_alone, 4),
            plain_ms=round(p_ms, 4), bound_ms=round(bound_ms, 4), bound_by=bound_by,
            kernel_bound_ms=round(alone_bound[s], 4) if s in alone_bound else None,
            library_ms=None if lib_ms is None else round(lib_ms, 4)))
        device_of[s] = k_dev
        at = timed_at.get(s, f"one orbit chunk, {n:,} entries")
        reach = (f"{results[owner]['launches'][sym]} launches in {owner[0]} {owner[1]}"
                 if owner else "reached by no method of the reference: 0 launches")
        lib = "-" if lib_ms is None else f"{lib_ms:.4f} ms (device {lib_dev:.4f})"
        kern_alone = ("" if k_alone is None else
                      f", kernel alone {k_alone:.4f}, its bound {alone_bound[s]:.4f} with the "
                      f"landed words alone")
        print(f"[time] {KERNEL_INFO[s][0]}: kernel {k_ms:.4f} ms (device {k_dev:.4f}"
              f"{kern_alone}) vs "
              f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{bound_bytes[s]:,} B), library {lib} ({at}); {reach} [{card}]")
        if s in l2_model:
            print(f"[l2 model] {KERNEL_INFO[s][0]}: {l2_model[s]:,} B of 32 B L2 sectors in "
                  f"random accesses, modelled from the inputs (not measured); DRAM bound "
                  f"{t_bytes:.4f} ms ({bound_bytes[s]:,} B at {HBM_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s) [{card}]")
    # the chain layout's kernels, which the `.tpc` and `.huffman` frames
    # launch (and the `.las` and Potree frames did before the flat one), on
    # the same flat parts
    for s, fn in (("pcr_u64_min_flat", lambda: u64_min_planes(lparts, psize)),
                  ("pcr_hqs_sums_flat", lambda: hqs_sums(lcolour, lfb, psize)),
                  ("pcr_u64_min_flat:potree", lambda: u64_min_planes(pparts, psize)),
                  ("pcr_hqs_sums_flat:potree", lambda: hqs_sums(pcolour, pfb, psize))):
        chain_ms = time_ms(fn, KERNEL_REPS, spin=True)
        print(f"[time] {KERNEL_INFO[s][0]}: the chain layout's kernel on the same parts "
              f"{chain_ms:.4f} ms device, the flat layout's {device_of[s]:.4f} "
              f"({chain_ms / device_of[s]:.2f}x) [{card}]")
    # and the flat layout's kernels on the chain rows' parts: held to the
    # chain kernels' planes (sums and minima do not depend on order), timed
    for s, chain, flat in (
            ("pcr_u64_min", lambda: u64_min_planes([stream], size),
             lambda: u64_min_planes([stream], size, layout="flat")),
            *((f"pcr_u64_min:{row}", lambda fp=fparts[mode]: u64_min_planes(fp, size),
               lambda fp=fparts[mode]: u64_min_planes(fp, size, layout="flat"))
              for row, mode in (("frame", "colour"), ("hqs", "hqs"))),
            ("pcr_hqs_sums", lambda: hqs_sums(hparts, hfb, size),
             lambda: hqs_sums(hparts, hfb, size, layout="flat"))):
        e = max(max_abs_err(g, w) for g, w in zip(flat(), chain()))
        check(e == 0, f"{s}: the flat layout's kernel on the chain parts != the chain "
                      f"kernel's (max err {e})")
        flat_ms = time_ms(flat, KERNEL_REPS, spin=True)
        print(f"[time] {KERNEL_INFO[s][0]}: the flat layout's kernel on the same chain parts "
              f"{flat_ms:.4f} ms device, bit-exact; the chain layout's {device_of[s]:.4f} "
              f"({flat_ms / device_of[s]:.2f}x) [{card}]")
    if args.flat_variants:
        from pcrhpg24_tpu_torch.tools import flat_variants

        for label, shapes_of in (("loop_las orbit", (lparts, lcolour, lfb)),
                                 ("Potree steady", (pparts, pcolour, pfb))):
            flat_variants.run(label, *shapes_of, psize,
                              lambda fn, **kw: time_ms(fn, KERNEL_REPS, **kw), card)
    watch.lap("kernel times")
    # ---- 6b. probes: the card counterparts of the TPU probes of B3 ----
    probe_lib, probe_s, probe_log = probe_build.result()
    probe_pool.shutdown()
    print(f"[build] probes: {os.path.relpath(probe_lib, REPO)} from the sources of "
          f"pcrhpg24_tpu_torch/experiments/ for sm_90a: {probe_s:.2f} s (while the scenes "
          f"were written)")
    print_ptxas(probe_log)
    hm = HuffmanTpu(r, data[2])
    chunks = {}
    for view in ("orbit", "closeup", "oblique", "corner"):
        vparts, _size, _dev = frame_streams(**view_args(hm, r, TPC_VIEWS[view], 1.0))
        chunks[view] = (probes.busiest(vparts, size), size)
    potree_n = sum(p[0].numel() for p in pparts)
    targets = [("orbit chunk", [stream], size),
               (f"orbit frame's {len(fparts['colour'])} colour parts", fparts["colour"], size),
               (".las orbit part", lparts, psize),
               (f"Potree {potree_n / 1e6:.1f}M steady parts", pparts, psize)]
    kernels += probe_phase(targets, chunks, (sum(p[0].numel() for p in lparts), potree_n),
                           card)
    # the decoders' and B2's probes on the busiest orbit chunk of each .tpc
    orbit = {}
    for v in (1, 2):
        hv = HuffmanTpu(r, data[v])
        a = view_args(hv, r, TPC_VIEWS["orbit"], 1.0)
        sl = probes.busiest_chunk(a)
        orbit[v] = (f"v{v} orbit chunk {sl.start // CHUNK}", probes.chunk_args(a, sl))
    kernels += decoder_probe_phase(orbit[1], orbit[2], card, probe_log)
    # B10's exchange probe and the rest of B3's, on the same targets
    kernels += merge_probe_phase(targets, card, probe_log, device_of["pcr_tile_sort3"])
    # r3_matscatter's two sites and B6's six, on the streams B6 resolves
    # (parametric, `.wg`) and on the `.las` and Potree parts as one stream
    streams = [("parametric near", shapes["param raw"], psize),
               (".wg orbit", shapes["wg"], psize),
               (".las orbit part", tuple(torch.cat([p[k].reshape(-1) for p in lparts])
                                         for k in range(3)), psize),
               (f"Potree {potree_n / 1e6:.1f}M steady parts, end to end",
                tuple(torch.cat([p[k].reshape(-1) for p in pparts]) for k in range(3)), psize)]
    kernels += b6_probe_phase(streams, card, probe_log, device_of["pcr_merge_nk1"])
    del hm, hv, chunks, targets, orbit, streams
    watch.lap("probes")
    # B12's resources, and its chunk's blocks spread evenly over the SMs
    res = kernel_resources()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = CHUNK * res["blocks_per_batch"]
    per_sm, more = divmod(blocks, sms)
    check(blocks <= sms * res["blocks_per_sm"],
          f"pcr_decode_huffman: {blocks} blocks a chunk exceed what {sms} SMs hold at once")
    print(f"[b12] resources, {res['threads'] // 32}-warp blocks: {res['registers']} registers "
          f"a thread, {res['shared_bytes']:,} B shared memory a block, up to "
          f"{res['blocks_per_sm']} blocks ({res['blocks_per_sm'] * res['threads'] // 32} "
          f"warps) resident per SM; {blocks} blocks per {CHUNK}-batch chunk on {sms} SMs: "
          f"{more} SMs hold {per_sm + 1} blocks, {sms - more} hold {per_sm}")
    # the streams B12 decodes (the scene's data, no device time): words
    # per warp stream, escapes per lane and per warp run, and the runs
    # that, with the 3 x points escapes a lane may read past its own,
    # overflow the staged run (those warps take the checked steps)
    def per_unit(inclusive):
        x = inclusive.to(torch.int64)
        return torch.diff(x, dim=1, prepend=torch.zeros_like(x[:, :1]))
    words = per_unit(hd["cluster_sizes"][sl])
    lane_esc = per_unit(hd["separate_sizes"][sl])
    run = lane_esc.reshape(-1, 32, 32).sum(2)
    syms = lane_esc.numel() * 3 * PTS
    print(f"[b12] streams of the .huffman scene's first {CHUNK} batches: "
          f"{words.sum(1).float().mean().item():,.0f} words a batch, "
          f"{words.min().item():,}-{words.max().item():,} a warp stream (the format's "
          f"most: 2,368), {(words.sum() / (32 * words.numel())).item() - 2:.1f} refills a "
          f"lane on average; escapes {lane_esc.sum().item():,} "
          f"({100 * lane_esc.sum().item() / syms:.1f}% of {syms:,} symbols), "
          f"{lane_esc.float().mean().item():.1f} a lane on average, at most "
          f"{lane_esc.max().item()}; a warp's run {run.float().mean().item():,.0f} on "
          f"average, at most {run.max().item():,}; {int((run + 3 * PTS + 3 > res['escape_cap']).sum())} "
          f"of {run.numel():,} runs over the {res['escape_cap']:,}-int staging cap")
    # B4's planes as strided views of its (size, 4) sums (the wrapper's
    # choice) against a contiguous split, each through the consumer's
    # unswizzle, as `hqs_frame_native` reads them (device time)
    split_ms = {
        how: time_ms(lambda f=f: [unswizzle_plane(f(a), W, H)
                                  for a in hqs_sums(hparts, hfb, size)], KERNEL_REPS,
                     spin=True)
        for how, f in (("views", lambda a: a), ("split", lambda a: a.contiguous()))}
    print(f"[time] B4 + unswizzle of its four planes (device): strided views "
          f"{split_ms['views']:.4f} ms, contiguous split {split_ms['split']:.4f} ms "
          f"(one orbit HQS chunk) [{card}]")
    # B3's planes as strided views of its u64 plane (the wrapper's choice)
    # against a contiguous split, through each frame's consumers: the
    # colour frame unswizzles the payload; HQS hands B4 a contiguous depth
    # plane and unswizzles it
    consumers = {"colour": lambda pl: unswizzle_plane(pl[1], W, H),
                 "hqs": lambda pl: unswizzle_plane(pl[0].contiguous(), W, H)}
    for mode, use in consumers.items():
        split_ms = {
            how: time_ms(lambda f=f: use([f(x) for x in u64_min_planes(fparts[mode], size)]),
                         KERNEL_REPS, spin=True)
            for how, f in (("views", lambda x: x), ("split", lambda x: x.contiguous()))}
        print(f"[time] B3 + its {mode} consumer (device): strided views "
              f"{split_ms['views']:.4f} ms, contiguous split {split_ms['split']:.4f} ms "
              f"(the orbit frame's {len(fparts[mode])} parts) [{card}]")
    for (label, name), res in results.items():
        if "output" in res:  # the [cost] lines below
            continue
        what = res.get("what") or {"parametric": "generated points",
                                   "wg": "points"}.get(label, "visible points")
        print(f"[time] {label} {name}: device frame {res['frame_ms']:.3f} ms median of "
              f"{res['frames']} (CUDA events), {res['visible']:,} {what}, "
              f"{res['visible'] / res['frame_ms'] / 1e6:.3f} Gpoints/s "
              f"@{W}x{H}, {res.get('scene', f'{args.batches} batches')} [{card}]")
    # what the depth plane, EDL and the boxes add to a frame: the
    # event-timed frames of the output phase against the path's colour
    # frame, and the device time of each added step alone at the orbit
    # frame's shapes
    for (label, name), res in results.items():
        if "output" not in res:
            continue
        base = label.rsplit(" ", 1)[0]
        b = results[(base, name)]["frame_ms"]
        print(f"[cost] {label} {name}: device frame {res['frame_ms']:.3f} ms median of "
              f"{res['frames']} (CUDA events), {res['frame_ms'] - b:+.3f} ms vs the "
              f"colour frame's {b:.3f} @{W}x{H}, {args.batches} batches [{card}]")
    fb_dep = u64_min_planes(fparts["colour"], size)[0]
    lin_d = unswizzle_plane(fb_dep, W, H)
    orbit_img = colour_v2["orbit"].to(DEVICE)
    B = data[2].num_batches_loaded
    box_lo, box_hi = (torch.from_numpy(x[:B]).to(DEVICE) for x in (data[2].bbox_min,
                                                                  data[2].bbox_max))
    r.apply_setting(Setting(**VIEWS["orbit"]))
    r.controls_update()
    wvp = torch.from_numpy((r.camera.proj() @ r.camera.view()).astype(np.float32)).to(DEVICE)
    for what, fn in (("the depth half's unswizzle (need_depth)",
                      lambda: unswizzle_plane(fb_dep, W, H)),
                     ("EDL (edl_shade, its exp XLA-CPU's polynomial in f64 FMAs)",
                      lambda: edl_shade(orbit_img, lin_d, W, H)),
                     ("EDL with torch.exp in place of xla_exp (not bit-exact)",
                      lambda: edl_shade(orbit_img, lin_d, W, H)),
                     (f"the overlay of {B} boxes (draw_bounding_boxes)",
                      lambda: draw_bounding_boxes(orbit_img, box_lo, box_hi, wvp, W, H))):
        if "torch.exp" in what:  # what the bit-exact exp costs, in the same run
            raster.xla_exp, xla_exp = torch.exp, raster.xla_exp
        ms = statistics.median([device_ms(fn) for _ in range(KERNEL_REPS)])
        if "torch.exp" in what:
            raster.xla_exp = xla_exp
        print(f"[cost] {what}: {ms:.4f} ms device (utils/devtime, median of {KERNEL_REPS} "
              f"calls, each behind a spin; orbit, {W}x{H}) [{card}]")
    watch.lap("times")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)  # as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
