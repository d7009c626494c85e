"""Card counterparts of the TPU probes of `experiments/` (ROADMAP queue B).

Each module here is named by the stem of the TPU probe it answers for the
card, and measures the port's kernel that the TPU probe's question is
about.  B3's: `exp_pallas_scatter_probe` (what a random atomicMin costs),
`r3_mat_lesion` (which stage of B3 takes the time), `r4_floor` (what one
chain tile costs), `r4_winsize` (other tile widths), `r3_corient` (the
chain tile read into registers), `r3_flushacc` (a warp's same-pixel keys
combined before the atomicMin), `r3_i8dot` and `r3_p4dot` (narrower keys)
and `r4_pwin` (tiles cut at fixed positions).  The decoders' and B2's:
`exp_pallas_variants` and `exp_variant_slope` (B5), `r3_decode_ilp` (B1),
`exp_gather` (B12's table) and `r3_div_parity` (B2's f32 forms).  B10's:
`exp_mxu_perm` (a partner exchange by shuffles or shared memory).  B6's,
and the sort in front of it: `r3_matscatter` (run heads stored after a
full-key sort, against B6 after a pid sort and B3 on the unsorted
stream), `r2_merge_tune` (B6's stages cut out), `r3_kernel_floor` (its
cost built up, interleaved loads), `r3_build_v2` (its scan depth),
`r3_merge_micro` (groups a warp, `cp.async` rings), `r3_merge_micro2`
(instruction cuts) and `r3_rows_prefix` (what to sort).  Their
kernels are CUDA C++ beside them (`probes.py` builds them), and each
module's `main` runs it on a card:

    python -m pcrhpg24_tpu_torch.experiments.<stem>

as the TPU probe runs with `python experiments/<stem>.py`.  Importing a
module does no work; `chip_smoke.py` runs them all in its `probes` phase.
"""
