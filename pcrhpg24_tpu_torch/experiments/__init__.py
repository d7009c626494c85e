"""Card counterparts of the TPU probes of `experiments/` (ROADMAP queue D).

Each module here is named by the stem of the TPU probe it answers for the
card, and measures the port's kernel that the TPU probe's question is
about: `exp_pallas_scatter_probe` (what a random atomicMin costs),
`r3_mat_lesion` (which stage of B3 takes the time), `r4_floor` (what one
chain tile of B3 costs) and `r4_winsize` (B3 at other tile widths).
Their kernels are CUDA C++ beside them (`probes.py` builds them), and
each module's `main` runs it on a card:

    python -m pcrhpg24_tpu_torch.experiments.<stem>

as the TPU probe runs with `python experiments/<stem>.py`.  Importing a
module does no work; `chip_smoke.py` runs all four in its `probes` phase.
"""
