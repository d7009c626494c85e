"""The benchmark of `pcrhpg24_tpu_torch`: 1080p frames of seeded terrain
scenes, rendered in a closed loop on one card and checked against a plain
reference.

Run from the root of a checkout:

    python -m benchmark.run --workload tpc_v2.orbit --seed 7 --seconds 20 --trace 0

`BENCHMARK.json` names the cells; each cell's configuration
(`configs/<name>.json`), traffic mix (`traffic/<name>.json`) and metric
readers (`metrics/<name>.py`) are found by name, so a new cell or metric
is new files and entries only.  Nothing here imports `jax` or
`pcrhpg24_tpu`; `reference/` imports nothing of `pcrhpg24_tpu_torch`
either.
"""
