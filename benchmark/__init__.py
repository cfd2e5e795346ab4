"""The benchmark of keras_rs_tpu_torch: one cell of BENCHMARK.json per run.

`python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` builds the cell's configuration (`configs/<name>.json`)
under its traffic mix (`traffic/<name>.json`), times the port's training
step, reads the per-layer metrics through `metrics/<name>.py`, checks the
first steps against the plain reference (`reference.py`) and prints one
JSON line. See README.md.
"""
