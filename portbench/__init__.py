"""The serving benchmark of `repro_torch` on one H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix, cell
limit or per-layer metric is a file of its own, found by its name
(`spec.py`): `configs/<config>.json`, `traffic/<mix>.json`,
`limits/<cell>.json`, `metrics/<metric>.py`, and a configuration's model
side `families/<harness_family>.py`. Nothing here imports JAX or the JAX
package `repro`; `reference/` and `families/` import nothing of
`repro_torch`.
"""
