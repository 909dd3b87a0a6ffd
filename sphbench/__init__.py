"""The benchmark of `tpusph_torch`, the PyTorch and CUDA port of tpusph.

One command runs one cell of `BENCHMARK.json` once and prints one JSON
line last:

    python3 -m sphbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric, stage
or cell is a file of its own, found by name (`registry.py`, README.md).
Nothing here imports JAX or the JAX package; the plain reference under
`reference/` imports nothing of the port either.
"""
