"""The port's benchmark: public facade calls of ahocorasick_tpu_torch on
host bytes, driven by the cells named in BENCHMARK.json.

Run one cell from the repository root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Nothing here imports JAX or the JAX package ``ahocorasick_tpu``; the plain
reference (reference.py) imports nothing of the port either.
"""
