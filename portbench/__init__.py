"""The benchmark of the PyTorch and CUDA package (``videollm_online_tpu_torch``).

One command runs one cell once: ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``, from the root of a
checkout that holds ``BENCHMARK.json``. Everything that belongs to one
configuration, traffic mix, driver or per-layer metric is a file of its
own, found by the name that ``BENCHMARK.json`` gives it (``registry.py``).
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
