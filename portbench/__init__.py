"""The benchmark of the PyTorch and CUDA package (``videollm_online_tpu_torch``).

One command runs one cell once: ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``, from the root of a
checkout that holds ``BENCHMARK.json``. Everything that belongs to one
configuration, model family, traffic mix, driver or per-layer metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives it or, for
a family, by the configuration's ``architectures`` (``registry.py``).

A model family (``families/<family>.py``) holds all that the benchmark
knows of one kind of decoder: the port's config, the weight tree, the
operations and kernel calls of a forward, the port function the meter
wraps, its kernel classes and its plain reference (``reference/``).
Shared modules (``registry``, ``run``, ``weights``, ``roofline``,
``trace``, ``traffic``, ``drivers/``, ``metrics/``,
``reference/dialogue.py``) ask the family and read no decoder-shape key.
A new architecture is added as files: a family, its reference, and a
roofline metric for each kernel class of its own; ``registry.py`` lists
what a family provides.

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
