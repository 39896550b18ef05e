"""spbench: the benchmark of ``sparsetpu_torch`` on one H100.

``python -m spbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; ``python -m spbench.control`` reads the
program's and the control's numbers for the limits of ``correct``.  The
benchmark imports neither JAX nor the JAX package ``sparsetpu``; of the
program it takes only the system under test.
"""
