"""The benchmark of ``pesr_torch`` on one NVIDIA H100.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``run.py``).
Everything that judges the program lives here: the traffic generator,
the plain references and the comparison that decides ``correct``, the
operation and byte counts, and the readers of the per-layer metrics.
Nothing here imports JAX or ``pesr_tpu``; ``reference/`` and
``traffic/`` import nothing of ``pesr_torch`` either.
"""
