"""Per-layer metric readers, one module per metric family.

A metric ``<family>`` or ``<family>.<suffix>`` of ``BENCHMARK.json`` is
read by ``metrics/<family>.py``'s ``read(ctx, suffix)``, which returns a
number or None (nothing to read: the metric is left out of the line).
Modules whose name starts with ``_`` are shared helpers.
"""
