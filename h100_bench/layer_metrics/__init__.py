"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``, named as the metric is.  Each file's ``read(ctx)`` takes the
traced run's ``harness.TracedRun`` and returns the value, or None when the
run held nothing for it to read (the harness then leaves the metric out)."""
