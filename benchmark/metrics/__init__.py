"""Per-layer metrics, one module each, named as in ``BENCHMARK.json``. Each has
``read(ctx) -> float | None`` (`benchmark.harness.Context`); None where the run holds
nothing to read, and the harness then leaves the metric out of the line."""
