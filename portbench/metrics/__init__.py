"""The per-layer metrics' readers, one a metric, found by its name: each
module's `read(ctx)` returns the metric's value from a traced run's
`bench.Context`, or None where the run holds nothing to read."""
