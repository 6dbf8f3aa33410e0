"""The general part of the benchmark: it finds a cell's configuration,
traffic, limits, op, reference, work count and metric readers by the names
in BENCHMARK.json, and needs no edit for a new cell."""
