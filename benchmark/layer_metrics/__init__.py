"""Per-layer metric readers, one file per metric named as in BENCHMARK.json (loaded by path)."""
