"""Frozen scene generators of the benchmark, found by the name a configuration gives."""
