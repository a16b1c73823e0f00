"""Frozen work counts of the benchmark (operations and bytes a kernel needs)."""
