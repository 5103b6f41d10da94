"""Benchmarks of the port that run with ``python -m``: twins of the
repository's ``benchmarks/`` scripts, on one NVIDIA GPU."""
