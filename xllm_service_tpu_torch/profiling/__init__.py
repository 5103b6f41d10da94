"""Continuous profiling of the engine's process: the wall-clock sampling
profiler behind ``/admin/profile`` (``sampler.py``) and the span-tree
critical-path split behind ``/admin/trace`` (``critical_path.py``)."""

from .critical_path import (CRITICAL_STAGES, aggregate_critical_paths,
                            critical_path)
from .sampler import (PROFILER, THREAD_ROLES, SamplingProfiler,
                      admin_profile, parse_folded, summarize_stacks)

__all__ = [
    "CRITICAL_STAGES",
    "PROFILER",
    "SamplingProfiler",
    "THREAD_ROLES",
    "admin_profile",
    "aggregate_critical_paths",
    "critical_path",
    "parse_folded",
    "summarize_stacks",
]
