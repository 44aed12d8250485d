"""Synthetic I/O traces calibrated to the paper's Table 2/3."""
from repro_torch.traces.generator import (
    MIXES,
    WORKLOADS,
    WorkloadStats,
    default_n_requests,
    gen_trace,
    to_pages,
    trace_for,
)

__all__ = ["MIXES", "WORKLOADS", "WorkloadStats", "default_n_requests",
           "gen_trace", "to_pages", "trace_for"]
